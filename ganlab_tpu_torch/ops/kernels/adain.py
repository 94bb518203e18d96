"""AdaIN: instance norm over H x W, then ``s * x_hat + b``: Triton + plain.

Replaces ``ganlab_tpu/ops/pallas/adain.py::adain_pallas`` (``_impl`` /
``_kernel``): per (n, c) plane, mean and biased variance (the two-pass
formula, float32), ``r = rsqrt(var + eps)``, ``y = (x - mean) * r * s + b``,
output in x's dtype. The JAX package runs its kernel only where a
per-image tile fits VMEM; this one takes every shape the synthesis network
makes, planes of 4x4 up to 256x256.

Bound: memory. The function needs one read and one write of x (plus the
(N, C) styles), a handful of flops per element, so the least time is those
bytes over 3.35 TB/s.

Design: x is NCHW-contiguous, so each (n, c) plane is one contiguous run
of H*W elements. One program per plane loops over it in BLOCK-sized
chunks three times: sum (mean), sum of squared deviations (variance), and
the normalize-and-modulate write. The second and third reads of a plane
mostly hit L2 (a plane is at most 256 KiB in float32), so device memory
sees about one read and one write. Fusing the preceding noise + bias +
LeakyReLU epilogue is left to a later PR.

``AdaIN`` is the autograd Function: forward is the kernel (CUDA) or the
plain version (CPU); backward is the analytic VJP of the JAX package's
``adain.py::_bwd`` in plain PyTorch (that package has no backward kernel).
"""

from __future__ import annotations

import functools

import torch

from ganlab_tpu_torch.ops.kernels import check_input

tl = None  # triton.language; bound by _kernel() (no triton on CPU hosts)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _adain_kernel(x_ptr, s_ptr, b_ptr, o_ptr, HW, eps,
                  BLOCK: tl.constexpr):
    p = tl.program_id(0)
    base = p.to(tl.int64) * HW
    lane = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, HW, BLOCK):
        offs = start + lane
        acc += tl.load(x_ptr + base + offs, mask=offs < HW,
                       other=0.0).to(tl.float32)
    mean = tl.sum(acc, axis=0) / HW
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, HW, BLOCK):
        offs = start + lane
        m = offs < HW
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        d = tl.where(m, x - mean, 0.0)
        acc += d * d
    r = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / HW + eps)
    s = tl.load(s_ptr + p).to(tl.float32)
    b = tl.load(b_ptr + p).to(tl.float32)
    for start in range(0, HW, BLOCK):
        offs = start + lane
        m = offs < HW
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        y = (x - mean) * r * s + b
        tl.store(o_ptr + base + offs, y.to(o_ptr.dtype.element_ty), mask=m)


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_adain_kernel)


def adain_ref(x: torch.Tensor, style_scale: torch.Tensor,
              style_bias: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Plain version. x (N, C, H, W); styles (N, C); float32 math
    (float64 for float64 input)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * style_scale.to(dt)[:, :, None, None] \
        + style_bias.to(dt)[:, :, None, None]
    return y.to(x.dtype)


def adain_bwd(x: torch.Tensor, style_scale: torch.Tensor, g: torch.Tensor,
              eps: float = 1e-8):
    """VJP of adain at (x, style_scale) for cotangent g: (dx, ds, db)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(dt), g.to(dt)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    r = torch.rsqrt(var + eps)
    xh = (xf - mean) * r
    dxh = gf * style_scale.to(dt)[:, :, None, None]
    dx = r * (dxh - dxh.mean(dim=(2, 3), keepdim=True)
              - xh * (dxh * xh).mean(dim=(2, 3), keepdim=True))
    ds = (gf * xh).sum(dim=(2, 3))
    db = gf.sum(dim=(2, 3))
    return (dx.to(x.dtype), ds.to(style_scale.dtype),
            db.to(style_scale.dtype))


def adain_triton(x: torch.Tensor, style_scale: torch.Tensor,
                 style_bias: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) and styles (N, C), all CUDA."""
    check_input("adain", x, dtypes=_DTYPES, ndim=4)
    n, c, h, w = x.shape
    for name, t in (("style_scale", style_scale), ("style_bias", style_bias)):
        check_input(f"adain {name}", t, dtypes=_DTYPES, ndim=2)
        if t.shape != (n, c) or t.device != x.device:
            raise ValueError(f"adain: {name} must be ({n}, {c}) on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    hw = h * w
    block = min(1 << max(hw - 1, 0).bit_length(), 2048)
    with torch.cuda.device(x.device):
        _kernel()[(n * c,)](x, style_scale, style_bias, out, hw, float(eps),
                            BLOCK=block, num_warps=4 if block <= 512 else 8)
    adain_triton.launches += 1
    return out


adain_triton.launches = 0


class AdaIN(torch.autograd.Function):
    """Differentiable AdaIN (kernel forward, plain analytic backward)."""

    @staticmethod
    def forward(ctx, x, style_scale, style_bias, eps=1e-8):
        ctx.save_for_backward(x, style_scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return adain_ref(x, style_scale, style_bias, eps)
        return adain_triton(x.contiguous(), style_scale.contiguous(),
                            style_bias.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        dx, ds, db = adain_bwd(x, s, g, ctx.eps)
        return dx, ds, db, None

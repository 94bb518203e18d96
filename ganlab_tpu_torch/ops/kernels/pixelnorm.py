"""PixelNorm ``x * rsqrt(mean(x^2, last axis) + eps)``: Triton kernel + plain.

Replaces ``ganlab_tpu/ops/pallas/pixelnorm.py::pixel_norm_pallas``
(``_rows_call`` / ``_fwd_kernel``). On the serving path it normalizes the
mapping network's input z, (batch, latent).

Bound: memory. One read and one write of (rows, C), about 3 flops per
element, so the least time is the bytes over 3.35 TB/s (and at the
serving shape, 32 x 512, launch latency dominates either way).

Design: one program per block of rows; each row's C values sit in one
power-of-two block (BLOCK_C = next pow2 of C, masked), so the row's sum of
squares is one ``tl.sum`` in float32 and the scale is applied from
registers: one pass over memory. Output in the input's dtype.

``PixelNorm`` is the autograd Function: forward is the kernel (CUDA) or
the plain version (CPU); backward is the analytic VJP of the JAX package's
``pixelnorm.py::_pn_bwd`` in plain PyTorch (that package's backward kernel
is never called).
"""

from __future__ import annotations

import functools

import torch

from ganlab_tpu_torch.ops.kernels import check_input

tl = None  # triton.language; bound by _kernel() (no triton on CPU hosts)


def _pixel_norm_kernel(x_ptr, o_ptr, rows, C, eps,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.arange(0, BLOCK_C)
    mask = (r[:, None] < rows) & (c[None, :] < C)
    offs = r[:, None].to(tl.int64) * C + c[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=1) / C
    y = x * (1.0 / tl.sqrt(ms + eps))[:, None]
    tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_pixel_norm_kernel)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def pixel_norm_ref(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Plain version: float32 math (float64 for float64 input) over the
    last axis, output in x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


def pixel_norm_bwd(x: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """VJP of pixel_norm at x for cotangent g (last axis)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(dt), g.to(dt)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    prod = (gf * xf).mean(dim=-1, keepdim=True)
    return (r * (gf - xf * prod * (r * r))).to(x.dtype)


def pixel_norm_triton(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA (rows, C) tensor."""
    check_input("pixel_norm", x, ndim=2,
                dtypes=(torch.float32, torch.bfloat16, torch.float16))
    rows, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    block_c = _next_pow2(c)
    block_r = max(1, min(64, 4096 // block_c))
    grid = (-(-rows // block_r),)
    with torch.cuda.device(x.device):
        _kernel()[grid](x, out, rows, c, float(eps),
                        BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    pixel_norm_triton.launches += 1
    return out


pixel_norm_triton.launches = 0


class PixelNorm(torch.autograd.Function):
    """Differentiable pixelnorm over the last axis of (rows, C)."""

    @staticmethod
    def forward(ctx, x, eps=1e-8):
        ctx.save_for_backward(x)
        ctx.eps = eps
        if x.device.type == "cpu":
            return pixel_norm_ref(x, eps)
        return pixel_norm_triton(x.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pixel_norm_bwd(x, g, ctx.eps), None

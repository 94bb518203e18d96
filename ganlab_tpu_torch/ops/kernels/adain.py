"""AdaIN: instance norm over H x W, then ``s * x_hat + b``: CUDA C++ + plain.

Replaces ``ganlab_tpu/ops/pallas/adain.py::adain_pallas`` (``_impl`` /
``_kernel``): per (n, c) plane, mean and biased variance (the two-pass
formula, float32), ``r = rsqrt(var + eps)``, ``y = (x - mean) * r * s + b``,
output in x's dtype. The JAX package runs its kernel only where a
per-image tile fits VMEM; this one takes every shape the synthesis network
makes, planes of 4x4 up to 1024x1024, and any other.

Bound: memory. The function needs one read and one write of x (plus the
(N, C) styles), a handful of flops per element, so the least time is those
bytes over 3.35 TB/s.

What limited the first design, a Triton program per plane that looped over
it three times (sum, squared deviations, write): each pass waited for the
reduction of the one before it, the second and third reads went through
L2, and nothing of the plane was held between passes; and at the small
planes a call cost what Triton's Python launcher costs the host.

Design: the kernel is ``csrc/adain.cu``, built by ``_build`` with nvcc and
called through its plain C interface with the trimmed wrapper that
pixelnorm uses. x is NCHW-contiguous, so each (n, c) plane is one
contiguous run of H*W elements. Where it fits it is read once with 16-byte
loads and held on chip through both reductions and the write: a group of
lanes of a warp per plane up to 32x32, one block per plane up to 256x256
in 16-bit types, and above that a thread block cluster per plane, up to 16
blocks of 512 threads, each holding 64 KiB of its slice in registers and
the rest (1024x1024: 64 KiB in 16-bit types, 192 KiB in float32) in
shared memory, loaded by bulk asynchronous copies; the partial sums are
exchanged through distributed shared memory. Planes larger than 16 such
blocks hold (above about 4.5 MiB; no preset makes one) take the split
path: two launches, the first reducing slices of the plane to their mean
and M2 in a scratch that the wrapper allocates, the second combining them
in slice order by Chan's formula and writing. A looped path takes shapes
that are no multiple of a vector and unaligned pointers. The wrapper asks
the library for its plan only where a plane is above 128 KiB or a path is
forced: a smaller plane never takes the split path, so its call is one
``ctypes`` call to the kernel. ``adain_path`` tells which path a call
takes. The sums are taken in another order than the plain version's, so
float32 agrees with it to rounding, not bit for bit.

``AdaIN`` is the autograd Function: forward is the operator
``torch.ops.ganlab.adain`` (the launching wrapper on CUDA tensors, with
both launches of the split path inside the one call; the plain version on
CPU tensors); backward is the analytic VJP of the JAX package's
``adain.py::_bwd`` in plain PyTorch (that package has no backward kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ganlab_tpu_torch.ops.kernels import (
    check_input,
    define_op,
    raise_launch_error,
    stream_handle,
)
from ganlab_tpu_torch.ops.kernels._build import c_function

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATHS = ("loop", "warp", "block", "cluster", "split")
_FORCE = {"loop": 0, "block": 2, "cluster": 3, "split": 4}
# the kernel's own plan for a plane of up to this many bytes (8192 16-byte
# vectors) is the warp, block or loop path, none of which needs a scratch;
# above it the plan may be the split path (also where the device cannot
# schedule the cluster), so the wrapper asks the library
_SMALL_PLANE_BYTES = 8192 * 16


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# c_function's arguments for each C function of the library
_LAUNCH = ("adain", "ganlab_adain",
           (_P, _P, _P, _P, _P, _LL, _LL, ctypes.c_float, _I, _I, _I, _I, _I,
            _I, _I, _P))
_PLAN = ("adain", "ganlab_adain_plan",
         (_I, _LL, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)))


def _request(path, threads: int, cluster: int) -> int:
    """The C library's path code for a forced or chosen path; ``threads``
    or ``cluster`` alone force the block path (cluster 1) or the cluster
    path."""
    if path is None:
        return -1 if threads == 0 and cluster == 0 else \
            _FORCE["block" if cluster == 1 else "cluster"]
    if path not in _FORCE:
        raise ValueError(f"adain: path must be one of {tuple(_FORCE)}, got "
                         f"{path!r}")
    return _FORCE[path]


@functools.lru_cache(maxsize=256)
def _plan(aligned: bool, hw: int, dtype: int, code: int, threads: int,
          cluster: int, device: int) -> tuple[int, ...]:
    """The C library's plan: (path, threads, vectors a thread, blocks a
    plane, vectors a block, shared-memory bytes a block); raises
    ValueError where it refuses."""
    out = (ctypes.c_int * 6)()
    if c_function(*_PLAN)(int(aligned), hw, dtype, code, threads, cluster,
                          device, out) != 0:
        raise ValueError(f"adain: the kernel cannot take planes of {hw} "
                         f"elements as asked (path code {code}, threads "
                         f"{threads}, cluster {cluster})")
    return tuple(out)


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


def _check(x, style_scale, style_bias):
    check_input("adain", x, dtypes=_DTYPE_CODE, ndim=4)
    n, c = x.shape[:2]
    for name, t in (("style_scale", style_scale), ("style_bias", style_bias)):
        check_input(f"adain {name}", t, dtypes=_DTYPE_CODE, ndim=2)
        if t.shape != (n, c) or t.device != x.device:
            raise ValueError(f"adain: {name} must be ({n}, {c}) on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")


def adain_cuda(x: torch.Tensor, style_scale: torch.Tensor,
               style_bias: torch.Tensor, eps: float = 1e-8, *,
               path: str | None = None, threads: int = 0,
               cluster: int = 0) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) and styles (N, C), all CUDA.

    ``path``, ``threads`` and ``cluster`` (None / 0: the kernel's own
    choice) force a path to measure one against another: "block" (one
    block a plane, ``threads`` wide), "cluster" (a cluster of ``cluster``
    blocks of ``threads``, the plane in registers and what does not fit
    in shared memory; ``threads`` or ``cluster`` alone force the same,
    cluster 1 the block path), "split" (slices of ``threads`` x 8
    vectors, two launches) or "loop". A request the kernel cannot take
    raises.
    """
    _check(x, style_scale, style_bias)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n, c, h, w = x.shape
    index = x.device.index
    code = _request(path, threads, cluster)
    scratch = None
    if code != -1 or h * w * x.element_size() > _SMALL_PLANE_BYTES:
        plan = _plan((x.data_ptr() | out.data_ptr()) % 16 == 0, h * w,
                     _DTYPE_CODE[x.dtype], code, threads, cluster, index)
        if _PATHS[plan[0]] == "split":
            scratch = torch.empty(n * c * plan[3] * 2, dtype=torch.float32,
                                  device=x.device)
    err = c_function(*_LAUNCH)(
        x.data_ptr(), style_scale.data_ptr(), style_bias.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        n * c, h * w, eps, _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[style_scale.dtype], _DTYPE_CODE[style_bias.dtype],
        code, threads, cluster, index, stream_handle(index))
    if err:
        raise_launch_error(err, "adain", x, path=path, threads=threads,
                           cluster=cluster)
    adain_cuda.launches += 1
    return out


adain_cuda.launches = 0


def adain_path(x: torch.Tensor, out: torch.Tensor, *,
               path: str | None = None, threads: int = 0,
               cluster: int = 0) -> str:
    """Which path of the kernel this input and output take and how it is
    cut: "warp 8 lanes x 1", "block 512 x 4" (threads x 16-byte vectors a
    thread), "cluster 16 x 512 x 8 + 64 KiB" (blocks x threads x vectors a
    thread in registers, + shared memory a block where the registers do
    not hold the slice), "split 32 x 512 x 8" (slices x threads x vectors
    a thread) or "loop". Launches nothing."""
    check_input("adain", x, dtypes=_DTYPE_CODE, ndim=4)
    code = _request(path, threads, cluster)
    kind, width, k, blocks, _, smem = _plan(
        (x.data_ptr() | out.data_ptr()) % 16 == 0, x.shape[2] * x.shape[3],
        _DTYPE_CODE[x.dtype], code, threads, cluster, x.device.index)
    return {"loop": "loop", "warp": f"warp {width} lanes x {k}",
            "block": f"block {width} x {k}",
            "cluster": f"cluster {blocks} x {width} x {k}"
            + (f" + {smem // 1024} KiB" if smem else ""),
            "split": f"split {blocks} x {width} x {k}"}[_PATHS[kind]]


ADAIN = define_op(
    "adain",
    "(Tensor x, Tensor style_scale, Tensor style_bias, float eps) -> Tensor",
    cpu=lambda x, s, b, eps: adain_ref(x.contiguous(), s, b, eps),
    cuda=lambda x, s, b, eps: adain_cuda(
        x.contiguous(), s.contiguous(), b.contiguous(), eps),
    fake=lambda x, s, b, eps: x.new_empty(x.shape))


class AdaIN(torch.autograd.Function):
    """Differentiable AdaIN (kernel forward, plain analytic backward)."""

    @staticmethod
    def forward(ctx, x, style_scale, style_bias, eps=1e-8):
        ctx.save_for_backward(x, style_scale)
        ctx.eps = eps
        return ADAIN(x, style_scale, style_bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        dx, ds, db = adain_bwd(x, s, g, ctx.eps)
        return dx, ds, db, None

"""PixelNorm ``x * rsqrt(mean(x^2, C) + eps)``: CUDA C++ + plain.

Replaces ``ganlab_tpu/ops/pallas/pixelnorm.py::pixel_norm_pallas``
(``_rows_call`` / ``_fwd_kernel``) at both of its call sites:

* the last axis of (rows, C): the mapping network's input z, (batch,
  latent) on the serving path; a StyleGAN training step normalizes the two
  latents of its mixing pass as one (2 batch, latent) tensor; the ProGAN
  generator's z;
* the channel axis of NCHW feature maps (``dim=1``): every activation of
  the ProGAN generator, (N, nf, H, W) from 4x4 to the model's resolution,
  which the JAX package flattens from NHWC to (N*H*W, C) rows.

Bound: memory. One read and one write, about 3 flops per element, so the
least time is the bytes over 3.35 TB/s. At (32, 512) that is 64 KB, a
microsecond or two on the card: what a caller waits for is the host's time
to make the launch. progan-128's 128x128 block, (8, 128, 128, 128) bf16, is
33.6 MB each way: about 0.020 ms.

What limited the first design: it was a Triton kernel, and Triton's Python
launcher specialises the arguments and looks the compiled kernel up on
every call, which together with the wrapper's own work took the host
longer than PyTorch's dispatcher needs for ``F.rms_norm``.

Design: both kernels are in ``csrc/pixelnorm.cu``, built by ``_build`` with
nvcc and called through their plain C interface. Rows: one warp per row,
16-byte loads, the row kept in registers, the sum of squares by warp
shuffles, no shared memory. NCHW (redesigned for C >= 256, where the
first design's warps read 16 bytes of each of 32 planes a request): a
block stages a tile of 128 bytes of each of the C planes of one image
through shared memory, eight threads a full line of a plane, then takes
the per-pixel sums from shared memory in the rows kernel's order (so the
two give the same bits on the same values) and writes the tile back a line
at a time; nothing is permuted. The first design (a run of 16 bytes of
pixels, its planes split between the lanes of a warp and kept in
registers) stays for what the tile does not take: element pixels, planes
under a tile, C above 1500. The wrapper
does as little as it can per call: each ``ctypes`` function with its
argument types is looked up once, the C function itself switches device
(only when the tensor is not on the current one), and the stream handle is
read without building a Stream object. Output in the input's dtype.

``PixelNorm`` is the autograd Function for both (``dim`` -1 or 1): forward
is the operator ``torch.ops.ganlab.pixel_norm`` (or ``pixel_norm_nchw``),
whose CUDA implementation is the launching wrapper and whose CPU one the
plain version; backward is the analytic
VJP of the JAX package's ``pixelnorm.py::_pn_bwd`` in plain PyTorch (that
package's backward kernel is never called). Both wrappers add to
``pixel_norm_cuda.launches`` (the kernel's count);
``pixel_norm_nchw_cuda.launches`` counts the channel path alone.
"""

from __future__ import annotations

import ctypes

import torch

from ganlab_tpu_torch.ops.kernels import (
    check_input,
    define_op,
    raise_launch_error,
    stream_handle,
)
from ganlab_tpu_torch.ops.kernels._build import c_function

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# c_function's arguments for each C function of the library
_ROWS = ("pixelnorm", "ganlab_pixel_norm", (_P, _P, _LL, _I, _F, _I, _I, _P))
_NCHW = ("pixelnorm", "ganlab_pixel_norm_nchw",
         (_P, _P, _LL, _I, _LL, _F, _I, _I, _I, _P))
_NCHW_PLAN = ("pixelnorm", "ganlab_pixel_norm_nchw_plan",
              (_P, _P, _I, _LL, _I, _I))


def _axis(dim: int) -> int:
    if dim not in (-1, 1):
        raise ValueError(f"pixel_norm: dim must be -1 (rows) or 1 (the "
                         f"channels of NCHW), got {dim}")
    return dim


def pixel_norm_ref(x: torch.Tensor, eps: float = 1e-8,
                   dim: int = -1) -> torch.Tensor:
    """Plain version: float32 math (float64 for float64 input) over axis
    ``dim``, output in x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ms = xf.square().mean(dim=_axis(dim), keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


def pixel_norm_nchw_ref(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Plain version over the channels of NCHW x."""
    return pixel_norm_ref(x, eps, dim=1)


def pixel_norm_bwd(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-8,
                   dim: int = -1) -> torch.Tensor:
    """VJP of pixel_norm over axis ``dim`` at x for cotangent g."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(dt), g.to(dt)
    dim = _axis(dim)
    r = torch.rsqrt(xf.square().mean(dim=dim, keepdim=True) + eps)
    prod = (gf * xf).mean(dim=dim, keepdim=True)
    return (r * (gf - xf * prod * (r * r))).to(x.dtype)


def pixel_norm_cuda(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Launch the rows kernel on a contiguous CUDA (rows, C) tensor."""
    check_input("pixel_norm", x, ndim=2, dtypes=_DTYPE_CODE)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows, c = x.shape
    index = x.device.index
    err = c_function(*_ROWS)(x.data_ptr(), out.data_ptr(), rows, c, eps,
                             _DTYPE_CODE[x.dtype], index, stream_handle(index))
    if err:
        raise_launch_error(err, "pixel_norm", x)
    pixel_norm_cuda.launches += 1
    return out


def pixel_norm_nchw_cuda(x: torch.Tensor, eps: float = 1e-8, *,
                         tile: int = 0) -> torch.Tensor:
    """Launch the channel kernel on a contiguous CUDA (N, C, H, W) tensor.

    ``tile`` is 0 (the kernel's own plan) or -1 (the run kernel, to measure
    the first design against the plan's choice); any other value raises.
    """
    check_input("pixel_norm_nchw", x, ndim=4, dtypes=_DTYPE_CODE)
    if tile not in (0, -1):
        raise ValueError(f"pixel_norm_nchw: tile must be 0 or -1, got "
                         f"{tile!r}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n, c, h, w = x.shape
    index = x.device.index
    err = c_function(*_NCHW)(x.data_ptr(), out.data_ptr(), n, c, h * w, eps,
                             _DTYPE_CODE[x.dtype], tile, index,
                             stream_handle(index))
    if err:
        raise_launch_error(err, "pixel_norm_nchw", x)
    pixel_norm_cuda.launches += 1
    pixel_norm_nchw_cuda.launches += 1
    return out


pixel_norm_cuda.launches = 0
pixel_norm_nchw_cuda.launches = 0


def pixel_norm_nchw_path(x: torch.Tensor, out: torch.Tensor, *,
                         tile: int = 0) -> str:
    """The plan the channel kernel takes for these tensors and ``tile`` (0
    or -1, as the C library chooses it): the tile kernel and its bytes of
    each plane ("tile 128 B, vector channel groups"), or the run kernel with
    its pixel and channel vectors, whether the planes stay in registers,
    and the lanes that share a run. Launches nothing."""
    plan = c_function(*_NCHW_PLAN)(
        x.data_ptr(), out.data_ptr(), x.shape[1],
        x.shape[2] * x.shape[3], _DTYPE_CODE[x.dtype], tile)
    if plan < 0:
        raise ValueError(f"pixel_norm_nchw: tile must be 0 or -1, got "
                         f"{tile!r}")
    groups = f"{'vector' if plan & 2 else 'single'} channel groups"
    if plan >> 6:
        return f"tile {plan >> 6} B, {groups}"
    return (f"{'vector' if plan & 1 else 'element'} pixels, {groups}, "
            f"{'cached' if plan & 4 else 'two reads'}, "
            f"{1 << (plan >> 3 & 7)} lanes a run")


def _fake(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x.new_empty(x.shape)


# the plain version is looked up at each call, so that a caller that
# replaces it (a test counting the calls) is seen
PIXEL_NORM = define_op(
    "pixel_norm", "(Tensor x, float eps) -> Tensor",
    cpu=lambda x, eps: pixel_norm_ref(x.contiguous(), eps),
    cuda=lambda x, eps: pixel_norm_cuda(x.contiguous(), eps), fake=_fake)
PIXEL_NORM_NCHW = define_op(
    "pixel_norm_nchw", "(Tensor x, float eps) -> Tensor",
    cpu=lambda x, eps: pixel_norm_ref(x.contiguous(), eps, dim=1),
    cuda=lambda x, eps: pixel_norm_nchw_cuda(x.contiguous(), eps),
    fake=_fake)


class PixelNorm(torch.autograd.Function):
    """Differentiable pixelnorm over the last axis of (rows, C)
    (``dim=-1``) or over the channels of (N, C, H, W) (``dim=1``)."""

    @staticmethod
    def forward(ctx, x, eps=1e-8, dim=-1):
        ctx.save_for_backward(x)
        ctx.eps, ctx.dim = eps, _axis(dim)
        return (PIXEL_NORM if dim == -1 else PIXEL_NORM_NCHW)(x, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pixel_norm_bwd(x, g, ctx.eps, ctx.dim), None, None

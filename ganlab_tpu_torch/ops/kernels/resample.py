"""StyleGAN's resampling: CUDA C++ kernels, plain versions, autograd.

Replaces ``ganlab_tpu/ops/pallas/resample.py``: ``upsample_blur_2x_pallas``
(nearest-2x up + [1,2,1] blur) and ``blur_downsample_2x_pallas`` ([1,2,1]
blur + 2x2 average pool). Both kernels live in ``csrc/resample.cu``, built
by ``_build`` with nvcc for ``sm_90a`` and called through its C interface.
They are memory-bound (a few flops per byte moved); the source says how
each reads and writes. NCHW, float32 or bfloat16 storage, float32
arithmetic.

``UpsampleBlur2x`` and ``BlurDownsample2x`` are the autograd Functions.
Each forward runs the kernel on a CUDA tensor and the plain version on a
CPU tensor; each backward is the other Function (the exact adjoints
``vjp(up)(g) = 4 down(g)``, ``vjp(down)(g) = up(g) / 4``), so gradients of
any order, such as R1's double backward, run through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.kernels import _build, check_input

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32/bfloat16 storage; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def upsample_blur_2x_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the polyphase lerp per axis in float32, zero halo.

    x (N, C, H, W) -> (N, C, 2H, 2W) in x's dtype.
    """
    n, c, h, w = x.shape
    v = x.to(_math_dtype(x))
    vp = F.pad(v, (0, 0, 1, 1))                       # rows
    even = 0.25 * vp[:, :, :-2] + 0.75 * vp[:, :, 1:-1]
    odd = 0.75 * vp[:, :, 1:-1] + 0.25 * vp[:, :, 2:]
    v = torch.stack([even, odd], dim=3).reshape(n, c, 2 * h, w)
    vp = F.pad(v, (1, 1))                             # columns
    even = 0.25 * vp[..., :-2] + 0.75 * vp[..., 1:-1]
    odd = 0.75 * vp[..., 1:-1] + 0.25 * vp[..., 2:]
    return torch.stack([even, odd], dim=4).reshape(n, c, 2 * h, 2 * w) \
        .to(x.dtype)


def blur_downsample_2x_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: per axis (rows, then columns) in float32, zero halo,
    ``out[i] = .125 x[2i-1] + .375 x[2i] + .375 x[2i+1] + .125 x[2i+2]``.

    x (N, C, H, W), H and W even -> (N, C, H/2, W/2) in x's dtype.
    """
    _, _, h, w = x.shape
    v = x.to(_math_dtype(x))
    vp = F.pad(v, (0, 0, 1, 1))                       # rows; vp[r+1] = x[r]
    v = (0.125 * vp[:, :, 0:h:2] + 0.375 * vp[:, :, 1:h + 1:2]
         + 0.375 * vp[:, :, 2:h + 2:2] + 0.125 * vp[:, :, 3:h + 3:2])
    vp = F.pad(v, (1, 1))                             # columns
    v = (0.125 * vp[..., 0:w:2] + 0.375 * vp[..., 1:w + 1:2]
         + 0.375 * vp[..., 2:w + 2:2] + 0.125 * vp[..., 3:w + 3:2])
    return v.to(x.dtype)


@functools.cache
def _fn(symbol: str):
    fn = getattr(_build.library("resample").lib, symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(op: str, symbol: str, x: torch.Tensor, out: torch.Tensor,
            h: int, w: int) -> None:
    n, c = x.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(symbol)(x.data_ptr(), out.data_ptr(), n * c, h, w,
                          _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err} at "
                           f"shape {tuple(x.shape)}")


def upsample_blur_2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) CUDA, f32/bf16 -> (N, C, 2H, 2W)."""
    check_input("upsample_blur_2x", x, dtypes=tuple(_DTYPE_CODE), ndim=4)
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("upsample_blur_2x", "ganlab_upsample_blur_2x", x, out, h, w)
    upsample_blur_2x_cuda.launches += 1
    return out


def blur_downsample_2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) CUDA, f32/bf16, H and W even ->
    (N, C, H/2, W/2)."""
    check_input("blur_downsample_2x", x, dtypes=tuple(_DTYPE_CODE), ndim=4)
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"blur_downsample_2x: H and W must be even, got "
                         f"{tuple(x.shape)}")
    out = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("blur_downsample_2x", "ganlab_blur_downsample_2x", x, out,
            h // 2, w // 2)
    blur_downsample_2x_cuda.launches += 1
    return out


upsample_blur_2x_cuda.launches = 0
blur_downsample_2x_cuda.launches = 0


class UpsampleBlur2x(torch.autograd.Function):
    """Differentiable nearest-2x + blur; backward = 4 * BlurDownsample2x."""

    @staticmethod
    def forward(ctx, x):
        if x.device.type == "cpu":
            return upsample_blur_2x_ref(x)
        return upsample_blur_2x_cuda(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return 4.0 * BlurDownsample2x.apply(g)


class BlurDownsample2x(torch.autograd.Function):
    """Differentiable blur + 2x down; backward = UpsampleBlur2x / 4."""

    @staticmethod
    def forward(ctx, x):
        if x.device.type == "cpu":
            return blur_downsample_2x_ref(x)
        return blur_downsample_2x_cuda(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return 0.25 * UpsampleBlur2x.apply(g)

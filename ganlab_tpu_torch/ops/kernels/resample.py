"""Fused nearest-2x upsample + [1,2,1] blur: CUDA C++ kernel + plain version.

Replaces ``ganlab_tpu/ops/pallas/resample.py::upsample_blur_2x_pallas``
(``_up_impl`` / ``_up_kernel``). The kernel is ``csrc/resample.cu``, built
by ``_build`` with nvcc for ``sm_90a`` and called through its C interface.
It is memory-bound (a few flops per byte moved); the source says how its
one-thread-per-2x2-output-quad design reads and writes. NCHW, float32 or
bfloat16 storage, float32 arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.kernels import _build, check_input

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def upsample_blur_2x_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the polyphase lerp per axis in float32, zero halo.

    x (N, C, H, W) -> (N, C, 2H, 2W) in x's dtype.
    """
    n, c, h, w = x.shape
    v = x.float()
    vp = F.pad(v, (0, 0, 1, 1))                       # rows
    even = 0.25 * vp[:, :, :-2] + 0.75 * vp[:, :, 1:-1]
    odd = 0.75 * vp[:, :, 1:-1] + 0.25 * vp[:, :, 2:]
    v = torch.stack([even, odd], dim=3).reshape(n, c, 2 * h, w)
    vp = F.pad(v, (1, 1))                             # columns
    even = 0.25 * vp[..., :-2] + 0.75 * vp[..., 1:-1]
    odd = 0.75 * vp[..., 1:-1] + 0.25 * vp[..., 2:]
    return torch.stack([even, odd], dim=4).reshape(n, c, 2 * h, 2 * w) \
        .to(x.dtype)


@functools.cache
def _fn():
    fn = _build.library("resample").lib.ganlab_upsample_blur_2x
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def upsample_blur_2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) CUDA, f32/bf16 -> (N, C, 2H, 2W)."""
    check_input("upsample_blur_2x", x, dtypes=tuple(_DTYPE_CODE), ndim=4)
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n * c, h, w,
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"upsample_blur_2x kernel launch failed: CUDA "
                           f"error {err} at shape {tuple(x.shape)}")
    upsample_blur_2x_cuda.launches += 1
    return out


upsample_blur_2x_cuda.launches = 0

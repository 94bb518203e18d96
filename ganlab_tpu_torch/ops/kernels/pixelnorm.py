"""PixelNorm ``x * rsqrt(mean(x^2, last axis) + eps)``: CUDA C++ + plain.

Replaces ``ganlab_tpu/ops/pallas/pixelnorm.py::pixel_norm_pallas``
(``_rows_call`` / ``_fwd_kernel``). On the serving path it normalizes the
mapping network's input z, (batch, latent); a training step normalizes the
two latents of its mixing pass as one (2 batch, latent) tensor.

Bound: memory. One read and one write of (rows, C), about 3 flops per
element, so the least time is the bytes over 3.35 TB/s. At (32, 512) that
is 64 KB, a microsecond or two on the card: what a caller waits for is the
host's time to make the launch.

What limited the first design: it was a Triton kernel, and Triton's Python
launcher specialises the arguments and looks the compiled kernel up on
every call, which together with the wrapper's own work took the host
longer than PyTorch's dispatcher needs for ``F.rms_norm``.

Design: the kernel is ``csrc/pixelnorm.cu`` (one warp per row, 16-byte
loads, the row kept in registers, the sum of squares by warp shuffles, no
shared memory), built by ``_build`` with nvcc and called through its plain
C interface. The wrapper does as little as it can per call: the ``ctypes``
function with its argument types is looked up once, the C function itself
switches device (only when the tensor is not on the current one), and the
stream handle is read without building a Stream object. Output in the input's
dtype.

``PixelNorm`` is the autograd Function: forward is the kernel (CUDA) or
the plain version (CPU); backward is the analytic VJP of the JAX package's
``pixelnorm.py::_pn_bwd`` in plain PyTorch (that package's backward kernel
is never called).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ganlab_tpu_torch.ops.kernels import _build, check_input, stream_handle

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _fn():
    """The C function, looked up and given its argument types once."""
    fn = _build.library("pixelnorm").lib.ganlab_pixel_norm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def pixel_norm_cuda(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA (rows, C) tensor."""
    check_input("pixel_norm", x, ndim=2, dtypes=_DTYPE_CODE)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows, c = x.shape
    index = x.device.index
    err = _fn()(x.data_ptr(), out.data_ptr(), rows, c, eps,
                _DTYPE_CODE[x.dtype], index, stream_handle(index))
    if err != 0:
        raise RuntimeError(f"pixel_norm kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(x.shape)}")
    pixel_norm_cuda.launches += 1
    return out


pixel_norm_cuda.launches = 0


class PixelNorm(torch.autograd.Function):
    """Differentiable pixelnorm over the last axis of (rows, C)."""

    @staticmethod
    def forward(ctx, x, eps=1e-8):
        ctx.save_for_backward(x)
        ctx.eps = eps
        if x.device.type == "cpu":
            return pixel_norm_ref(x, eps)
        return pixel_norm_cuda(x.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pixel_norm_bwd(x, g, ctx.eps), None

"""StyleGAN's resampling: CUDA C++ kernels, plain versions, autograd.

Replaces ``ganlab_tpu/ops/pallas/resample.py``: ``upsample_blur_2x_pallas``
(nearest-2x up + [1,2,1] blur) and ``blur_downsample_2x_pallas`` ([1,2,1]
blur + 2x2 average pool). Both kernels live in ``csrc/resample.cu``, built
by ``_build`` with nvcc for ``sm_90a`` and called through its C interface.
They are memory-bound (a few flops per byte moved); the source says how
each reads and writes (16-byte vectors, one row chunk per thread, where
the shape and the pointers allow, one element per thread elsewhere; the
two paths agree bit for bit). NCHW or channels-last (NHWC) memory, the
kernel's layout chosen by the input's (``ops.layout.is_channels_last``)
and the output allocated in it; float32 or bfloat16 storage, float32
arithmetic. Each NHWC path agrees bit for bit with the NCHW paths on the
same values. ``nhwc_launches`` counts a wrapper's NHWC launches beside
``launches``.

Every function here takes a ``gain`` that is multiplied into the result
before it is stored (the kernels do it in their store). The two ops are
adjoints up to a factor 4, ``vjp(up)(g) = 4 down(g)`` and
``vjp(down)(g) = up(g) / 4``, so each autograd Function's backward is the
other Function with that factor as its gain: gradients of any order, such
as R1's double backward, run through the kernels, and none adds an
elementwise pass.

``UpsampleBlur2x`` and ``BlurDownsample2x`` are the autograd Functions.
Each forward calls its operator (``torch.ops.ganlab.upsample_blur_2x``,
``blur_downsample_2x``), which runs the kernel on a CUDA tensor and the
plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.kernels import (
    check_input,
    define_op,
    raise_launch_error,
    stream_handle,
)
from ganlab_tpu_torch.ops.kernels._build import c_function
from ganlab_tpu_torch.ops.layout import CHANNELS_LAST, is_channels_last

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32/bfloat16 storage; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def _scaled(v: torch.Tensor, gain: float) -> torch.Tensor:
    return v if gain == 1.0 else gain * v


def upsample_blur_2x_ref(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Plain version: the polyphase lerp per axis in float32, zero halo,
    times ``gain``.

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
    v = torch.stack([even, odd], dim=4).reshape(n, c, 2 * h, 2 * w)
    return _scaled(v, gain).to(x.dtype)


def blur_downsample_2x_ref(x: torch.Tensor, gain: float = 1.0
                           ) -> torch.Tensor:
    """Plain version: per axis (rows, then columns) in float32, zero halo,
    ``out[i] = .125 x[2i-1] + .375 x[2i] + .375 x[2i+1] + .125 x[2i+2]``,
    times ``gain``.

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
    return _scaled(v, gain).to(x.dtype)


# (x, o, n, c, h, w, gain, nhwc, dtype, device, stream) and the path
# functions' (x, o, n, c, h, w, nhwc, dtype)
_LAUNCH_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_PATH_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int)
# c_function's arguments for the two kernels' C functions
_UP = ("resample", "ganlab_upsample_blur_2x", _LAUNCH_ARGS)
_DOWN = ("resample", "ganlab_blur_downsample_2x", _LAUNCH_ARGS)


def _empty(x: torch.Tensor, shape: tuple, nhwc: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=CHANNELS_LAST if nhwc
                       else torch.contiguous_format)


def _run(op: str, fn: tuple, wrapper, x: torch.Tensor, shape: tuple, h: int,
         w: int, gain: float) -> torch.Tensor:
    """Check ``x``, allocate the output (``shape``) in its layout and
    launch ``fn`` on the plane (h, w) (up+blur's input, blur+down's
    output), counting the launch on ``wrapper``."""
    check_input(op, x, dtypes=_DTYPE_CODE, ndim=4, channels_last=True)
    nhwc = is_channels_last(x)
    out = _empty(x, shape, nhwc)
    if out.numel() == 0:
        return out
    index = x.device.index
    n, c = x.shape[:2]
    err = c_function(*fn)(x.data_ptr(), out.data_ptr(), n, c, h, w, gain,
                          nhwc, _DTYPE_CODE[x.dtype], index,
                          stream_handle(index))
    if err:
        raise_launch_error(err, op, x)
    wrapper.launches += 1
    wrapper.nhwc_launches += nhwc
    return out


def upsample_blur_2x_cuda(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) CUDA, f32/bf16, NCHW or
    channels-last -> (N, C, 2H, 2W) in x's layout, ``gain * up+blur(x)``."""
    n, c, h, w = x.shape
    return _run("upsample_blur_2x", _UP, upsample_blur_2x_cuda, x,
                (n, c, 2 * h, 2 * w), h, w, gain)


def _path(op: str, x: torch.Tensor, out: torch.Tensor, h: int, w: int) -> str:
    check_input(op, x, dtypes=_DTYPE_CODE, ndim=4, channels_last=True)
    fn = c_function("resample", f"ganlab_{op}_path", _PATH_ARGS)
    return {1: "vector", 0: "element"}[fn(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], h, w,
        is_channels_last(x), _DTYPE_CODE[x.dtype])]


def upsample_blur_2x_path(x: torch.Tensor, out: torch.Tensor) -> str:
    """Which path of the up+blur kernel this input and output take (in
    x's layout): "vector" (16-byte accesses) or "element". Launches
    nothing."""
    return _path("upsample_blur_2x", x, out, *x.shape[2:])


def blur_downsample_2x_cuda(x: torch.Tensor, gain: float = 1.0
                            ) -> torch.Tensor:
    """Launch the kernel: x (N, C, H, W) CUDA, f32/bf16, NCHW or
    channels-last, H and W even -> (N, C, H/2, W/2) in x's layout,
    ``gain * blur+down(x)``."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"blur_downsample_2x: H and W must be even, got "
                         f"{tuple(x.shape)}")
    return _run("blur_downsample_2x", _DOWN, blur_downsample_2x_cuda, x,
                (n, c, h // 2, w // 2), h // 2, w // 2, gain)


def blur_downsample_2x_path(x: torch.Tensor, out: torch.Tensor) -> str:
    """Which path of the blur+down kernel this input and output take (in
    x's layout): "vector" (16-byte accesses) or "element". Launches
    nothing."""
    return _path("blur_downsample_2x", x, out, *out.shape[2:])


for _wrapper in (upsample_blur_2x_cuda, blur_downsample_2x_cuda):
    _wrapper.launches = _wrapper.nhwc_launches = 0


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a kernel takes it: channels-last stays, anything else
    becomes NCHW-contiguous."""
    return x if is_channels_last(x) else x.contiguous()


def _plain(ref, x: torch.Tensor, gain: float) -> torch.Tensor:
    """The plain version ``ref`` on ``x``, its result in x's layout."""
    out = ref(x.contiguous(), gain)
    return out.contiguous(memory_format=CHANNELS_LAST) \
        if is_channels_last(x) else out


def _up_fake(x: torch.Tensor, gain: float) -> torch.Tensor:
    n, c, h, w = x.shape
    return _empty(x, (n, c, 2 * h, 2 * w), is_channels_last(x))


def _down_fake(x: torch.Tensor, gain: float) -> torch.Tensor:
    n, c, h, w = x.shape
    return _empty(x, (n, c, h // 2, w // 2), is_channels_last(x))


UPSAMPLE_BLUR_2X = define_op(
    "upsample_blur_2x", "(Tensor x, float gain) -> Tensor",
    cpu=lambda x, gain: _plain(upsample_blur_2x_ref, x, gain),
    cuda=lambda x, gain: upsample_blur_2x_cuda(_kernel_input(x), gain),
    fake=_up_fake)
BLUR_DOWNSAMPLE_2X = define_op(
    "blur_downsample_2x", "(Tensor x, float gain) -> Tensor",
    cpu=lambda x, gain: _plain(blur_downsample_2x_ref, x, gain),
    cuda=lambda x, gain: blur_downsample_2x_cuda(_kernel_input(x), gain),
    fake=_down_fake)


class UpsampleBlur2x(torch.autograd.Function):
    """Differentiable ``gain *`` nearest-2x + blur; backward is
    BlurDownsample2x with gain ``4 * gain``."""

    @staticmethod
    def forward(ctx, x, gain=1.0):
        ctx.gain = gain
        return UPSAMPLE_BLUR_2X(x, gain)

    @staticmethod
    def backward(ctx, g):
        return BlurDownsample2x.apply(g, 4.0 * ctx.gain), None


class BlurDownsample2x(torch.autograd.Function):
    """Differentiable ``gain *`` blur + 2x down; backward is UpsampleBlur2x
    with gain ``gain / 4``."""

    @staticmethod
    def forward(ctx, x, gain=1.0):
        ctx.gain = gain
        return BLUR_DOWNSAMPLE_2X(x, gain)

    @staticmethod
    def backward(ctx, g):
        return UpsampleBlur2x.apply(g, 0.25 * ctx.gain), None

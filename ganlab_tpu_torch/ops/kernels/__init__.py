"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

=============  ==============================  ======================
kernel         replaces (TPU, Pallas)          route / source
=============  ==============================  ======================
pixelnorm      ops/pallas/pixelnorm.py          CUDA C++, ``csrc/pixelnorm.cu``
adain          ops/pallas/adain.py              CUDA C++, ``csrc/adain.cu``
upsample_blur  ops/pallas/resample.py (up)      CUDA C++, ``csrc/resample.cu``
blur_down      ops/pallas/resample.py (down)    CUDA C++, ``csrc/resample.cu``
mbstd          ops/pallas/mbstd.py              CUDA C++, ``csrc/mbstd.cu``
=============  ==============================  ======================

Every launching wrapper takes CUDA tensors only: it checks device, dtype,
shape and contiguity, raises on anything else, allocates its output with
``torch.empty``, launches on the current stream and adds one to its
``launches`` attribute. The CUDA C++ sources are built by ``_build`` at
first use and called through ``ctypes``; per call such a wrapper does
nothing but the checks, the allocation, ``stream_handle`` and the call.
There is no fallback: the dispatching ops in ``ganlab_tpu_torch.ops`` send
a CPU tensor to the plain version and every other tensor to the kernel.
Gradients go through the autograd Function beside each kernel
(``PixelNorm``, ``AdaIN``, ``UpsampleBlur2x``, ``BlurDownsample2x``,
``MinibatchStddev``), whose forward calls the launching wrapper with grad
mode off; a direct call of a wrapper on a tensor that autograd would need
to differentiate raises.
"""

from __future__ import annotations

import torch


def check_input(op: str, x: torch.Tensor, *, dtypes, ndim: int) -> None:
    """Raise unless ``x`` is what the kernel ``op`` takes."""
    if not x.is_cuda:
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got a tensor "
                         f"on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{op}: dtype {x.dtype} not in {tuple(dtypes)}")
    if x.dim() != ndim:
        raise ValueError(f"{op}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{op}: the kernel takes contiguous tensors")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{op}: the launching wrapper does not record gradients; call "
            "the op through its autograd Function (ganlab_tpu_torch.ops) "
            "or under torch.no_grad()")


def _current_stream_handle(device_index: int) -> int:
    return torch.cuda.current_stream(device_index).cuda_stream


# The ``cudaStream_t`` of PyTorch's current stream on a device, as an int
# for ``ctypes``: ``stream_handle(device_index)``. Read at every launch, so
# that a launch made during a CUDA-graph capture lands on the capturing
# stream. PyTorch's raw getter builds no Stream object per call.
stream_handle = getattr(torch._C, "_cuda_getCurrentRawStream",
                        _current_stream_handle)

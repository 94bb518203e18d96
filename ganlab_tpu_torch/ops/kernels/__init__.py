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

Each launch is also an operator of the ``ganlab`` namespace of
``torch.library`` (``torch.ops.ganlab.pixel_norm``, ``pixel_norm_nchw``,
``adain``, ``upsample_blur_2x``, ``blur_downsample_2x``,
``minibatch_stddev``), defined when this package is imported, with the
launching wrapper as its CUDA implementation, the plain version as its
CPU one and a fake implementation (output shape and dtype, no data) for
``FakeTensorMode``, ``torch.export`` and the meta device. So a traced or
exported graph holds the operator, and the dispatcher picks the kernel
or the plain version by the tensors' device: there is no fallback, a
CPU tensor takes the plain version and a CUDA tensor the kernel. The
operators are ``torch.library.Library`` definitions with Python
implementations, not ``torch.library.custom_op``, which wraps every call
in further Python layers: the host's time a call of the three ways (the
wrapper alone, this operator, a ``custom_op`` around the same wrapper)
is read by ``chip_smoke.py`` phase 3 and written down in ``PERF.md``.

Gradients go through the autograd Function beside each kernel
(``PixelNorm``, ``AdaIN``, ``UpsampleBlur2x``, ``BlurDownsample2x``,
``MinibatchStddev``), whose forward calls the operator with grad mode
off; a direct call of a wrapper on a tensor that autograd would need to
differentiate raises.
"""

from __future__ import annotations

from typing import Callable, NoReturn

import torch

LIBRARY = torch.library.Library("ganlab", "DEF")


def define_op(name: str, schema: str, *, cpu: Callable, cuda: Callable,
              fake: Callable) -> torch._ops.OpOverload:
    """Define ``ganlab::<name><schema>`` with its CPU (plain version), CUDA
    (launching wrapper) and fake implementations; returns the operator's
    overload, which callers keep (it skips the overload lookup of
    ``torch.ops.ganlab.<name>`` on every call)."""
    LIBRARY.define(name + schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"ganlab::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.ganlab, name).default


def check_input(op: str, x: torch.Tensor, *, dtypes, ndim: int,
                channels_last: bool = False) -> None:
    """Raise unless ``x`` is what the kernel ``op`` takes: contiguous, or
    (``channels_last``, a kernel with an NHWC path) channels-last."""
    if not x.is_cuda:
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got a tensor "
                         f"on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{op}: dtype {x.dtype} not in {tuple(dtypes)}")
    if x.dim() != ndim:
        raise ValueError(f"{op}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() or channels_last and x.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError(f"{op}: the kernel takes contiguous tensors"
                         + (" or channels-last ones" if channels_last
                            else ""))
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{op}: the launching wrapper does not record gradients; call "
            "the op through its autograd Function (ganlab_tpu_torch.ops) "
            "or under torch.no_grad()")


def raise_launch_error(err: int, op: str, x: torch.Tensor, **cut) -> NoReturn:
    """Raise the CUDA error ``err`` that the kernel ``op``'s C call on ``x``
    returned; ``cut`` names the call's forced path, threads or cluster. A
    wrapper calls it only where ``err`` is not 0, so a launch pays
    nothing for it."""
    forced = f" ({', '.join(f'{k} {v}' for k, v in cut.items())})" \
        if cut else ""
    raise RuntimeError(f"{op} kernel launch failed: CUDA error {err} at "
                       f"shape {tuple(x.shape)}{forced}")


def _current_stream_handle(device_index: int) -> int:
    return torch.cuda.current_stream(device_index).cuda_stream


# The ``cudaStream_t`` of PyTorch's current stream on a device, as an int
# for ``ctypes``: ``stream_handle(device_index)``. Read at every launch, so
# that a launch made during a CUDA-graph capture lands on the capturing
# stream. PyTorch's raw getter builds no Stream object per call.
stream_handle = getattr(torch._C, "_cuda_getCurrentRawStream",
                        _current_stream_handle)


# the kernel modules define their operators when imported: importing this
# package registers all of them (an exported program needs them to load)
from ganlab_tpu_torch.ops.kernels import (  # noqa: E402, F401
    adain,
    mbstd,
    pixelnorm,
    resample,
)


# the count attributes of a launching wrapper
COUNTS = ("launches", "nhwc_launches")


def launch_counters() -> tuple:
    """The launching wrappers, each with its ``launches`` count (the NCHW
    pixelnorm adds to ``pixel_norm_cuda``'s too; the resample wrappers
    count their NHWC launches in ``nhwc_launches`` besides). A CUDA graph
    that holds launches of these adds them to the counts at each replay
    (``train/graphs.py``, every attribute of ``COUNTS`` a wrapper has)."""
    return (pixelnorm.pixel_norm_cuda, pixelnorm.pixel_norm_nchw_cuda,
            adain.adain_cuda, resample.upsample_blur_2x_cuda,
            resample.blur_downsample_2x_cuda, mbstd.minibatch_stddev_cuda)

"""Minibatch stddev (whole-batch group): CUDA C++ kernel + plain + autograd.

Replaces ``ganlab_tpu/ops/pallas/mbstd.py::minibatch_stddev_pallas``
(``_impl`` / ``_kernel``): x (N, C, H, W) -> (N, C+1, H, W), a copy of x
with one channel appended last, filled with the scalar

    stat = mean over (c, h, w) of sqrt(var over n of x + eps)

(biased variance, float32 math, output in x's dtype).

Bound: memory by its bytes (one read of x, one write of x plus the new
channel, about 1 MB in bf16 at the training shape (32, 512, 4, 4)), and at
that size launch latency: a caller waits for the host to make the launch.

What limited the first design: it was two Triton kernels (per-column
partial sums into a scratch buffer, then a one-program sum and fill), so
two dependent launches, an allocation, and Triton's Python launcher twice
per call.

Design: the kernel is ``csrc/mbstd.cu``: one launch of one thread block
cluster, no scratch buffer and no atomics. x is viewed as an (N, M) matrix,
M = C*H*W, the output as (N, M + H*W); each thread walks the batch for one
16-byte vector of adjacent columns (one element on the element path, which
takes every shape and pointer the vector path cannot), copies as it goes,
takes the two-pass variance, and the sum of sqrt(var + eps) goes warp ->
block -> cluster through distributed shared memory in a fixed order, so a
call is bit-reproducible. With N <= 32 the batch stays in registers and x
is read once. Built by ``_build`` with nvcc and called through its plain C
interface like the other kernels: the ``ctypes`` function is looked up
once, the C function switches device, the stream handle is an int.

``MinibatchStddev`` is the autograd Function: forward is the operator
``torch.ops.ganlab.minibatch_stddev`` (the kernel on a CUDA tensor, the
plain version on a CPU tensor); backward is plain PyTorch on the saved x, as
the JAX package's ``_mb_bwd`` is plain XLA, and stays differentiable
because it lies inside R1's double backward.
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 1024
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# c_function's arguments for each C function of the library
_LAUNCH = ("mbstd", "ganlab_mbstd",
           (_P, _P, _I, _LL, _I, ctypes.c_float, _I, _I, _I, _P))
_PATH = ("mbstd", "ganlab_mbstd_path", (_P, _P, _I, _LL, _I, _I))


def minibatch_stddev_ref(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Plain version: (N, C, H, W) -> (N, C+1, H, W), float32 math."""
    n, _, h, w = x.shape
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=0, keepdim=True)
    var = (xf - mean).square().mean(dim=0)
    stat = torch.sqrt(var + eps).mean()
    feat = stat.to(x.dtype).expand(n, 1, h, w)
    return torch.cat([x, feat], dim=1)


def minibatch_stddev_bwd(x: torch.Tensor, g: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """VJP of minibatch_stddev at x for the output cotangent g:
    the pass-through part plus (x - mean) / (N * std) * sum(g_stat) / M."""
    n, c, h, w = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    gs = g[:, c].to(dt).sum()
    mean = xf.mean(dim=0, keepdim=True)
    var = (xf - mean).square().mean(dim=0, keepdim=True)
    std = torch.sqrt(var + eps)
    dx = g[:, :c].to(dt) + gs / (h * w * c) * (xf - mean) / (n * std)
    return dx.to(x.dtype)


def _check(x: torch.Tensor) -> None:
    check_input("minibatch_stddev", x, dtypes=_DTYPE_CODE, ndim=4)
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"minibatch_stddev: the kernel takes a batch of at "
                         f"most {MAX_BATCH}, got {x.shape[0]}")


def minibatch_stddev_cuda(x: torch.Tensor, eps: float = 1e-8, *,
                          cluster: int = 0) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA (N, C, H, W) tensor.

    ``cluster`` (0: the kernel's own choice, 8) runs the call with that
    many thread blocks (1, 2, 4 or 8), to measure one against another.
    """
    _check(x)
    n, c, h, w = x.shape
    out = torch.empty((n, c + 1, h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    index = x.device.index
    err = c_function(*_LAUNCH)(
        x.data_ptr(), out.data_ptr(), n, c * h * w, h * w, eps,
        _DTYPE_CODE[x.dtype], cluster, index, stream_handle(index))
    if err:
        raise_launch_error(err, "minibatch_stddev", x, cluster=cluster)
    minibatch_stddev_cuda.launches += 1
    return out


minibatch_stddev_cuda.launches = 0


def minibatch_stddev_path(x: torch.Tensor, out: torch.Tensor) -> str:
    """Which path of the kernel this input and output take: "vector" or
    "element", then "held" (the batch stays in registers) or "reread",
    then the threads a block, as in "vector held 128". Launches nothing."""
    _check(x)
    n, c, h, w = x.shape
    code = c_function(*_PATH)(x.data_ptr(), out.data_ptr(), n, c * h * w,
                              h * w, _DTYPE_CODE[x.dtype])
    if code < 0:
        raise ValueError(f"minibatch_stddev: no path for {tuple(x.shape)}")
    return (f"{'vector' if code & 1 else 'element'} "
            f"{'held' if code & 2 else 'reread'} {code >> 2}")


def _fake(x: torch.Tensor, eps: float) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.new_empty((n, c + 1, h, w))


MINIBATCH_STDDEV = define_op(
    "minibatch_stddev", "(Tensor x, float eps) -> Tensor",
    cpu=lambda x, eps: minibatch_stddev_ref(x.contiguous(), eps),
    cuda=lambda x, eps: minibatch_stddev_cuda(x.contiguous(), eps),
    fake=_fake)


class MinibatchStddev(torch.autograd.Function):
    """Differentiable whole-batch minibatch stddev (kernel forward)."""

    @staticmethod
    def forward(ctx, x, eps=1e-8):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return MINIBATCH_STDDEV(x, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return minibatch_stddev_bwd(x, g, ctx.eps), None

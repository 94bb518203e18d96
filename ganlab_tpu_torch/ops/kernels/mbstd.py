"""Minibatch stddev (whole-batch group): Triton kernel + plain + autograd.

Replaces ``ganlab_tpu/ops/pallas/mbstd.py::minibatch_stddev_pallas``
(``_impl`` / ``_kernel``): x (N, C, H, W) -> (N, C+1, H, W), a copy of x
with one channel appended last, filled with the scalar

    stat = mean over (c, h, w) of sqrt(var over n of x + eps)

(biased variance, float32 math, output in x's dtype).

Bound: memory, and at the training shape (32, 512, 4, 4) launch latency.
The function moves one read of x and one write of x plus the new channel
(about 1 MB in bf16), with a few flops per element.

Design: x is viewed as an (N, M) matrix, M = C*H*W, and the output as
(N, M + H*W) with the new channel in the last H*W columns of each row. A
first kernel gives each program a block of BLOCK_M columns with the whole
batch in registers (BLOCK_N = next power of two of N): it copies the block
to the output, takes each column's two-pass variance over the batch, and
writes the block's sum of sqrt(var + eps) to a partial buffer. A second,
one-program kernel sums the partials in a fixed order (deterministic, no
atomics), divides by M and fills the new channel. The Pallas kernel did
both in one program over a VMEM-resident batch; a Hopper block cannot hold
the 0.5 MB input, and one SM alone would stream it slowly, hence the split.
``minibatch_stddev_triton`` counts one launch per call (two kernels).

``MinibatchStddev`` is the autograd Function: forward is the kernel (CUDA)
or the plain version (CPU); backward is plain PyTorch on the saved x, as
the JAX package's ``_mb_bwd`` is plain XLA, and stays differentiable
because it lies inside R1's double backward.
"""

from __future__ import annotations

import functools

import torch

from ganlab_tpu_torch.ops.kernels import check_input

tl = None  # triton.language; bound by _kernels() (no triton on CPU hosts)

_DTYPES = (torch.float32, torch.bfloat16)
MAX_BATCH = 1024


def _mbstd_partial_kernel(x_ptr, o_ptr, part_ptr, N, M, HW, eps,
                          BLOCK_N: tl.constexpr, BLOCK_M: tl.constexpr):
    p = tl.program_id(0)
    cols = p * BLOCK_M + tl.arange(0, BLOCK_M)
    rows = tl.arange(0, BLOCK_N)
    cmask = cols < M
    mask = (rows[:, None] < N) & cmask[None, :]
    r64 = rows[:, None].to(tl.int64)
    xr = tl.load(x_ptr + r64 * M + cols[None, :], mask=mask, other=0.0)
    tl.store(o_ptr + r64 * (M + HW) + cols[None, :], xr, mask=mask)
    x = xr.to(tl.float32)
    mean = tl.sum(x, axis=0) / N
    d = tl.where(mask, x - mean[None, :], 0.0)
    var = tl.sum(d * d, axis=0) / N
    std = tl.where(cmask, tl.sqrt(var + eps), 0.0)
    tl.store(part_ptr + p, tl.sum(std, axis=0))


def _mbstd_fill_kernel(part_ptr, o_ptr, P, N, M, HW,
                       BLOCK_P: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.arange(0, BLOCK_P)
    acc = tl.zeros([BLOCK_P], dtype=tl.float32)
    for start in range(0, P, BLOCK_P):
        acc += tl.load(part_ptr + start + offs, mask=start + offs < P,
                       other=0.0)
    stat = tl.sum(acc, axis=0) / M
    lane = tl.arange(0, BLOCK)
    total = N * HW
    for start in range(0, total, BLOCK):
        e = start + lane
        n = e // HW
        k = e - n * HW
        val = tl.zeros([BLOCK], dtype=tl.float32) + stat
        tl.store(o_ptr + n.to(tl.int64) * (M + HW) + M + k,
                 val.to(o_ptr.dtype.element_ty), mask=e < total)


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_mbstd_partial_kernel), triton.jit(_mbstd_fill_kernel)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


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


def minibatch_stddev_triton(x: torch.Tensor,
                            eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernels on a contiguous CUDA (N, C, H, W) tensor."""
    check_input("minibatch_stddev", x, dtypes=_DTYPES, ndim=4)
    n, c, h, w = x.shape
    if n > MAX_BATCH:
        raise ValueError(f"minibatch_stddev: the kernel takes a batch of at "
                         f"most {MAX_BATCH}, got {n}")
    out = torch.empty((n, c + 1, h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    hw, m = h * w, c * h * w
    block_n = _next_pow2(n)
    block_m = max(16, 2048 // block_n)
    parts = -(-m // block_m)
    partial = torch.empty(parts, dtype=torch.float32, device=x.device)
    partial_k, fill_k = _kernels()
    with torch.cuda.device(x.device):
        partial_k[(parts,)](x, out, partial, n, m, hw, float(eps),
                            BLOCK_N=block_n, BLOCK_M=block_m, num_warps=4)
        fill_k[(1,)](partial, out, parts, n, m, hw,
                     BLOCK_P=min(_next_pow2(parts), 1024), BLOCK=1024,
                     num_warps=4)
    minibatch_stddev_triton.launches += 1
    return out


minibatch_stddev_triton.launches = 0


class MinibatchStddev(torch.autograd.Function):
    """Differentiable whole-batch minibatch stddev (kernel forward)."""

    @staticmethod
    def forward(ctx, x, eps=1e-8):
        ctx.save_for_backward(x)
        ctx.eps = eps
        if x.device.type == "cpu":
            return minibatch_stddev_ref(x, eps)
        return minibatch_stddev_triton(x.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return minibatch_stddev_bwd(x, g, ctx.eps), None

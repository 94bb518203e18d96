"""Minibatch standard deviation layer (ProGAN sec. 3), NCHW.

Port of ``ganlab_tpu/ops/minibatch_stddev.py``: appends one channel, last,
holding the mean over channels and pixels of the batch standard deviation.
The whole-batch form (``group_size=None``) goes through the autograd
Function ``MinibatchStddev`` (CUDA C++ kernel on the card, plain version on
the CPU); the grouped form (StyleGAN's variant) is plain PyTorch, as in
the JAX package. Under data parallelism the statistic is per device.
"""

from __future__ import annotations

import torch

from ganlab_tpu_torch.ops.kernels.mbstd import MinibatchStddev


def minibatch_stddev(x: torch.Tensor, group_size: int | None = None,
                     eps: float = 1e-8) -> torch.Tensor:
    """x (N, C, H, W) -> (N, C+1, H, W).

    ``group_size=None`` uses the whole batch as one group. A finite size G
    (lowered to a divisor of N) reshapes the batch to (G, N//G, ...) as the
    JAX package does, so sample s shares its statistic with the samples
    s' = s mod N//G.
    """
    if group_size is None:
        return MinibatchStddev.apply(x, eps)
    n, c, h, w = x.shape
    g = min(group_size, n)
    while n % g != 0:
        g -= 1
    y = x.reshape(g, n // g, c, h, w).float()
    mean = y.mean(dim=0, keepdim=True)
    var = (y - mean).square().mean(dim=0)                 # (N//G, C, H, W)
    avg = torch.sqrt(var + eps).mean(dim=(1, 2, 3))       # (N//G,)
    feat = avg[None, :, None, None, None].expand(g, n // g, 1, h, w)
    feat = feat.reshape(n, 1, h, w).to(x.dtype)
    return torch.cat([x, feat], dim=1)

"""Resampling ops of StyleGAN and ProGAN, NCHW.

Port of ``ganlab_tpu/ops/upfirdn.py``: nearest-2x upsampling, 2x2 average
pooling, the [1,2,1] binomial blur, and the two fused forms StyleGAN uses
(Karras et al. 2018 app. C): nearest-2x up followed by the blur (G) and
the blur followed by 2x down (D). The fused forms go through their autograd
Functions: a CPU tensor takes the plain version, any other tensor the CUDA
kernel of ``csrc/resample.cu``, which launches or raises. The rest is
plain PyTorch, as the JAX package has no kernel for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.kernels.resample import (
    BlurDownsample2x,
    UpsampleBlur2x,
)


def binomial_kernel(taps=(1.0, 2.0, 1.0)) -> torch.Tensor:
    """Normalized separable 2D FIR kernel from 1D taps, shape (k, k)."""
    t = torch.tensor(taps, dtype=torch.float32)
    k = torch.outer(t, t)
    return k / k.sum()


def blur2d(x: torch.Tensor, taps=(1.0, 2.0, 1.0)) -> torch.Tensor:
    """Depthwise FIR blur with SAME (zero) padding; odd tap count."""
    c = x.shape[1]
    k = binomial_kernel(taps).to(device=x.device, dtype=x.dtype)
    pad = (k.shape[0] - 1) // 2
    return F.conv2d(x, k.expand(c, 1, *k.shape), padding=pad, groups=c)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (ProGAN G path)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2) \
        .reshape(n, c, 2 * h, 2 * w)


def downsample_avg_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsampling (ProGAN D path, D fade branch)."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5)) * 0.25


def upsample_blur_2x(x: torch.Tensor) -> torch.Tensor:
    """blur([1,2,1]) of nearest_up_2x(x), with zero padding at the border."""
    return UpsampleBlur2x.apply(x)


def blur_downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """downsample_avg_2x(blur([1,2,1])(x)), with zero padding at the border."""
    return BlurDownsample2x.apply(x)


def fade_in(alpha: float, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """lerp: old + alpha * (new - old) (progressive-growing fade)."""
    return old + alpha * (new - old)

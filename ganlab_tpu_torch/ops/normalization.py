"""Normalization ops: pixelnorm, instance norm, AdaIN.

Port of ``ganlab_tpu/ops/normalization.py``. pixel_norm and adain go
through their autograd Functions (``ops/kernels``): a CPU tensor takes the
plain PyTorch version, any other tensor the hand-written kernel, which
launches or raises. There is no backend switch.
"""

from __future__ import annotations

import torch

from ganlab_tpu_torch.ops.kernels.adain import AdaIN
from ganlab_tpu_torch.ops.kernels.pixelnorm import PixelNorm


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, last axis) + eps), e.g. on (N, latent) z."""
    c = x.shape[-1]
    return PixelNorm.apply(x.reshape(-1, c), eps).reshape(x.shape)


def instance_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample, per-channel spatial normalization of NCHW x (biased
    variance, no affine), computed in x's dtype as the JAX op does."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def adain(x: torch.Tensor, style_scale: torch.Tensor,
          style_bias: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """AdaIN(x, y) = y_s * instance_norm(x) + y_b (Karras et al. 2018).

    x: (N, C, H, W); style_scale / style_bias: (N, C).
    """
    return AdaIN.apply(x, style_scale, style_bias, eps)

"""Normalization ops: pixelnorm, instance norm, AdaIN.

Port of ``ganlab_tpu/ops/normalization.py``. A CPU tensor goes to the
plain PyTorch version; any other tensor goes to the hand-written kernel
(``ops/kernels``), which launches or raises. There is no backend switch.
"""

from __future__ import annotations

import torch

from ganlab_tpu_torch.ops.kernels.adain import adain_ref, adain_triton
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    pixel_norm_ref,
    pixel_norm_triton,
)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, last axis) + eps), e.g. on (N, latent) z."""
    if x.device.type == "cpu":
        return pixel_norm_ref(x, eps)
    c = x.shape[-1]
    return pixel_norm_triton(x.reshape(-1, c), eps).reshape(x.shape)


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
    if x.device.type == "cpu":
        return adain_ref(x, style_scale, style_bias, eps)
    return adain_triton(x, style_scale, style_bias, eps)

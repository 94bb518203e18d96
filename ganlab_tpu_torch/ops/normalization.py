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


def pixel_norm(x: torch.Tensor, eps: float = 1e-8,
               dim: int = -1) -> torch.Tensor:
    """x * rsqrt(mean(x^2, axis dim) + eps).

    ``dim=-1``: the last axis, e.g. of (N, latent) z (the JAX package's
    only layout). ``dim=1``: the channels of NCHW feature maps (N, C, H,
    W), where the JAX package normalizes the last axis of NHWC."""
    if dim == 1 and x.dim() == 4:
        return PixelNorm.apply(x, eps, 1)
    if dim not in (-1, x.dim() - 1):
        raise ValueError(f"pixel_norm: dim {dim} of a {x.dim()}-d tensor; "
                         "takes the last axis or dim=1 of NCHW")
    c = x.shape[-1]
    return PixelNorm.apply(x.reshape(-1, c), eps, -1).reshape(x.shape)


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

"""ResNet-GAN generator and discriminator (fixed resolution), NCHW.

Port of ``ganlab_tpu/models/resnetgan.py`` with the flax parameter names
(``dense``, ``up{i}.conv0`` / ``.conv1`` / ``.skip``, ``torgb``;
``fromrgb``, ``down{i}.*``, ``final.*``, ``score``), so
``convert.from_flax`` maps one tree onto the other. The WGAN-GP ResNet
architecture (Gulrajani et al.): a dense stem to 4x4, residual up-blocks and
``tanh`` in G; residual down-blocks, a global mean and a score in D. No
batch norm, equalized-LR layers, no progressive machinery: ``res_log2`` and
``alpha`` are accepted for the callers' uniformity and ignored. A block has
a 1x1 skip conv only where its input and output widths differ (never at
the preset's one width ``model.base_channels``); the residual sum is scaled
by 1/sqrt(2) rounded to the activation dtype, as the JAX package does.
This module runs no kernel of its own.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ganlab_tpu_torch.config import ModelConfig
from ganlab_tpu_torch.models.layers import EqualConv, EqualDense
from ganlab_tpu_torch.ops import (
    downsample_avg_2x,
    leaky_relu,
    upsample_nearest_2x,
)

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _residual(skip: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return (skip + h) * torch.tensor(_INV_SQRT2, dtype=h.dtype)


def _skip_conv(in_ch: int, features: int) -> EqualConv | None:
    if in_ch == features:
        return None
    return EqualConv(in_ch, features, 1, gain=1.0, use_bias=False)


class ResUpBlock(nn.Module):
    """Residual block with nearest 2x upsampling (generator)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.skip = _skip_conv(in_ch, features)
        self.conv0 = EqualConv(in_ch, features, 3)
        self.conv1 = EqualConv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = upsample_nearest_2x(x)
        if self.skip is not None:
            skip = self.skip(skip)
        h = upsample_nearest_2x(leaky_relu(x))
        h = self.conv1(leaky_relu(self.conv0(h)))
        return _residual(skip, h)


class ResDownBlock(nn.Module):
    """Residual block with 2x average-pool downsampling (discriminator)."""

    def __init__(self, in_ch: int, features: int, downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.skip = _skip_conv(in_ch, features)
        self.conv0 = EqualConv(in_ch, features, 3)
        self.conv1 = EqualConv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = downsample_avg_2x(x) if self.downsample else x
        if self.skip is not None:
            skip = self.skip(skip)
        h = self.conv1(leaky_relu(self.conv0(x)))
        if self.downsample:
            h = downsample_avg_2x(h)
        return _residual(skip, h)


class ResNetGenerator(nn.Module):
    """z (N, latent) -> images (N, C, R, R) in [-1, 1] (tanh), z's dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        ch = self.channels = cfg.base_channels
        self.n_up = cfg.res_log2 - 2
        self.dense = EqualDense(cfg.latent_dim, 16 * ch)
        for i in range(self.n_up):
            self.add_module(f"up{i}", ResUpBlock(ch, ch))
        self.torgb = EqualConv(ch, cfg.img_channels, 3, gain=1.0)

    def forward(self, z: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0, fade: bool | None = None
                ) -> torch.Tensor:
        x = self.dense(z)
        # (h, w, c) order as the JAX reshape, then NCHW
        x = x.reshape(x.shape[0], 4, 4, self.channels) \
            .permute(0, 3, 1, 2).contiguous()
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return torch.tanh(self.torgb(leaky_relu(x)))


class ResNetDiscriminator(nn.Module):
    """images (N, C, R, R) -> scores (N,) in the images' dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        ch = cfg.base_channels
        self.n_down = cfg.res_log2 - 2
        self.fromrgb = EqualConv(cfg.img_channels, ch, 3)
        for i in range(self.n_down):
            self.add_module(f"down{i}", ResDownBlock(ch, ch))
        self.final = ResDownBlock(ch, ch, downsample=False)
        self.score = EqualDense(ch, 1, gain=1.0)

    def forward(self, img: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0, fade: bool | None = None
                ) -> torch.Tensor:
        x = self.fromrgb(img)
        for i in range(self.n_down):
            x = getattr(self, f"down{i}")(x)
        x = leaky_relu(self.final(x)).mean(dim=(2, 3))
        return self.score(x)[:, 0]

"""StyleGAN2 generator (Karras et al. 2019), (N, C, H, W) activations.

Port of ``ganlab_tpu/models/stylegan2.py`` with the same module and
parameter names (``mapping.fc{i}``, ``synthesis.const``, ``conv4``,
``block{R}.conv0`` / ``.conv1``, ``torgb{R}.conv``; each modulated layer
holds ``affine`` (an equalized dense layer), ``w``, ``noise`` and ``b``),
so ``convert.from_flax`` carries a tree one to one.

* ``ModulatedLayer``: style affine -> modulated conv (+ demodulation) ->
  noise -> bias -> LeakyReLU x sqrt(2), in the activation dtype.
* ``ToRGB``: a modulated 1x1 conv with gain 1 and no demodulation.
* ``Synthesis2Network``: the skip architecture. Every resolution emits
  RGB, and the RGB of the resolution below is upsampled (nearest 2x +
  blur, the ``upsample_blur_2x`` kernel) and added. Conv layers take the
  style indices 0 .. L-2 and each resolution's toRGB the next index (the
  top one L-1), so every row of ws (N, L, w_dim), L = 2 (res_log2 - 1),
  is live and mixing and truncation work as for StyleGAN.
* ``alpha`` and ``fade`` are accepted and ignored (the preset trains at a
  fixed resolution), as in the JAX package. So are ``model.remat`` and
  the TPU layout knobs, which the JAX StyleGAN2 G does not read.

Explicit noise maps are (N, 1, H, W) in the order of :func:`noise_shapes`:
one 4x4 map, then two per resolution; the toRGB layers take none.

The synthesis runs channels-last from its constant to its image
(``ops.layout.to_channels_last``): every op of its path keeps its
input's layout, so cuDNN reads and writes the activations without a
transpose.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ganlab_tpu_torch.config import ModelConfig
from ganlab_tpu_torch.models.layers import (
    ConstInput,
    EqualDense,
    NoiseInjection,
)
from ganlab_tpu_torch.models.stylegan import StyleGenerator
from ganlab_tpu_torch.ops import leaky_relu, rounded, upsample_blur_2x
from ganlab_tpu_torch.ops.layout import to_channels_last
from ganlab_tpu_torch.ops.modulated import modulated_conv2d


def noise_shapes(res_log2: int) -> list:
    """(H, W) of each explicit noise map, in noise-layer order: one 4x4
    map (conv4), then two per resolution 8 .. 2^res_log2."""
    return [(4, 4)] + [
        (2 ** lg, 2 ** lg)
        for lg in range(3, res_log2 + 1) for _ in range(2)]


class ModulatedLayer(nn.Module):
    """Style affine -> modulated conv (+ demod) -> noise -> bias -> lrelu.

    Under demodulation the He gain folded into the weight cancels, so the
    layer's gain comes from the activation: LeakyReLU times sqrt(2). The
    toRGB path passes ``activate=False`` (no noise, no activation)."""

    def __init__(self, in_ch: int, features: int, w_dim: int,
                 kernel: int = 3, *, demodulate: bool = True,
                 activate: bool = True, gain: float = math.sqrt(2.0)):
        super().__init__()
        self.demodulate, self.activate, self.gain = demodulate, activate, gain
        self.affine = EqualDense(w_dim, in_ch, gain=1.0, bias_init=1.0)
        self.w = nn.Parameter(torch.randn(features, in_ch, kernel, kernel))
        if activate:
            self.noise = NoiseInjection(features)
        self.b = nn.Parameter(torch.zeros(features))

    def forward(self, x, w_vec, noise=None, generator=None):
        s = self.affine(w_vec)
        y = modulated_conv2d(x, self.w.to(x.dtype), s,
                             demodulate=self.demodulate, gain=self.gain)
        if self.activate:
            y = self.noise(y, noise, generator)
        y = y + self.b.to(y.dtype)[None, :, None, None]
        if self.activate:
            return leaky_relu(y) * rounded(math.sqrt(2.0), y.dtype)
        return y


class ToRGB(nn.Module):
    """Modulated 1x1 conv to image channels, no demodulation."""

    def __init__(self, in_ch: int, w_dim: int, img_channels: int = 3):
        super().__init__()
        self.conv = ModulatedLayer(in_ch, img_channels, w_dim, kernel=1,
                                   demodulate=False, activate=False,
                                   gain=1.0)

    def forward(self, x, w_vec):
        return self.conv(x, w_vec)


class Synthesis2Block(nn.Module):
    """up(+blur) -> two modulated layers (one resolution of the skip G)."""

    def __init__(self, in_ch: int, features: int, w_dim: int):
        super().__init__()
        self.conv0 = ModulatedLayer(in_ch, features, w_dim)
        self.conv1 = ModulatedLayer(features, features, w_dim)

    def forward(self, x, w_a, w_b, noise_a=None, noise_b=None,
                generator=None):
        x = upsample_blur_2x(x)
        x = self.conv0(x, w_a, noise_a, generator)
        return self.conv1(x, w_b, noise_b, generator)


class Synthesis2Network(nn.Module):
    """Skip-architecture synthesis g(ws): per-resolution toRGB, upsampled
    accumulation."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.max_log2 = cfg.res_log2
        w_dim = cfg.latent_dim
        self.const = ConstInput(cfg.nf(1))
        self.conv4 = ModulatedLayer(cfg.nf(1), cfg.nf(1), w_dim)
        for lg in range(3, self.max_log2 + 1):
            self.add_module(f"block{2 ** lg}", Synthesis2Block(
                cfg.nf(lg - 2), cfg.nf(lg - 1), w_dim))
        for lg in range(2, self.max_log2 + 1):
            self.add_module(f"torgb{2 ** lg}", ToRGB(
                cfg.nf(lg - 1), w_dim, cfg.img_channels))

    def forward(self, ws: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0,
                noises: Sequence[torch.Tensor] | None = None,
                generator: torch.Generator | None = None,
                fade: bool | None = None) -> torch.Tensor:
        """ws (N, L, w_dim) -> images (N, C, 2^lg, 2^lg) in ws's dtype.
        ``noises``: explicit maps (:func:`noise_shapes`); None draws fresh
        noise from ``generator`` (or torch's default generator)."""
        del alpha, fade
        lg = self.max_log2 if res_log2 is None else res_log2
        if not 2 <= lg <= self.max_log2:
            raise ValueError(f"res_log2 {lg} outside [2, {self.max_log2}]")

        def nz(i):
            return None if noises is None else noises[i]

        x = to_channels_last(self.const(ws.shape[0], ws.dtype))
        x = self.conv4(x, ws[:, 0], nz(0), generator)
        rgb = self.torgb4(x, ws[:, 1])
        for i in range(lg - 2):
            res = 2 ** (i + 3)
            x = getattr(self, f"block{res}")(
                x, ws[:, 2 * i + 1], ws[:, 2 * i + 2], nz(2 * i + 1),
                nz(2 * i + 2), generator)
            rgb = upsample_blur_2x(rgb) + \
                getattr(self, f"torgb{res}")(x, ws[:, 2 * i + 3])
        return rgb


class StyleGAN2Generator(StyleGenerator):
    """Mapping + skip synthesis, with StyleGenerator's surface
    (``map_latents``, ``synthesize``, mixing through ``z2`` and
    ``crossover``)."""

    @staticmethod
    def make_synthesis(cfg: ModelConfig, blur: bool) -> nn.Module:
        return Synthesis2Network(cfg)

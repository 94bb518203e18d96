"""Equalized-LR building-block layers (torch.nn), NCHW / OIHW.

Port of ``ganlab_tpu/models/layers.py`` with the same parameter names and
init rules, so a flax parameter tree converts one to one
(``ganlab_tpu_torch.convert``):

* weights N(0, 1/lr_mult), rescaled at call time (equalized LR);
* biases 0, except the AdaIN scale head's, which starts at 1;
* noise scales 0; the learned constant input 1.

Parameters stay float32 and are cast to the activation dtype at use.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ganlab_tpu_torch.ops import equalized as eq
from ganlab_tpu_torch.ops import folded as fd
from ganlab_tpu_torch.ops.layout import is_channels_last


def _scaled_normal(shape, lr_mult: float) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) / lr_mult)


class EqualDense(nn.Module):
    """Equalized-LR fully connected layer; ``w`` is (in, out)."""

    def __init__(self, in_features: int, features: int, *,
                 gain: float = math.sqrt(2.0), lr_mult: float = 1.0,
                 use_bias: bool = True, bias_init: float = 0.0):
        super().__init__()
        self.gain, self.lr_mult = gain, lr_mult
        self.w = _scaled_normal((in_features, features), lr_mult)
        self.b = nn.Parameter(torch.full((features,), float(bias_init))) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return eq.equalized_dense(
            x, self.w.to(x.dtype),
            None if self.b is None else self.b.to(x.dtype),
            gain=self.gain, lr_mult=self.lr_mult)


def up2_form(fused_up) -> str | None:
    """The composed form ``model.fused_up_conv`` selects: None (the two-op
    upsample then conv) when it is false, the string itself, or
    ``'dilated'`` for any other true value, as the JAX package reads it."""
    if not fused_up:
        return None
    return fused_up if isinstance(fused_up, str) else "dilated"


class EqualConv(nn.Module):
    """Equalized-LR stride-1 SAME conv; ``w`` is (out, in, k, k).

    ``up2`` composes a preceding 2x upsample into this conv as one
    convolution (``ops.equalized_conv2d_up2``): ``"nearest"`` for the
    ProGAN G, ``"blur"`` for StyleGAN's nearest + FIR; ``up2_form`` is
    ``'dilated'``, ``'poly'`` or ``'hybrid'``. Exact to the two-op form;
    the weight stays the ordinary (out, in, k, k) tensor, so parameters
    and checkpoints are those of the unfused conv.

    ``fold``: the input is width-folded (``ops.folded``) and so is the
    output; ``in_ch`` and the weight stay logical. Never with ``up2``.
    """

    def __init__(self, in_ch: int, features: int, kernel: int = 3, *,
                 gain: float = math.sqrt(2.0), lr_mult: float = 1.0,
                 use_bias: bool = True, up2: str | None = None,
                 up2_form: str = "dilated", fold: bool = False):
        super().__init__()
        if up2 == "nearest" and up2_form == "hybrid":
            raise ValueError(eq.HYBRID_NEAREST)
        if fold and up2 is not None:
            raise ValueError("EqualConv: fold with up2")
        self.gain, self.lr_mult = gain, lr_mult
        self.up2, self.up2_form, self.fold = up2, up2_form, fold
        self.w = _scaled_normal((features, in_ch, kernel, kernel), lr_mult)
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w.to(x.dtype)
        b = None if self.b is None else self.b.to(x.dtype)
        if self.fold:
            return eq.equalized_conv2d_folded(x, w, b, gain=self.gain,
                                              lr_mult=self.lr_mult)
        if self.up2 is not None:
            return eq.equalized_conv2d_up2(
                x, w, b, taps=None if self.up2 == "nearest" else
                (1.0, 2.0, 1.0), form=self.up2_form, gain=self.gain,
                lr_mult=self.lr_mult)
        return eq.equalized_conv2d(x, w, b, gain=self.gain,
                                   lr_mult=self.lr_mult)


class NoiseInjection(nn.Module):
    """StyleGAN per-layer noise: x + scale_c * noise (scale starts at 0).

    The noise image is single-channel (N, 1, H, W), broadcast over
    channels: either given explicitly or drawn from ``generator``.
    ``fold``: x is width-folded (``ops.folded``); the noise image is the
    logical one all the same, drawn in that shape and folded, so fold on
    and off add the same noise.
    """

    def __init__(self, channels: int, fold: bool = False):
        super().__init__()
        self.fold = fold
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if noise is None:
            n, _, h, w = x.shape
            noise = torch.randn((n, 1, h, w * fd.FOLD if self.fold else w),
                                generator=generator, device=x.device,
                                dtype=x.dtype)
        if self.fold:
            return fd.noise_folded(x, self.scale, noise)
        scale = self.scale.to(x.dtype)
        if is_channels_last(x):
            # the same products, laid out (N, H, W, C): channels-last
            return x + (noise.to(x.dtype).permute(0, 2, 3, 1) * scale) \
                .permute(0, 3, 1, 2)
        return x + scale[None, :, None, None] * noise.to(x.dtype)


class StyleAffine(nn.Module):
    """The learned affine "A": w -> (y_scale, y_bias) for AdaIN."""

    def __init__(self, w_dim: int, channels: int):
        super().__init__()
        self.scale = EqualDense(w_dim, channels, gain=1.0, bias_init=1.0)
        self.bias = EqualDense(w_dim, channels, gain=1.0)

    def forward(self, w: torch.Tensor):
        return self.scale(w), self.bias(w)


class ConstInput(nn.Module):
    """StyleGAN's learned constant input, (1, C, size, size)."""

    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.const = nn.Parameter(torch.ones(1, channels, size, size))

    def forward(self, batch: int, dtype: torch.dtype) -> torch.Tensor:
        return self.const.to(dtype).expand(batch, -1, -1, -1)

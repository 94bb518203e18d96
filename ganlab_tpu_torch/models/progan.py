"""ProGAN discriminator (Karras et al. 2017), NCHW.

Port of the discriminator half of ``ganlab_tpu/models/progan.py`` with the
flax parameter names, so ``convert.from_flax`` maps one tree onto the
other: ``fromrgb{R}`` (1x1 conv per resolution R), ``block{R}.conv0`` /
``block{R}.conv1`` (R = 8 .. resolution) and ``block4_out.conv`` /
``.dense`` / ``.score``. Every resolution's head and block exists up front;
the current resolution is a call argument, and a fade phase blends in the
previous head on an average-pooled image with weight ``alpha`` (the fade
branch; ``fade=`` says whether it runs, else it is skipped exactly when
``alpha`` is the Python constant 1.0).

``blur_resample=True`` is StyleGAN's variant: each block ends in the fused
[1,2,1] blur + 2x downsample (``ops.blur_downsample_2x``) instead of the
2x2 average pool. The output block's flatten runs over NHWC order (h, w,
c), as the JAX package's reshape does, so the dense weight converts as it
is. ``model.remat`` recomputes each block's activations in the backward
pass (``torch.utils.checkpoint``; R1's double backward passes through
it), as the JAX package wraps ``DBlock`` in ``nn.remat``. The JAX
package's TPU knob ``fold_width`` and the ResNet variant ``d_resnet`` are
rejected.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ganlab_tpu_torch.config import ModelConfig
from ganlab_tpu_torch.models.layers import EqualConv, EqualDense
from ganlab_tpu_torch.ops import (
    blur_downsample_2x,
    downsample_avg_2x,
    fade_in,
    leaky_relu,
    minibatch_stddev,
)


def static_stable(alpha) -> bool:
    """True when alpha is the Python constant 1.0: the fade branch is dead
    and skipped."""
    return isinstance(alpha, (int, float)) and float(alpha) == 1.0


def takes_fade_branch(alpha, fade: bool | None) -> bool:
    """Whether a forward blends in the previous resolution's head. A
    training step says so (``fade`` = the phase is a fade phase, whatever
    alpha's value: ``old + 1.0 * (new - old)`` is not ``new`` bit for
    bit); with ``fade=None`` the branch is skipped exactly when alpha is
    the Python constant 1.0."""
    return not static_stable(alpha) if fade is None else bool(fade)


class DBlock(nn.Module):
    """One discriminator block: 2x (conv3x3 + lrelu) -> downsample."""

    def __init__(self, in_ch: int, features_in: int, features_out: int,
                 blur: bool = False):
        super().__init__()
        self.blur = blur
        self.conv0 = EqualConv(in_ch, features_in, 3)
        self.conv1 = EqualConv(features_in, features_out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv0(x))
        x = leaky_relu(self.conv1(x))
        return blur_downsample_2x(x) if self.blur else downsample_avg_2x(x)


class DOutputBlock(nn.Module):
    """Final 4x4 block: mbstd -> conv3x3 -> dense -> score."""

    def __init__(self, features: int, mbstd_group_size: int | None = None):
        super().__init__()
        self.mbstd_group_size = mbstd_group_size
        self.conv = EqualConv(features + 1, features, 3)
        self.dense = EqualDense(features * 16, features)
        self.score = EqualDense(features, 1, gain=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = minibatch_stddev(x, self.mbstd_group_size)
        x = leaky_relu(self.conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
        x = leaky_relu(self.dense(x))
        return self.score(x)[:, 0]


class ProDiscriminator(nn.Module):
    """Progressive discriminator; call with ``res_log2`` and ``alpha``."""

    def __init__(self, cfg: ModelConfig, blur_resample: bool = False):
        super().__init__()
        for knob in ("fold_width", "d_resnet"):
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"model.{knob} is not ported to PyTorch (fold_width is "
                    "a TPU knob of the JAX package; the ResNet D comes "
                    "with StyleGAN2, ROADMAP.md A.5)")
        self.remat = cfg.remat
        self.max_log2 = cfg.res_log2
        for lg in range(2, self.max_log2 + 1):
            self.add_module(f"fromrgb{2 ** lg}", EqualConv(
                cfg.img_channels, cfg.nf(lg - 1), 1))
        for lg in range(3, self.max_log2 + 1):
            self.add_module(f"block{2 ** lg}", DBlock(
                cfg.nf(lg - 1), cfg.nf(lg - 1), cfg.nf(lg - 2),
                blur=blur_resample))
        self.block4_out = DOutputBlock(cfg.nf(1), cfg.mbstd_group_size)

    def forward(self, img: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0, fade: bool | None = None
                ) -> torch.Tensor:
        """img (N, C, 2^lg, 2^lg) -> scores (N,) in img's dtype."""
        lg = self.max_log2 if res_log2 is None else res_log2
        if not 2 <= lg <= self.max_log2:
            raise ValueError(f"res_log2 {lg} outside [2, {self.max_log2}]")
        x = leaky_relu(getattr(self, f"fromrgb{2 ** lg}")(img))
        if lg > 2:
            x = self._block(lg, x)
            if takes_fade_branch(alpha, fade):
                img_lo = downsample_avg_2x(img)
                x_old = leaky_relu(
                    getattr(self, f"fromrgb{2 ** (lg - 1)}")(img_lo))
                x = fade_in(alpha, x, x_old)
            for lg2 in range(lg - 1, 2, -1):
                x = self._block(lg2, x)
        return self.block4_out(x)

    def _block(self, lg: int, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, f"block{2 ** lg}")
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False,
                              preserve_rng_state=False)
        return block(x)

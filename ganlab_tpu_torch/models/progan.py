"""ProGAN generator and discriminator (Karras et al. 2017), (N, C, H, W).

Port of ``ganlab_tpu/models/progan.py`` with the flax parameter names, so
``convert.from_flax`` maps one tree onto the other. Generator:
``block4.dense`` / ``block4.conv`` (the 4x4 input block), ``block{R}.conv0``
/ ``.conv1`` (R = 8 .. resolution) and ``torgb{R}``. Discriminator:
``fromrgb{R}`` (1x1 conv per resolution R), ``block{R}.conv0`` /
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
is. The generator normalizes z over its last axis and every feature map
over its channels (``pixel_norm(x, dim=1)``, where the JAX package takes
the last axis of NHWC); its input block's dense output is reshaped in the
JAX package's (h, w, c) order and then permuted to NCHW, the mirror of the
D's flatten, so the dense weight converts as it is too.

The discriminator runs channels-last from its input image to its 4x4
block (``ops.layout.to_channels_last``; every op of its path keeps its
input's layout, so cuDNN reads and writes the activations without a
transpose), and its gradient with respect to the image comes back in the
image's layout. The generator runs in the layout it is handed (NCHW).

``model.d_resnet`` gives the D residual blocks (StyleGAN2's ResNet D):
a skip branch of a 1x1 conv (no bias, gain 1) and the block's downsample
beside the main branch, the sum scaled by 1/sqrt(2).

``model.remat`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``; R1's and WGAN-GP's double backward passes
through it), as the JAX package wraps ``GBlock`` and ``DBlock`` in
``nn.remat``. ``model.fused_up_conv`` composes each G block's nearest
upsample into its first conv (``GBlock``). ``model.fold_width``
evaluates the blocks that ``cfg.fold_block`` selects width-folded
(``ops.folded``; in the D not the residual blocks, as in the JAX
package): the same parameters and values, the blocks' inputs and outputs
unfolded.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ganlab_tpu_torch.config import ModelConfig
from ganlab_tpu_torch.models.layers import EqualConv, EqualDense, up2_form
from ganlab_tpu_torch.ops import (
    blur_downsample_2x,
    downsample_avg_2x,
    fade_in,
    leaky_relu,
    minibatch_stddev,
    pixel_norm,
    rounded,
    upsample_nearest_2x,
)
from ganlab_tpu_torch.ops import folded as fd
from ganlab_tpu_torch.ops.layout import (
    as_layout,
    is_channels_last,
    to_channels_last,
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


def _checkpointed(block: nn.Module, x: torch.Tensor, remat: bool):
    """``block(x)``, its activations recomputed in the backward when
    ``remat`` (and autograd records)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False,
                          preserve_rng_state=False)
    return block(x)


class GBlock(nn.Module):
    """One generator block: nearest 2x up -> 2x (conv3x3 + lrelu + PN).

    ``fused_up`` (``model.fused_up_conv``) composes the nearest upsample
    into conv0: True is the dilated form, ``'poly'`` the polyphase one;
    ``'hybrid'`` has no nearest variant and raises ``ValueError``.
    ``fold`` evaluates the block width-folded (``ops.folded``; before
    ``fused_up``, which it then ignores, as in the JAX package)."""

    def __init__(self, in_ch: int, features: int,
                 fused_up: bool | str = False, fold: bool = False):
        super().__init__()
        self.fold = fold
        form = None if fold else up2_form(fused_up)
        self.fused = form is not None
        self.conv0 = EqualConv(in_ch, features, 3,
                               up2="nearest" if self.fused else None,
                               up2_form=form or "dilated", fold=fold)
        self.conv1 = EqualConv(features, features, 3, fold=fold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold:
            x = self.conv0(fd.upsample_blur_2x_folded(x, blur=False))
            x = fd.pixel_norm_folded(fd.leaky_relu_folded(x))
            x = fd.pixel_norm_folded(fd.leaky_relu_folded(self.conv1(x)))
            return fd.unfold_w(x)
        x = self.conv0(x if self.fused else upsample_nearest_2x(x))
        x = pixel_norm(leaky_relu(x), dim=1)
        return pixel_norm(leaky_relu(self.conv1(x)), dim=1)


class GInputBlock(nn.Module):
    """4x4 input block: PN(z) -> dense(4*4*nf) -> PN -> conv3x3 -> PN."""

    def __init__(self, latent_dim: int, features: int):
        super().__init__()
        self.features = features
        self.dense = EqualDense(latent_dim, features * 16,
                                gain=math.sqrt(2.0) / 4.0)
        self.conv = EqualConv(features, features, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dense(pixel_norm(z))
        # (h, w, c) order as the JAX reshape, then NCHW
        x = x.reshape(x.shape[0], 4, 4, self.features) \
            .permute(0, 3, 1, 2).contiguous()
        x = pixel_norm(leaky_relu(x), dim=1)
        return pixel_norm(leaky_relu(self.conv(x)), dim=1)


class ProGenerator(nn.Module):
    """Progressive generator: ``g(z, res_log2, alpha)`` -> (N, C, 2^lg,
    2^lg) images in z's dtype (no output activation, as in the JAX
    package). A fade phase blends in the previous resolution's toRGB,
    upsampled nearest 2x, with weight ``alpha`` (``fade``: as in
    ``ProDiscriminator.forward``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.remat = cfg.remat
        self.max_log2 = cfg.res_log2
        self.block4 = GInputBlock(cfg.latent_dim, cfg.nf(1))
        for lg in range(3, self.max_log2 + 1):
            self.add_module(f"block{2 ** lg}",
                            GBlock(cfg.nf(lg - 2), cfg.nf(lg - 1),
                                   cfg.fused_up_conv, cfg.fold_block(lg)))
        for lg in range(2, self.max_log2 + 1):
            self.add_module(f"torgb{2 ** lg}", EqualConv(
                cfg.nf(lg - 1), cfg.img_channels, 1, gain=1.0))

    def forward(self, z: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0, fade: bool | None = None
                ) -> torch.Tensor:
        lg = self.max_log2 if res_log2 is None else res_log2
        if not 2 <= lg <= self.max_log2:
            raise ValueError(f"res_log2 {lg} outside [2, {self.max_log2}]")
        x = self.block4(z)
        if lg == 2:
            return self.torgb4(x)
        prev = x
        for stage in range(3, lg + 1):
            prev = x
            x = _checkpointed(getattr(self, f"block{2 ** stage}"), x,
                              self.remat)
        new_rgb = getattr(self, f"torgb{2 ** lg}")(x)
        if not takes_fade_branch(alpha, fade):
            return new_rgb
        old_rgb = upsample_nearest_2x(
            getattr(self, f"torgb{2 ** (lg - 1)}")(prev))
        return fade_in(alpha, new_rgb, old_rgb)


class DBlock(nn.Module):
    """One discriminator block: 2x (conv3x3 + lrelu) -> downsample.

    ``resnet``: plus a skip branch, 1x1 conv (no bias, gain 1) ->
    downsample, and the sum of the two branches times 1/sqrt(2).

    ``fold``: evaluated width-folded (``ops.folded``): folded on entry,
    and the downsample lands back on the unfolded width. The residual
    block has no folded form and raises the JAX package's
    ``AssertionError``."""

    def __init__(self, in_ch: int, features_in: int, features_out: int,
                 blur: bool = False, resnet: bool = False,
                 fold: bool = False):
        super().__init__()
        if resnet and fold:
            raise AssertionError("resnet DBlock does not implement fold")
        self.blur, self.resnet, self.fold = blur, resnet, fold
        if resnet:
            self.skip = EqualConv(in_ch, features_out, 1, gain=1.0,
                                  use_bias=False)
        self.conv0 = EqualConv(in_ch, features_in, 3, fold=fold)
        self.conv1 = EqualConv(features_in, features_out, 3, fold=fold)

    def _down(self, x: torch.Tensor) -> torch.Tensor:
        return blur_downsample_2x(x) if self.blur else downsample_avg_2x(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold:
            # the folded views assume NCHW memory
            x = fd.leaky_relu_folded(self.conv0(fd.fold_w(x.contiguous())))
            x = fd.leaky_relu_folded(self.conv1(x))
            return fd.blur_downsample_2x_folded(x, blur=self.blur)
        skip = self._down(self.skip(x)) if self.resnet else None
        x = leaky_relu(self.conv0(x))
        x = self._down(leaky_relu(self.conv1(x)))
        if skip is None:
            return x
        return (x + skip) * rounded(1.0 / math.sqrt(2.0), x.dtype)


class DOutputBlock(nn.Module):
    """Final 4x4 block: mbstd -> conv3x3 -> dense -> score."""

    def __init__(self, features: int, mbstd_group_size: int | None = None):
        super().__init__()
        self.mbstd_group_size = mbstd_group_size
        self.conv = EqualConv(features + 1, features, 3)
        self.dense = EqualDense(features * 16, features)
        self.score = EqualDense(features, 1, gain=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # mbstd runs NCHW; its result goes back to x's layout (channels-
        # last: the flatten below is then a view)
        x = as_layout(minibatch_stddev(x, self.mbstd_group_size),
                      is_channels_last(x))
        x = leaky_relu(self.conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
        x = leaky_relu(self.dense(x))
        return self.score(x)[:, 0]


class ProDiscriminator(nn.Module):
    """Progressive discriminator; call with ``res_log2`` and ``alpha``."""

    def __init__(self, cfg: ModelConfig, blur_resample: bool = False):
        super().__init__()
        self.remat = cfg.remat
        self.max_log2 = cfg.res_log2
        for lg in range(2, self.max_log2 + 1):
            self.add_module(f"fromrgb{2 ** lg}", EqualConv(
                cfg.img_channels, cfg.nf(lg - 1), 1))
        for lg in range(3, self.max_log2 + 1):
            self.add_module(f"block{2 ** lg}", DBlock(
                cfg.nf(lg - 1), cfg.nf(lg - 1), cfg.nf(lg - 2),
                blur=blur_resample, resnet=cfg.d_resnet,
                fold=cfg.fold_block(lg) and not cfg.d_resnet))
        self.block4_out = DOutputBlock(cfg.nf(1), cfg.mbstd_group_size)

    def forward(self, img: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0, fade: bool | None = None
                ) -> torch.Tensor:
        """img (N, C, 2^lg, 2^lg) -> scores (N,) in img's dtype."""
        lg = self.max_log2 if res_log2 is None else res_log2
        if not 2 <= lg <= self.max_log2:
            raise ValueError(f"res_log2 {lg} outside [2, {self.max_log2}]")
        img = to_channels_last(img)
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
        return _checkpointed(getattr(self, f"block{2 ** lg}"), x, self.remat)

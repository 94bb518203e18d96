"""StyleGAN generator (Karras et al. 2018), NCHW.

Port of the generator half of ``ganlab_tpu/models/stylegan.py`` with the
same module and parameter names:

* ``MappingNetwork``: pixelnorm(z) -> ``mapping_layers`` equalized FC +
  LeakyReLU layers at lr_mult ``mapping_lr_mult`` -> w.
* ``SynthesisNetwork``: learned constant 4x4 input; per style layer noise
  injection, bias, LeakyReLU and AdaIN; two style layers per resolution;
  each block from 8x8 up starts with the fused nearest-2x + blur upsample.
* ``truncate_ws`` / ``mix_styles`` act on the per-layer ws (N, L, w_dim).

``model.remat`` recomputes each resolution block's activations in the
backward pass (``torch.utils.checkpoint``, as the JAX package wraps the
blocks in ``nn.remat``): same values and gradients, less memory. The JAX
package's TPU-only knobs ``fold_width`` and ``fused_up_conv`` are
rejected. Explicit noise maps are (N, 1, H, W), one per style layer in the
order of :func:`noise_shapes`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ganlab_tpu_torch.config import ModelConfig
from ganlab_tpu_torch.models.layers import (
    ConstInput,
    EqualConv,
    EqualDense,
    NoiseInjection,
    StyleAffine,
)
from ganlab_tpu_torch.models.progan import takes_fade_branch
from ganlab_tpu_torch.ops import (
    adain,
    fade_in,
    leaky_relu,
    pixel_norm,
    upsample_blur_2x,
    upsample_nearest_2x,
)


def num_style_layers(res_log2: int) -> int:
    """Two AdaIN layers per resolution from 4x4 up: L = 2*(res_log2 - 1)."""
    return 2 * (res_log2 - 1)


def noise_shapes(res_log2: int) -> list:
    """(H, W) of each explicit noise map, in style-layer index order:
    two 4x4 maps, then two maps per resolution 8..2^res_log2."""
    return [(4, 4), (4, 4)] + [
        (2 ** lg, 2 ** lg)
        for lg in range(3, res_log2 + 1) for _ in range(2)]


class MappingNetwork(nn.Module):
    """Z -> W: pixelnorm then equalized FC + LeakyReLU layers."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_layers = cfg.mapping_layers
        for i in range(cfg.mapping_layers):
            self.add_module(f"fc{i}", EqualDense(
                cfg.latent_dim, cfg.latent_dim, lr_mult=cfg.mapping_lr_mult))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(z)
        for i in range(self.num_layers):
            x = leaky_relu(getattr(self, f"fc{i}")(x))
        return x


class StyleLayer(nn.Module):
    """Noise -> bias -> LeakyReLU -> AdaIN, after a bias-free conv."""

    def __init__(self, channels: int, w_dim: int):
        super().__init__()
        self.noise = NoiseInjection(channels)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.style = StyleAffine(w_dim, channels)

    def forward(self, x, w, noise=None, generator=None):
        x = self.noise(x, noise, generator)
        x = leaky_relu(x + self.bias.to(x.dtype)[None, :, None, None])
        ys, yb = self.style(w)
        return adain(x, ys.to(x.dtype), yb.to(x.dtype))


class SynthesisBlock(nn.Module):
    """One synthesis resolution block: up(+blur) -> conv/epilogue x2."""

    def __init__(self, in_ch: int, features: int, w_dim: int,
                 blur: bool = True):
        super().__init__()
        self.blur = blur
        self.conv0 = EqualConv(in_ch, features, 3, use_bias=False)
        self.style0 = StyleLayer(features, w_dim)
        self.conv1 = EqualConv(features, features, 3, use_bias=False)
        self.style1 = StyleLayer(features, w_dim)

    def forward(self, x, w_a, w_b, noise_a=None, noise_b=None,
                generator=None):
        x = upsample_blur_2x(x) if self.blur else upsample_nearest_2x(x)
        x = self.conv0(x)
        x = self.style0(x, w_a, noise_a, generator)
        x = self.conv1(x)
        return self.style1(x, w_b, noise_b, generator)


def _remat_block(block: SynthesisBlock, x, w_a, w_b, noise_a, noise_b,
                 generator):
    """``block(x, ...)`` with its activations recomputed in the backward.

    The recompute must see the noise of the forward: checkpoint restores
    torch's global generators, not an explicit one, so the block's two
    noise maps are drawn here, before the checkpointed call, with the
    calls and in the order ``NoiseInjection`` would make them. Gradients
    are then bit-equal to those without remat, and the generator advances
    as it would without it. Nothing inside draws from a global generator,
    so its state is not saved."""
    n, _, h, w = x.shape
    noises = []
    for given in (noise_a, noise_b):
        noises.append(given if given is not None else torch.randn(
            (n, 1, 2 * h, 2 * w), generator=generator, device=x.device,
            dtype=x.dtype))
    return checkpoint(block, x, w_a, w_b, *noises, use_reentrant=False,
                      preserve_rng_state=False)


class SynthesisNetwork(nn.Module):
    """The style-based synthesis network g(ws)."""

    def __init__(self, cfg: ModelConfig, blur: bool = True):
        super().__init__()
        for knob in ("fold_width", "fused_up_conv"):
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"model.{knob} is a TPU-only knob of the JAX package; "
                    "the PyTorch port does not implement it")
        self.remat = cfg.remat
        self.max_log2 = cfg.res_log2
        w_dim = cfg.latent_dim
        self.const = ConstInput(cfg.nf(1))
        self.conv4 = EqualConv(cfg.nf(1), cfg.nf(1), 3, use_bias=False)
        self.style4_0 = StyleLayer(cfg.nf(1), w_dim)
        self.style4_1 = StyleLayer(cfg.nf(1), w_dim)
        for lg in range(3, self.max_log2 + 1):
            self.add_module(f"block{2 ** lg}", SynthesisBlock(
                cfg.nf(lg - 2), cfg.nf(lg - 1), w_dim, blur=blur))
        for lg in range(2, self.max_log2 + 1):
            self.add_module(f"torgb{2 ** lg}", EqualConv(
                cfg.nf(lg - 1), cfg.img_channels, 1, gain=1.0))

    def forward(self, ws: torch.Tensor, res_log2: int | None = None,
                alpha: float = 1.0,
                noises: Sequence[torch.Tensor] | None = None,
                generator: torch.Generator | None = None,
                fade: bool | None = None) -> torch.Tensor:
        """ws (N, L, w_dim) -> images (N, C, 2^lg, 2^lg) in ws's dtype.

        ``noises``: explicit per-style-layer noise maps; None draws fresh
        noise from ``generator`` (or torch's default generator). ``fade``:
        whether the previous resolution's toRGB is blended in with weight
        ``alpha`` (None: unless alpha is the Python constant 1.0)."""
        lg = self.max_log2 if res_log2 is None else res_log2
        if not 2 <= lg <= self.max_log2:
            raise ValueError(f"res_log2 {lg} outside [2, {self.max_log2}]")

        def nz(i):
            return None if noises is None else noises[i]

        x = self.const(ws.shape[0], ws.dtype)
        x = self.style4_0(x, ws[:, 0], nz(0), generator)
        x = self.conv4(x)
        x = self.style4_1(x, ws[:, 1], nz(1), generator)
        if lg == 2:
            return self.torgb4(x)
        prev = x
        for i in range(lg - 2):
            prev = x
            block = getattr(self, f"block{2 ** (i + 3)}")
            args = (x, ws[:, 2 * i + 2], ws[:, 2 * i + 3],
                    nz(2 * i + 2), nz(2 * i + 3))
            if self.remat and torch.is_grad_enabled():
                x = _remat_block(block, *args, generator)
            else:
                x = block(*args, generator)
        new_rgb = getattr(self, f"torgb{2 ** lg}")(x)
        if not takes_fade_branch(alpha, fade):
            return new_rgb  # stabilize phase: the fade branch is dead
        old_rgb = upsample_nearest_2x(
            getattr(self, f"torgb{2 ** (lg - 1)}")(prev))
        return fade_in(alpha, new_rgb, old_rgb)


def mix_styles(w1: torch.Tensor, w2: torch.Tensor, crossover,
               num_layers: int) -> torch.Tensor:
    """Per-layer ws: layers < crossover take w1, the rest w2.

    ``crossover`` is an int or an (N,) tensor; ``num_layers`` disables
    mixing."""
    idx = torch.arange(num_layers, device=w1.device)[None, :, None]
    cross = torch.as_tensor(crossover, device=w1.device)
    cross = cross.reshape(-1, 1, 1)
    return torch.where(idx < cross, w1[:, None, :], w2[:, None, :])


def truncate_ws(ws: torch.Tensor, w_avg: torch.Tensor, psi: float,
                cutoff: int) -> torch.Tensor:
    """Truncation trick: w <- w_avg + psi*(w - w_avg) for layers < cutoff."""
    idx = torch.arange(ws.shape[1], device=ws.device)[None, :, None]
    psi_per_layer = torch.where(
        idx < cutoff,
        torch.tensor(psi, dtype=ws.dtype, device=ws.device),
        torch.tensor(1.0, dtype=ws.dtype, device=ws.device))
    return w_avg[None, None, :] + psi_per_layer * (ws - w_avg[None, None, :])


class StyleGenerator(nn.Module):
    """Mapping + synthesis, with style-mixing plumbing."""

    def __init__(self, cfg: ModelConfig, blur: bool = True):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg)
        self.synthesis = SynthesisNetwork(cfg, blur=blur)

    def map_latents(self, z: torch.Tensor) -> torch.Tensor:
        return self.mapping(z)

    def synthesize(self, ws, res_log2=None, alpha=1.0, noises=None,
                   generator=None, fade=None):
        return self.synthesis(ws, res_log2, alpha, noises, generator, fade)

    def forward(self, z, res_log2=None, alpha=1.0, z2=None, crossover=None,
                generator=None):
        lg = self.cfg.res_log2 if res_log2 is None else res_log2
        nl = num_style_layers(lg)
        w1 = self.mapping(z)
        if z2 is None:
            ws = w1[:, None, :].expand(-1, nl, -1)
        else:
            cross = nl if crossover is None else crossover
            ws = mix_styles(w1, self.mapping(z2), cross, nl)
        return self.synthesis(ws, lg, alpha, generator=generator)

"""Latent-space projection: invert images into the generator's latent space.

Port of ``ganlab_tpu/utils/projector.py`` (the official StyleGAN2
``projector.py`` surface, Karras et al. 2020, app. D) on NCHW tensors. A pool
of ``num_candidates`` latents is scored against each target with one batched
forward, the best ``num_restarts`` per target are optimized together with
Adam (0.9, 0.999, eps 1e-8) under the official LR curve (linear ramp-up,
cosine ramp-down) with decaying exploration noise added to the latents, and
the restart with the lowest final MSE is kept. The style families
(StyleGAN, StyleGAN2) project in W (one shared w) or W+ (a w per style
layer), from the tracked ``w_avg`` and mapped pool latents, and may also
optimize the per-layer noise maps (``optimize_noise``, regularized and
renormalized each step); ProGAN and ResNet-GAN optimize z. The loss is a
pyramid of MSEs over 2x2 box-downsampled octaves, which needs no weights;
``loss_fn`` takes any differentiable image distance.

The JAX package runs the whole loop as one ``lax.scan``; here it is a Python
loop of ``num_steps`` steps. As there, the learning rate of step t is the
schedule at t (optax reads its count before incrementing it), so step 0's
is 0 and the first update moves nothing, and the images come back
unclipped.

Every random input is a ``ProjectionDraws``: drawn from ``seed`` by
default, or injected (the parity tests feed the JAX package's own
``jax.random`` draws). The synthesis noise of the style families is fixed
for the run, one set for the pool's batch and one for the restarts', as the
JAX package's single ``noise_key`` makes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ganlab_tpu_torch.config import Config
from ganlab_tpu_torch.models import is_style, noise_shapes
from ganlab_tpu_torch.models.stylegan import num_style_layers


@dataclasses.dataclass
class ProjectionResult:
    latents: torch.Tensor  # (B, L, D) ws for style families, (B, D) z else
    images: torch.Tensor   # (B, C, H, W) float32, final synthesis, unclipped
    losses: torch.Tensor   # (num_steps,) float32 loss trajectory
    is_w_space: bool
    noises: list | None = None  # optimized (B, 1, H, W) maps (optimize_noise)


@dataclasses.dataclass
class ProjectionDraws:
    """The random inputs of one projection (P = pool, N = restarts x
    targets)."""

    pool_z: torch.Tensor        # style: (max(256, P - 1), D), mapped for the
                                # pool and the latents' spread; else (P - 1,
                                # D) beside a zero z
    step_noise: torch.Tensor    # (num_steps, N, *latent shape): each step's
                                # exploration noise, unscaled N(0, 1)
    pool_noises: list = dataclasses.field(default_factory=list)  # style:
                                # (P, 1, H, W) a noise layer, pool scoring
    noises: list = dataclasses.field(default_factory=list)  # style: (N, 1,
                                # H, W) a layer, every step's synthesis
    init_noises: list = dataclasses.field(default_factory=list)  # with
                                # optimize_noise: (N, 1, H, W) starting maps


def pyramid_loss(img: torch.Tensor, target: torch.Tensor,
                 levels: int = 4) -> torch.Tensor:
    """MSE summed over ``levels`` 2x2-box-downsampled octaves (NCHW)."""
    loss = (img - target).square().mean()
    for _ in range(levels):
        b, c, h, w = img.shape
        if h < 8 or h % 2 or w % 2:
            break
        img = img.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
        target = target.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
        loss = loss + (img - target).square().mean()
    return loss


def noise_regularizer(noises) -> torch.Tensor:
    """The official StyleGAN2 projector's noise regularizer: for every noise
    map (N, 1, H, W), the squared mean of its product with its own 1-pixel
    roll along x and along y, summed over a 2x-downsampled pyramid down to
    8x8. Zero in expectation for white noise."""
    reg = torch.zeros(())
    for n in noises:
        n = n.float()
        while True:
            reg = reg + (n * torch.roll(n, 1, dims=3)).mean().square() \
                + (n * torch.roll(n, 1, dims=2)).mean().square()
            b, c, h, w = n.shape
            if h <= 8 or h % 2 or w % 2:
                break
            n = n.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
    return reg


def _normalize_noises(noises) -> list:
    """Zero mean and unit standard deviation per map (the official per-step
    renormalization)."""
    out = []
    for n in noises:
        mu = n.mean(dim=(1, 2, 3), keepdim=True)
        sd = torch.sqrt((n - mu).square().mean(dim=(1, 2, 3), keepdim=True)
                        + 1e-8)
        out.append((n - mu) / sd)
    return out


def _lr_schedule(base_lr: float, num_steps: int, rampup: float = 0.05,
                 rampdown: float = 0.25) -> Callable[[int], float]:
    """The official projector LR curve, linear warm-up and cosine ramp-down,
    in float32 as the JAX package evaluates it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step) / f32(num_steps)
        up = min(t / f32(rampup), f32(1.0))
        down = min((f32(1.0) - t) / f32(rampdown), f32(1.0))
        down = f32(0.5) - f32(0.5) * np.cos(down * f32(np.pi), dtype=f32)
        return float(f32(base_lr) * up * down)

    return schedule


def draw_projection(cfg: Config, res_log2: int, batch: int, *,
                    num_steps: int, num_restarts: int, num_candidates: int,
                    w_plus: bool, optimize_noise: bool,
                    generator: torch.Generator) -> ProjectionDraws:
    """Every random input of ``project``, from ``generator`` (on its
    device)."""
    dev = generator.device
    dim = cfg.model.latent_dim
    n_r = max(1, num_restarts)
    n_c, n = max(num_candidates, n_r), n_r * batch

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    if not is_style(cfg.model):
        return ProjectionDraws(pool_z=normal(n_c - 1, dim),
                               step_noise=normal(num_steps, n, dim))
    shapes = noise_shapes(cfg.model, res_log2)
    lat = (num_style_layers(res_log2) if w_plus else 1, dim)
    return ProjectionDraws(
        pool_z=normal(max(256, n_c - 1), dim),
        step_noise=normal(num_steps, n, *lat),
        pool_noises=[normal(n_c, 1, h, w) for h, w in shapes],
        noises=[normal(n, 1, h, w) for h, w in shapes],
        init_noises=[normal(n, 1, h, w) for h, w in shapes]
        if optimize_noise else [])


def project(cfg: Config, g: torch.nn.Module, w_avg: torch.Tensor,
            target: torch.Tensor, *, num_steps: int = 300, lr: float = 0.1,
            w_plus: bool = True, seed: int = 0, num_restarts: int = 8,
            num_candidates: int = 64, res_log2: int | None = None,
            alpha: float = 1.0, initial_noise_factor: float = 0.05,
            noise_ramp: float = 0.75, optimize_noise: bool = False,
            noise_weight: float = 10.0, loss_fn: Callable = pyramid_loss,
            draws: ProjectionDraws | None = None) -> ProjectionResult:
    """Invert ``target`` (B, C, H, W) images in [-1, 1] at the generator's
    output resolution into the latent space of ``g`` (normally the G-EMA),
    in float32 on ``g``'s device.

    ``w_avg``: the tracked W average (ignored by the z families).
    ``w_plus``: a w per style layer instead of one shared w. ``num_restarts``
    / ``num_candidates``: restarts per target, picked from a scored pool.
    ``initial_noise_factor`` / ``noise_ramp``: the exploration noise's scale
    and decay. ``optimize_noise``: also optimize the noise maps, regularized
    by ``noise_weight`` x ``noise_regularizer`` (style families only).
    ``draws``: the random inputs (default: ``draw_projection`` from
    ``seed``). Gradients reach only the latents and the noise maps, never
    ``g``'s parameters."""
    style = is_style(cfg.model)
    lg = cfg.model.res_log2 if res_log2 is None else res_log2
    dev = next(g.parameters()).device
    target = target.to(dev, torch.float32)
    batch = target.shape[0]
    n_r = max(1, num_restarts)
    n_c = max(num_candidates, n_r)
    if not style:
        optimize_noise = False        # the z families have no noise layers
    if optimize_noise and cfg.model.model == "stylegan" and any(
            cfg.model.fold_block(l) for l in range(3, lg + 1)):
        # the JAX package's folded blocks take no explicit noise maps
        raise AssertionError("explicit noise unsupported when folded")
    if draws is None:
        draws = draw_projection(
            cfg, lg, batch, num_steps=num_steps, num_restarts=n_r,
            num_candidates=n_c, w_plus=w_plus, optimize_noise=optimize_noise,
            generator=torch.Generator(device=dev).manual_seed(seed))
    nl = num_style_layers(lg) if style else 0

    def synthesize(lat, noises):
        if not style:
            return g(lat, lg, alpha).float()
        ws = lat if w_plus else lat.expand(-1, nl, -1)
        return g.synthesize(ws, lg, alpha, noises).float()

    def expand(flat):
        """(N, D) pool latents -> the optimized shape."""
        if not style:
            return flat
        return flat[:, None, :].repeat(1, nl if w_plus else 1, 1)

    with torch.no_grad():
        if style:
            w_samples = g.map_latents(draws.pool_z.to(dev)).float()
            center = w_avg.to(dev, torch.float32)
            lat_std = (w_samples - center[None]).square().mean().sqrt()
            pool = torch.cat([center[None], w_samples[:n_c - 1]])
        else:
            lat_std = torch.ones((), device=dev)
            z = draws.pool_z.to(dev)
            pool = torch.cat([torch.zeros_like(z[:1]), z])
        # (pool x target) mean squared errors through flattened products
        pf = synthesize(expand(pool), [n.to(dev) for n in draws.pool_noises]
                        or None).flatten(1)
        tf = target.flatten(1)
        n_pix = pf.shape[1]
        d2 = (pf.square().sum(1)[:, None] / n_pix - 2.0 * (pf @ tf.T) / n_pix
              + tf.square().sum(1)[None, :] / n_pix)
        top = torch.argsort(d2, dim=0)[:n_r]                  # (R, B)
        lat = expand(pool[top.reshape(-1)]).clone()           # (R*B, ...)
    noises = [n.to(dev) for n in draws.noises] or None
    nz = [n.to(dev).clone().requires_grad_(True)
          for n in draws.init_noises] if optimize_noise else []
    lat.requires_grad_(True)
    params = [lat, *nz]
    opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    schedule = _lr_schedule(lr, num_steps)
    target_r = target.repeat(n_r, 1, 1, 1)
    f32 = np.float32
    losses = []
    for t in range(num_steps):
        frac = f32(t) / f32(num_steps)
        decay = max(f32(0.0), f32(1.0) - frac / f32(noise_ramp)) ** 2
        scale = lat_std * initial_noise_factor * float(decay)
        noisy = lat + scale * draws.step_noise[t].to(dev)
        loss = loss_fn(synthesize(noisy, nz or noises), target_r)
        if optimize_noise:
            loss = loss + noise_weight * noise_regularizer(nz)
        grads = torch.autograd.grad(loss, params)
        for p, gr in zip(params, grads):
            p.grad = gr
        opt.param_groups[0]["lr"] = schedule(t)
        opt.step()
        if optimize_noise:
            with torch.no_grad():
                for n, renorm in zip(nz, _normalize_noises(nz)):
                    n.copy_(renorm)
        losses.append(loss.detach())
    with torch.no_grad():
        # the best restart per target by its final MSE (no exploration)
        images = synthesize(lat, nz or noises)
        mse = (images - target_r).square().flatten(1).mean(1)
        pick = mse.reshape(n_r, batch).argmin(dim=0)
        idx = pick * batch + torch.arange(batch, device=dev)
        lat_out = lat.detach()[idx]
        if style and not w_plus:
            lat_out = lat_out.expand(-1, nl, -1).clone()
        return ProjectionResult(
            latents=lat_out, images=images[idx],
            losses=torch.stack(losses) if losses else torch.zeros(0),
            is_w_space=style,
            noises=[n.detach()[idx] for n in nz] if optimize_noise else None)


def load_image(path: str, resolution: int) -> np.ndarray:
    """One image file -> (H, W, 3) float32 in [-1, 1] at ``resolution``:
    the centered square crop, resized with Lanczos."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    side = min(img.size)
    left = (img.size[0] - side) // 2
    top = (img.size[1] - side) // 2
    img = img.crop((left, top, left + side, top + side))
    img = img.resize((resolution, resolution), Image.LANCZOS)
    return np.asarray(img, np.float32) / 127.5 - 1.0

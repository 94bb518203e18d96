"""Latent sampling and interpolation (port of
``ganlab_tpu/utils/latents.py``: ``gen_latents``, ``lerp``, ``slerp``,
``interpolation_path``), and the index-stable latent streams of serving
(``stream_seed``, ``stream_latents``)."""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(*parts: int) -> int:
    """A 63-bit torch seed from non-negative integers, well mixed."""
    state = np.random.SeedSequence([int(p) for p in parts]) \
        .generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def stream_latents(n: int, dim: int, *, seed: int = 0,
                   start: int = 0) -> np.ndarray:
    """z_i for i in [start, start + n) of stream ``seed``, (n, dim)
    float32: each from its own CPU generator seeded ``stream_seed(seed,
    i)``, so z_i does not depend on how a request is split."""
    zs = [torch.randn(dim, generator=torch.Generator().manual_seed(
        stream_seed(seed, i))) for i in range(start, start + n)]
    return torch.stack(zs).numpy()


def gen_latents(generator: torch.Generator, batch: int, dim: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """z ~ N(0, I) of shape (batch, dim), drawn from ``generator`` on the
    generator's device. torch's streams are not JAX's: the same seed gives
    other latents than the JAX package's ``gen_latents``."""
    return torch.randn(batch, dim, generator=generator,
                       device=generator.device, dtype=dtype)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation: appropriate in W space (StyleGAN)."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    return a + t * (b - a)


def slerp(a: torch.Tensor, b: torch.Tensor, t,
          eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation — appropriate in Z space, where latents live
    near the radius-sqrt(dim) sphere of the Gaussian prior. ``t`` is a
    number or a tensor that broadcasts against (..., 1). Falls back to lerp
    when a and b are nearly parallel."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + eps)
    bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + eps)
    dot = torch.clamp((an * bn).sum(dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = so > eps
    w_a = torch.where(safe, torch.sin((1.0 - t) * omega) / (so + eps),
                      1.0 - t)
    w_b = torch.where(safe, torch.sin(t * omega) / (so + eps), t)
    return w_a * a + w_b * b


def interpolation_frames(anchors: torch.Tensor, steps_per: int, *,
                         spherical: bool = True) -> torch.Tensor:
    """A closed walk through ``anchors`` (K, dim): from each anchor to the
    next (the last back to the first) in ``steps_per`` frames at
    t = 0, 1/steps_per, ... -> (K * steps_per, dim), anchor by anchor."""
    nxt = torch.roll(anchors, -1, dims=0)
    interp = slerp if spherical else lerp
    ts = torch.arange(steps_per, dtype=torch.float32) / steps_per
    frames = torch.stack([interp(anchors, nxt, float(t)) for t in ts])
    return frames.transpose(0, 1).reshape(-1, anchors.shape[-1])


def interpolation_path(generator: torch.Generator, num_anchors: int,
                       steps_per: int, dim: int, *,
                       spherical: bool = True) -> torch.Tensor:
    """``num_anchors`` random z's from ``generator`` joined by
    ``steps_per`` interpolated frames each -> (num_anchors * steps_per,
    dim) (:func:`interpolation_frames`)."""
    return interpolation_frames(gen_latents(generator, num_anchors, dim),
                                steps_per, spherical=spherical)

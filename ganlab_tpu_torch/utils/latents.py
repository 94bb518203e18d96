"""Latent sampling and interpolation (port of
``ganlab_tpu/utils/latents.py``: ``gen_latents``, ``lerp``, ``slerp``,
``interpolation_path``)."""

from __future__ import annotations

import torch


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


def slerp(a: torch.Tensor, b: torch.Tensor, t: float,
          eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation — appropriate in Z space, where latents live
    near the radius-sqrt(dim) sphere of the Gaussian prior. Falls back to
    lerp when a and b are nearly parallel."""
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + eps)
    bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + eps)
    dot = torch.clamp((an * bn).sum(dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = so > eps
    w_a = torch.where(safe, torch.sin((1.0 - t) * omega) / (so + eps),
                      torch.full_like(so, 1.0 - t))
    w_b = torch.where(safe, torch.sin(t * omega) / (so + eps),
                      torch.full_like(so, t))
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

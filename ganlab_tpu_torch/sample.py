"""The G-EMA sampling function (port of ``train/steps.py::build_sample_fn``).

``build_sample_fn(cfg, res_log2)`` returns ``sample(g, w_avg, z, generator,
psi, alpha, noises=None)``: cast z to ``cfg.run.compute_dtype``; for the
style families map it to w, repeat w over the style layers, apply the
truncation trick (w_avg cast to the ws dtype, ``cfg.model.truncation_cutoff``)
and synthesize; ProGAN and ResNet-GAN map z straight to images (``w_avg``,
``generator``, ``psi`` and ``noises`` are accepted and unused, as in the
JAX package). Images are clipped to [-1, 1] in float32 and come back NCHW
on g's device. Serving runs it under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ganlab_tpu_torch.config import Config
from ganlab_tpu_torch.models import is_style
from ganlab_tpu_torch.models.stylegan import num_style_layers, truncate_ws


def build_sample_fn(cfg: Config, res_log2: int) -> Callable:
    dtype = getattr(torch, cfg.run.compute_dtype)
    cutoff = cfg.model.truncation_cutoff
    nl = num_style_layers(res_log2)
    style = is_style(cfg.model)

    def sample(g, w_avg, z, generator=None, psi=1.0, alpha=1.0,
               noises=None):
        z = z.to(dtype)
        if not style:
            return g(z, res_log2, alpha).float().clamp(-1.0, 1.0)
        w = g.map_latents(z)
        ws = w[:, None, :].expand(-1, nl, -1)
        ws = truncate_ws(ws, w_avg.to(ws.dtype), psi, cutoff)
        img = g.synthesize(ws, res_log2, alpha, noises, generator)
        return img.float().clamp(-1.0, 1.0)

    return sample

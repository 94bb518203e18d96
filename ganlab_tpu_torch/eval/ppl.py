"""Perceptual Path Length (StyleGAN, Karras et al. 2018 sec. 4.1).

Port of ``ganlab_tpu/eval/ppl.py``, the official protocol:

    d = lpips(G(lat(t)), G(lat(t + eps))) / eps^2

averaged over random interpolation endpoints after the official 1% / 99%
outlier filter. ``space='w'`` lerps in W (style families), ``'z'`` slerps on
the latent sphere and then maps (or, for ProGAN and ResNet-GAN, generates
from z directly); ``sampling='full'`` draws t ~ U(0, 1), ``'end'`` pins
t = 0. Both endpoint images of a pair share one noise draw (the metric
measures the latent walk, not noise), sampling is untruncated, and the
generator runs in float32, as in the JAX package.

The draws of a batch (z (2, B, latent), t (B, 1), the noise maps) come from
a ``torch.Generator`` seeded with ``seed`` on the generator's device, or are
injected (``draws=``) so that a test can hold the pairs against the JAX
package's. torch's streams are not JAX's: the same seed gives other
endpoints than the JAX function, so the two agree in distribution only.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch

from ganlab_tpu_torch.eval.lpips import LPIPSDistance
from ganlab_tpu_torch.models import build_generator, is_style, noise_shapes
from ganlab_tpu_torch.models.stylegan import num_style_layers
from ganlab_tpu_torch.utils.latents import lerp, slerp


def _space_of(style: bool, space: str | None) -> str:
    if space not in (None, "w", "z"):
        raise ValueError(f"space {space!r} not in ('w', 'z')")
    space = space or ("w" if style else "z")
    if space == "w" and not style:
        raise ValueError("space='w' needs a style-based family; use "
                         "space='z' for progan/resnetgan")
    return space


def ppl_pairs(cfg, g, z: torch.Tensor, t: torch.Tensor, epsilon: float,
              space: str, res_log2: int, noises=None):
    """The two endpoint images (float32 NCHW) of one batch of pairs:
    ``lat(t)`` and ``lat(t + epsilon)`` between z[0] and z[1] (lerp of the
    mapped w's in 'w', slerp of the z's in 'z'), both synthesized with the
    same ``noises`` (style families; give explicit maps, or both images
    draw their own)."""
    batch, dim = z.shape[1], z.shape[2]
    eps = torch.tensor(epsilon, dtype=torch.float32, device=z.device)
    style = is_style(cfg.model)
    if space == "w":
        w = g.map_latents(z.reshape(2 * batch, dim)).float()
        w = w.reshape(2, batch, -1)
        lat0, lat1 = lerp(w[0], w[1], t), lerp(w[0], w[1], t + eps)
    else:
        lat0, lat1 = slerp(z[0], z[1], t), slerp(z[0], z[1], t + eps)
        if style:
            ww = g.map_latents(torch.cat([lat0, lat1])).float()
            lat0, lat1 = ww[:batch], ww[batch:]

    def synth(lat):
        if not style:
            return g(lat, res_log2, 1.0).float()
        ws = lat[:, None, :].expand(-1, num_style_layers(res_log2), -1)
        return g.synthesize(ws, res_log2, 1.0, noises).float()

    return synth(lat0), synth(lat1)


def _drawn(cfg, sampling: str, batch: int, res_log2: int, seed: int,
           device):
    style, dim = is_style(cfg.model), cfg.model.latent_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        z = torch.randn((2, batch, dim), generator=gen, device=device)
        t = torch.rand((batch, 1), generator=gen, device=device) \
            if sampling == "full" else torch.zeros((batch, 1), device=device)
        noises = [torch.randn((batch, 1, h, w), generator=gen,
                              device=device)
                  for h, w in noise_shapes(cfg.model, res_log2)] \
            if style else None
        yield z, t, noises


def compute_ppl(cfg, g, *, num_samples: int = 5000, epsilon: float = 1e-4,
                space: str | None = None, sampling: str = "full",
                batch: int = 32, seed: int = 0, distance=None,
                res_log2: int | None = None,
                draws: Iterable | None = None) -> dict:
    """PPL of generator ``g`` (float32 parameters on its device).
    Returns ``{"ppl", "num", "space", "sampling"}``.

    ``space=None`` picks 'w' for the style families, 'z' otherwise.
    ``distance``: callable (imgs_a, imgs_b) -> (B,) distances; default
    :class:`LPIPSDistance` on g's device (pretrained when
    ``$GANLAB_LPIPS_WEIGHTS`` is set, random VGG16 otherwise, with a
    warning). ``draws``: an iterable of (z, t, noises) per batch in place
    of the seeded draws."""
    if sampling not in ("full", "end"):
        raise ValueError(f"sampling {sampling!r} not in ('full', 'end')")
    style = is_style(cfg.model)
    space = _space_of(style, space)
    device = next(g.parameters()).device
    lg = cfg.model.res_log2 if res_log2 is None else res_log2
    dist = distance or LPIPSDistance(device=device)
    if not getattr(dist, "pretrained", True):
        print("WARNING: no VGG16 weights (set $GANLAB_LPIPS_WEIGHTS); "
              "PPL uses random features — valid for relative comparison "
              "only", flush=True)
    if draws is None:
        draws = _drawn(cfg, sampling, batch, lg, seed, device)
    dists, done = [], 0
    for z, t, noises in draws:
        if done >= num_samples:
            break
        with torch.inference_mode():
            img0, img1 = ppl_pairs(cfg, g, z.to(device), t.to(device),
                                   epsilon, space, lg, noises)
        dists.append(np.asarray(dist(img0, img1), np.float64)
                     / float(epsilon) ** 2)
        done += z.shape[1]
    d = np.concatenate(dists)[:num_samples]
    # the official outlier filter: keep the [1st, 99th] percentile
    lo, hi = np.percentile(d, 1), np.percentile(d, 99)
    kept = d[(d >= lo) & (d <= hi)]
    return {"ppl": float(kept.mean()), "num": int(d.size),
            "space": space, "sampling": sampling}


def evaluate_checkpoint_ppl(cfg, workdir: str, *, step: int | None = None,
                            device: str | torch.device = "cuda",
                            **kw) -> dict:
    """PPL of the latest (or ``step``'s) checkpoint's G-EMA."""
    from ganlab_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(os.path.join(workdir, cfg.run.checkpoint_dir))
    try:
        payload = ckpt.load(step)
    finally:
        ckpt.close()
    if payload is None:
        raise FileNotFoundError(f"no checkpoint under {workdir}")
    g = build_generator(cfg.model)
    g.load_state_dict(payload["g_ema"])
    g = g.to(device).eval().requires_grad_(False)
    return compute_ppl(cfg, g, **kw)

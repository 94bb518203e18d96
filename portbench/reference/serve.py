"""Plain float32 truncated sampling of the StyleGAN generator: the
reference that the serving cell's images are held to.

A request of ``n`` images with stream seed ``s``: latent i is a float32
N(0, I) vector from a CPU generator seeded from (s, i); the noise images
of its batch b come from a generator on the device seeded from
(s, 'nois', b), one (n, 1, H, W) draw a style layer in the synthesis
order, in the configuration's compute dtype. These are the serving
contract's inputs, made here again from the seed. The image: w = mapping
(z), the truncation w_avg + psi (w - w_avg) on the layers below
``truncation_cutoff``, synthesis, clip to [-1, 1], NHWC, and
uint8 = trunc(clip((x + 1) * 127.5, 0, 255)).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as M

NOISE_STREAM = 0x6E6F6973


def stream_seed(*parts: int) -> int:
    state = np.random.SeedSequence([int(p) for p in parts]) \
        .generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def latents(n: int, dim: int, seed: int, start: int = 0) -> torch.Tensor:
    return torch.stack([
        torch.randn(dim, generator=torch.Generator().manual_seed(
            stream_seed(seed, i))) for i in range(start, start + n)])


def noises(m: dict, n: int, seed: int, batch_index: int, device, dtype):
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, NOISE_STREAM, batch_index))
    return [torch.randn((n, 1, h, w), generator=gen, device=device,
                        dtype=dtype) for h, w in M.noise_shapes(m)]


@torch.no_grad()
def sample_u8(P, m, w_avg, z, noise, psi, prec=M.F32) -> torch.Tensor:
    """(n, R, R, C) uint8 images of latents z (n, w) and noise images."""
    w = M.mapping(P, m, z.float(), prec)
    nl = M.num_style_layers(m)
    ws = w[:, None, :].expand(-1, nl, -1)
    idx = torch.arange(nl, device=w.device)[None, :, None]
    trunc = w_avg[None, None, :] + psi * (ws - w_avg[None, None, :])
    ws = torch.where(idx < m["truncation_cutoff"], trunc, ws)
    img = M.synthesis(P, m, ws, [x.float() for x in noise], prec)
    img = img.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
    return ((img + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)

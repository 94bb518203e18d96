"""The inputs a run makes from its ``--seed``: seeds of each stream,
weights and real image batches, all on the device."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as M

# the streams one ``--seed`` splits into
G_WEIGHTS, D_WEIGHTS, STEP_DRAWS, REALS, W_AVG, REQUESTS, SAMPLES = range(1, 8)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of stream ``stream`` of run seed ``seed`` (any
    non-negative integer)."""
    state = np.random.SeedSequence([int(seed), int(stream)]) \
        .generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def weights(m: dict, seed: int, device) -> tuple[dict, dict]:
    """The G and D parameters of run seed ``seed`` (float32, on the
    device, one draw a network)."""
    return (M.make_params(M.g_spec(m), sub_seed(seed, G_WEIGHTS), device),
            M.make_params(M.d_spec(m), sub_seed(seed, D_WEIGHTS), device))


def w_avg(m: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, W_AVG))
    return torch.randn(m["latent_dim"], generator=gen, device=device)


def reals(m: dict, batches: int, batch: int, seed: int, device
          ) -> torch.Tensor:
    """(batches, batch, R, R, C) uint8 real images, uniform, on the device:
    every row differs."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, REALS))
    r = m["resolution"]
    return torch.randint(0, 256, (batches, batch, r, r, m["img_channels"]),
                         generator=gen, device=device, dtype=torch.uint8)


def request_seed(seed: int, index: int) -> int:
    """The stream seed of serving request ``index``."""
    return int(np.random.SeedSequence([int(seed), REQUESTS, int(index)])
               .generate_state(1, np.uint32)[0])

"""Batch-inference serving around the G-EMA sampler (port of ``serve.py``).

Two samplers serve a trained G-EMA: ``BatchSampler`` here runs the
truncation-trick G-EMA sampler (``sample.build_sample_fn``) on the model
code, ``export.ExportedSampler`` runs a ``torch.export`` program of it.
Both keep the JAX package's reproducibility contract, which the shared
base below holds once:

* **Index-stable latents**: z_i of stream ``seed`` is drawn from its own
  ``torch.Generator`` seeded from ``(seed, i)``, so image ``i`` is the same
  whatever the request size or split: ``generate(3)[i] == generate(100)[i]``.
* **Fixed batch**: every request is padded up to ``batch_size`` and trimmed,
  so every batch runs the same shapes.
* **Noise determinism**: the per-layer synthesis noise of batch ``b`` comes
  from a generator on the serving device seeded from ``(noise seed, b)``:
  deterministic for a fixed ``batch_size``.
* **psi per call**: ``generate(..., psi=)`` overrides the default
  truncation for one request.

Each batch's images are made uint8 NHWC on the serving device and reach
the host as one C-contiguous array, filled by one copy from the device
(the NHWC view is made contiguous there). On the card that array is
page-locked memory from torch's host cache, and a request of one batch
returns it as it is: the memory stays with the caller's array until the
caller drops it, and goes back to torch's cache for a later request. A
caller who holds many results holds that much page-locked memory.

The streams are torch's (Philox/MT), not JAX's threefry: the same seed gives
other latents and noise than ``ganlab_tpu.serve.BatchSampler``. The
contract (prefix stability, repeatability) is the same. Given the same z
and zero noise scales, both packages give the same images.

``BatchSampler`` takes a training ``workdir`` (the G-EMA and w-average of
its latest checkpoint), a live ``TrainState`` (``state=``), or the G-EMA
parameters directly (``params=``, a port ``state_dict`` or a flax numpy
tree, converted on entry, with ``w_avg=`` for the style families): exactly
one of the three. ProGAN and ResNet-GAN have no w-average and no
truncation: their sampler maps z straight to images, under the same
contract. This module imports the model code only when a ``BatchSampler``
is made, so ``export`` loads without it.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch

from ganlab_tpu_torch.utils.image import save_image_grid
from ganlab_tpu_torch.utils.latents import slerp, stream_latents, stream_seed
from ganlab_tpu_torch.utils.spans import span

if TYPE_CHECKING:
    from ganlab_tpu_torch.config import Config

_NOISE_STREAM = 0x6E6F6973  # 'nois': generate()'s noise stream of a seed


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Float [-1, 1] NHWC -> uint8 on x's device, also in an exported graph:
    ``utils.image.to_uint8``'s clip((x + 1) * 127.5, 0, 255), truncated."""
    return ((x.float() + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)


def _assemble(parts: list) -> np.ndarray:
    """The batches' host arrays as one request's: a single batch's array
    as it is (a leading slice of a C-contiguous array is one), more
    concatenated."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class _Serving:
    """The contract and the result path of both samplers. A sampler sets
    ``device``, ``batch_size``, ``_latent_dim`` and ``_default_psi``, and
    its ``_forward(z, noise_seed, psi)`` turns one padded batch of latents
    (numpy) into (batch, H, W, C) uint8 on the serving device, issued and
    not waited for."""

    def _batches(self, n: int):
        for start in range(0, n, self.batch_size):
            yield start, min(self.batch_size, n - start)

    def _host_empty(self, shape) -> torch.Tensor:
        """A C-contiguous uint8 host tensor of ``shape``: page-locked from
        torch's host cache for a ``cuda`` sampler (pageable where pinning
        fails), plain for a ``cpu`` one."""
        if self.device.type == "cuda":
            try:
                return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            except RuntimeError:        # page-locked memory exhausted
                pass
        return torch.empty(shape, dtype=torch.uint8)

    def _run(self, z: np.ndarray, noise_seed: int, psi: float) -> np.ndarray:
        """One padded batch of latents -> (batch, H, W, C) uint8 on the
        host, C-contiguous. ``_forward``'s output is an NHWC view over NCHW
        bytes; one ``copy_`` into a fresh contiguous host array makes it
        contiguous on the device and copies it once."""
        out = self._forward(z, noise_seed, psi)
        with span("serve.copy"):
            with span("serve.alloc"):
                dst = self._host_empty(out.shape)
            dst.copy_(out)
        return dst.numpy()

    def generate(self, n: int, *, seed: int = 0,
                 psi: float | None = None) -> np.ndarray:
        """n images of stream ``seed`` as (n, H, W, C) uint8; image ``i``
        is the same for every request size, and the same on both samplers
        for the same weights, seed, batch size and device."""
        psi = self._default_psi if psi is None else float(psi)
        with span("serve.generate"):
            out = []
            for b, (start, size) in enumerate(self._batches(n)):
                with span("serve.inputs"):
                    z = stream_latents(self.batch_size, self._latent_dim,
                                       seed=seed, start=start)
                out.append(self._run(z, stream_seed(seed, _NOISE_STREAM, b),
                                     psi)[:size])
            with span("serve.assemble"):
                return _assemble(out)

    def generate_from_z(self, z, *, noise_seed: int = 0,
                        psi: float | None = None) -> np.ndarray:
        """Images for explicit latents z (n, latent_dim) -> uint8."""
        psi = self._default_psi if psi is None else float(psi)
        z = np.asarray(z, np.float32)
        out = []
        for b, (start, size) in enumerate(self._batches(z.shape[0])):
            zb = np.zeros((self.batch_size, z.shape[1]), np.float32)
            zb[:size] = z[start:start + size]
            out.append(self._run(zb, stream_seed(noise_seed, b),
                                 psi)[:size])
        return _assemble(out)


class BatchSampler(_Serving):
    """Fixed-batch G-EMA inference service for one trained model::

        s = BatchSampler(cfg, workdir="runs/stylegan256")
        s = BatchSampler(cfg, params=g_ema_state, w_avg=w_avg)
        imgs = s.generate(64, seed=0)            # (64, H, W, 3) uint8
        frames = s.interpolate(seed_a=0, seed_b=1, steps=30)
    """

    def __init__(self, cfg: Config, workdir: str | None = None, *,
                 state=None, params: Mapping[str, Any] | None = None,
                 w_avg=None, batch_size: int = 64,
                 res_log2: int | None = None,
                 device: str | torch.device = "cuda"):
        from ganlab_tpu_torch.convert import from_flax, is_flax_tree
        from ganlab_tpu_torch.models import build_generator, is_style
        from ganlab_tpu_torch.sample import build_sample_fn

        if sum(x is not None for x in (workdir, state, params)) != 1:
            raise ValueError("pass exactly one of workdir=, state= or "
                             "params= (with w_avg=)")
        if workdir is not None:
            from ganlab_tpu_torch.train.checkpoint import CheckpointManager

            directory = os.path.join(workdir, cfg.run.checkpoint_dir)
            saved = CheckpointManager(directory).load() \
                if os.path.isdir(directory) else None
            if saved is None:
                raise FileNotFoundError(f"no checkpoint under {directory}")
            params, w_avg = saved["g_ema"], saved["w_avg"]
        elif state is not None:
            params = {k: v.detach().clone()
                      for k, v in state.g_ema.state_dict().items()}
            w_avg = state.w_avg.detach().clone()
        elif w_avg is None:
            if is_style(cfg.model):
                raise ValueError("params= of a style family needs w_avg=")
            w_avg = torch.zeros(cfg.model.latent_dim)
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        self.res_log2 = cfg.model.res_log2 if res_log2 is None else res_log2
        self.resolution = 2 ** self.res_log2
        self._latent_dim = cfg.model.latent_dim
        self._default_psi = float(cfg.model.truncation_psi)
        if is_flax_tree(params):
            params = from_flax(params)
        g = build_generator(cfg.model)
        g.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           if not isinstance(v, torch.Tensor) else v
                           for k, v in params.items()})
        self.g = g.to(self.device).eval().requires_grad_(False)
        if not isinstance(w_avg, torch.Tensor):
            w_avg = torch.as_tensor(np.asarray(w_avg, np.float32))
        self.w_avg = w_avg.to(self.device, torch.float32)
        self._sample = build_sample_fn(cfg, self.res_log2)

    # ------------------------------------------------------------------
    def warmup(self) -> "BatchSampler":
        """Run one batch (builds and JIT-compiles the kernels)."""
        self.generate(1, seed=0)
        return self

    def _forward(self, z: np.ndarray, noise_seed: int,
                 psi: float) -> torch.Tensor:
        """The synthesis noise drawn inside the G from a generator on the
        serving device seeded ``noise_seed``; the clipped float32 NCHW
        images made uint8 on their NHWC view on the device."""
        with torch.inference_mode():
            with span("serve.inputs"):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(noise_seed)
                z = torch.from_numpy(z).to(self.device)
            with span("serve.forward"):
                img = self._sample(self.g, self.w_avg, z, gen, psi, 1.0)
                return _to_uint8(img.permute(0, 2, 3, 1))

    def latents(self, n: int, *, seed: int = 0, start: int = 0) -> np.ndarray:
        """The index-stable z's generate() uses (for editing/interp)."""
        return stream_latents(n, self.cfg.model.latent_dim, seed=seed,
                              start=start)

    def interpolate(self, *, seed_a: int = 0, seed_b: int = 1,
                    index_a: int = 0, index_b: int = 0, steps: int = 16,
                    psi: float | None = None,
                    noise_seed: int = 0) -> np.ndarray:
        """slerp walk between two stream images -> (steps, H, W, C) uint8."""
        za = torch.from_numpy(self.latents(1, seed=seed_a, start=index_a)[0])
        zb = torch.from_numpy(self.latents(1, seed=seed_b, start=index_b)[0])
        ts = np.linspace(0.0, 1.0, steps, dtype=np.float32)
        z = torch.stack([slerp(za, zb, float(t)) for t in ts]).numpy()
        return self.generate_from_z(z, noise_seed=noise_seed, psi=psi)

    def save_grid(self, path: str, n: int = 16, *, seed: int = 0,
                  psi: float | None = None) -> str:
        imgs = self.generate(n, seed=seed, psi=psi)
        # save_image_grid expects [-1, 1] float; convert back from uint8.
        return save_image_grid(imgs.astype(np.float32) / 127.5 - 1.0, path)

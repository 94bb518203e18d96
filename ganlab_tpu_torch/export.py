"""Portable inference artifact: the G-EMA sampler as ``torch.export``
programs (port of ``ganlab_tpu/export.py``).

``export_sampler`` captures the truncation-trick G-EMA sampler
(``sample.build_sample_fn``) with the trained parameters and w-average
baked in, traces it with ``torch.export`` and writes one zip artifact:

* ``meta.json``          resolution, latent dim, batch size, default psi,
  model family, platforms, format version (the JAX artifact's keys), and
  the noise maps' shapes and dtype, which the loader draws;
* ``sampler_<device>.pt2``  one exported program per device type of
  ``platforms`` (default ``("cuda", "cpu")``; ``cuda`` only where a card
  is present): (z, noise maps, psi) -> uint8 images (N, H, W, C), the
  conversion made in the graph, psi a 0-d float32 tensor so that one
  program serves every truncation.

The five kernels are ``torch.library`` operators (``ops/kernels``), so the
programs hold them: a ``cuda`` program loaded on the card launches the
CUDA C++ kernels, a ``cpu`` program runs their plain versions.

Two things differ from the JAX artifact. ``torch.export`` takes no
``torch.Generator``, so the loader draws the latents and the batches'
noise maps outside the program, from the streams ``BatchSampler`` draws
them from: image i of ``ExportedSampler.generate(n, seed=)`` is
``BatchSampler.generate``'s image i for the same seed, batch size and
device. And the JAX artifact holds one StableHLO program for all its
platforms where this one holds a program per device type.

``ExportedSampler`` loads the artifact and serves it through
``BatchSampler``'s contract and result path (``serve._Serving``). It
imports no model code: ``torch``, numpy, ``serve`` (which imports the
model code only when a ``BatchSampler`` is made) and ``ops.kernels``,
whose import registers the operators the programs call::

    s = ExportedSampler("sampler.ganlab.zip")          # on the card
    imgs = s.generate(64, seed=0)                      # (64, H, W, 3) uint8
"""

from __future__ import annotations

import copy
import io
import json
import warnings
import zipfile

import numpy as np
import torch

from ganlab_tpu_torch.serve import (  # noqa: F401 (_NOISE_STREAM: this
    _NOISE_STREAM,                    # module's name of it too)
    _Serving,
    _to_uint8,
)
from ganlab_tpu_torch.utils.spans import span

FORMAT_VERSION = 1


class _Sampler(torch.nn.Module):
    """(z, noise maps, psi) -> uint8 NHWC images of the G-EMA."""

    def __init__(self, g, w_avg: torch.Tensor, sample):
        super().__init__()
        self.g = g
        self.register_buffer("w_avg", w_avg.detach().float().clone())
        self._sample = sample

    def forward(self, z, noises, psi):
        img = self._sample(self.g, self.w_avg, z, None, psi, 1.0,
                           noises=list(noises) or None)
        return _to_uint8(img.permute(0, 2, 3, 1))


def export_sampler(cfg, state, path: str, *, batch_size: int = 16,
                   res_log2: int | None = None,
                   platforms=("cuda", "cpu"),
                   default_psi: float | None = None) -> str:
    """Write the G-EMA sampler of ``state`` (a ``TrainState``, or anything
    with ``g_ema`` and ``w_avg``) to a zip artifact at ``path``. The
    programs have a fixed batch dimension (``batch_size``); the loader pads
    and trims requests as ``serve.BatchSampler`` does. ``platforms`` names
    the device types to export for; ``cuda`` is left out, with a warning,
    where no card is present."""
    from ganlab_tpu_torch.models import is_style, noise_shapes
    from ganlab_tpu_torch.sample import build_sample_fn

    mc = cfg.model
    res_log2 = mc.res_log2 if res_log2 is None else res_log2
    sample = build_sample_fn(cfg, res_log2)
    shapes = [list(s) for s in noise_shapes(mc, res_log2)] \
        if is_style(mc) else []
    dtype = getattr(torch, cfg.run.compute_dtype)
    plats = []
    for p in platforms:
        if p not in ("cuda", "cpu"):
            raise ValueError(f"export_sampler: unknown platform {p!r} "
                             "(cuda, cpu)")
        if p == "cuda" and not torch.cuda.is_available():
            warnings.warn("export_sampler: no CUDA device; the artifact "
                          "holds no cuda program")
            continue
        plats.append(p)
    if not plats:
        raise ValueError("export_sampler: no program to export")
    programs = {}
    for p in plats:
        g = copy.deepcopy(state.g_ema).to(p).eval().requires_grad_(False)
        module = _Sampler(g, state.w_avg.to(p), sample).eval()
        args = (torch.zeros(batch_size, mc.latent_dim, device=p),
                [torch.zeros(batch_size, 1, h, w, device=p, dtype=dtype)
                 for h, w in shapes],
                torch.ones((), device=p))
        with torch.no_grad():
            program = torch.export.export(module, args)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[p] = buf.getvalue()
        del g, module, program
    meta = {
        "format_version": FORMAT_VERSION,
        "model": mc.model,
        "resolution": 2 ** res_log2,
        "res_log2": res_log2,
        "latent_dim": mc.latent_dim,
        "batch_size": int(batch_size),
        "default_psi": float(mc.truncation_psi if default_psi is None
                             else default_psi),
        "platforms": plats,
        "noise_shapes": shapes,
        "noise_dtype": cfg.run.compute_dtype,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        for p, blob in programs.items():
            zf.writestr(f"sampler_{p}.pt2", blob)
    return path


class ExportedSampler(_Serving):
    """Serve images from an ``export_sampler`` artifact on ``device``
    (default ``cuda``; ``cpu`` runs the artifact's cpu program): the
    network and its weights live in the exported program, and no model
    code or checkpoint is needed. ``generate`` / ``generate_from_z`` are
    ``BatchSampler``'s: image ``i`` is its image ``i`` for the same seed,
    batch size and device."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        # registers the ganlab:: operators the programs call
        import ganlab_tpu_torch.ops.kernels  # noqa: F401

        self.device = torch.device(device)
        with zipfile.ZipFile(path) as zf:
            self.meta = json.loads(zf.read("meta.json"))
            if self.meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"unsupported artifact version "
                    f"{self.meta.get('format_version')!r} in {path}")
            name = f"sampler_{self.device.type}.pt2"
            if name not in zf.namelist():
                raise ValueError(
                    f"{path} holds no program for {self.device.type} "
                    f"(platforms {self.meta['platforms']})")
            program = torch.export.load(io.BytesIO(zf.read(name)))
        self._program = program.module()
        self.batch_size = int(self.meta["batch_size"])
        self.resolution = int(self.meta["resolution"])
        self.latent_dim = self._latent_dim = int(self.meta["latent_dim"])
        self._default_psi = float(self.meta["default_psi"])
        self._noise_shapes = [tuple(s) for s in self.meta["noise_shapes"]]
        self._noise_dtype = getattr(torch, self.meta["noise_dtype"])

    def _forward(self, z: np.ndarray, noise_seed: int,
                 psi: float) -> torch.Tensor:
        """One padded batch of latents -> the program's (batch, H, W, C)
        uint8 on the serving device (on the card issued, not waited for).
        The noise maps are drawn in the synthesis network's order from a
        generator on the serving device, as ``BatchSampler`` draws them."""
        dev, n = self.device, self.batch_size
        with torch.inference_mode():
            with span("serve.inputs"):
                gen = torch.Generator(device=dev).manual_seed(noise_seed)
                noises = [torch.randn((n, 1, h, w), generator=gen,
                                      device=dev, dtype=self._noise_dtype)
                          for h, w in self._noise_shapes]
                z = torch.from_numpy(z).to(dev)
                psi = torch.tensor(psi, dtype=torch.float32, device=dev)
            with span("serve.forward"):
                return self._program(z, noises, psi)

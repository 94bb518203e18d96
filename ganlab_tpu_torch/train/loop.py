"""Host-side training loop: the progressive schedule over one device.

Port of ``ganlab_tpu/train/loop.py::Trainer``. Cold start: config -> data
source -> state init or checkpoint restore -> per-phase step loop. Batches
cross to the device as uint8 through the background prefetcher.
Progressive growth = switching to the next phase's step function over the
unchanged state: the models and both optimizers hold every resolution's
parameters from the start, so a phase switch rebuilds nothing; a head or
block that a phase switches on gets its Adam moments at its first gradient
(``train/state.py::seed_new_moments``).

Phase and fade-in alpha derive from the state's ``shown_imgs``, the
lazy-regularization cadence from its ``step``, so a ``Trainer`` built on a
workdir that holds a checkpoint continues where that left off (the data
source is not part of the state: it starts over in a new process, as in
the JAX package).

In-training evaluation (``run.eval_kimg``): every ``eval_kimg`` thousand
shown images the G-EMA is scored (FID and KID of ``run.eval_samples``
untruncated samples at the phase's resolution and fade-in alpha, against
real features computed once per resolution) and the row is logged to
``train.jsonl`` with the JAX trainer's keys.

Single device. Not ported (ROADMAP.md A): a device mesh (A.6) and
``run.profile`` (A.8) raise ``NotImplementedError``; ``optim.grad_accum >
1`` raises when the step is built. ``run.chunk_steps`` is a dispatch knob
of the JAX package (scan-chunked stepping) with nothing to switch here: it
is ignored.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from ganlab_tpu_torch.config import Config, save_config
from ganlab_tpu_torch.data import Prefetcher, device_placer, make_source
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train.checkpoint import CheckpointManager
from ganlab_tpu_torch.train.schedule import alpha_at, build_phases, phase_at
from ganlab_tpu_torch.train.state import create_train_state, reset_moments
from ganlab_tpu_torch.train.steps import make_lazy_stepper
from ganlab_tpu_torch.utils.image import save_image_grid
from ganlab_tpu_torch.utils.latents import gen_latents
from ganlab_tpu_torch.utils.logging import MetricLogger


class Trainer:
    """Owns state, schedule, step functions, IO. One instance per run."""

    def __init__(self, cfg: Config, workdir: str = ".", source=None,
                 device: str | torch.device = "cuda"):
        if cfg.run.profile:
            raise NotImplementedError(
                "run.profile is not ported to PyTorch yet (ROADMAP.md A.8)")
        self.cfg = cfg
        self.workdir = workdir
        self.phases = build_phases(cfg.schedule, cfg.model)
        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.run.checkpoint_dir),
            keep=cfg.run.keep_checkpoints)
        self.logger = MetricLogger(workdir, tensorboard=cfg.run.tensorboard)
        # The run's full config next to its checkpoints: the post-training
        # commands reload it from the workdir, so a bare `--workdir`
        # rebuilds the exact trained model.
        save_config(cfg, os.path.join(workdir, "config.json"))

        self.state = create_train_state(cfg, seed=cfg.run.seed, device=device)
        if self.ckpt.restore(self.state) is not None:
            print(f"resumed from step {self.state.step}", flush=True)

        # Lazy: sampling from a checkpoint must not require the dataset.
        self._source = source
        self._steps: dict[tuple, Callable] = {}
        self._samplers: dict[int, Callable] = {}
        # run.eval_kimg: the extractor, built at the first evaluation, and
        # the real features per resolution (the data side never changes)
        self._eval_extractor = None
        self._eval_real: dict[int, np.ndarray] = {}

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def source(self):
        if self._source is None:
            self._source = make_source(self.cfg.data,
                                       self.cfg.model.resolution,
                                       seed=self.cfg.run.seed)
        return self._source

    # ------------------------------------------------------------------
    def _step_fn(self, phase) -> Callable:
        key = (phase.res_log2, phase.kind, phase.start_img, phase.end_img)
        if key not in self._steps:
            self._steps[key] = make_lazy_stepper(
                self.cfg, phase, initial_step=self.state.step)
        return self._steps[key]

    def _sampler(self, res_log2: int) -> Callable:
        if res_log2 not in self._samplers:
            self._samplers[res_log2] = build_sample_fn(self.cfg, res_log2)
        return self._samplers[res_log2]

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train(self, max_steps: int | None = None) -> dict:
        """Run until the schedule (or ``max_steps`` optimizer steps) ends.
        Returns the last step's metrics."""
        cfg, run, state = self.cfg, self.cfg.run, self.state
        max_steps = max_steps if max_steps is not None else run.total_steps
        steps_done = 0
        # Logged steps are global (state.step), not process-local: a resumed
        # run appends monotonic step keys to train.jsonl.
        start_step = state.step
        metrics: dict = {}

        last_phase_index = None
        while state.shown_imgs < self.phases[-1].end_img:
            phase = phase_at(self.phases, state.shown_imgs)
            if (cfg.optim.reset_moments_on_phase
                    and last_phase_index is not None
                    and phase.index != last_phase_index):
                reset_moments(state)
            last_phase_index = phase.index
            step_fn = self._step_fn(phase)
            batch = phase.batch_size
            print(f"phase {phase.index}: res {phase.resolution} {phase.kind} "
                  f"[{phase.start_img}, {phase.end_img}) batch {batch} on "
                  f"{self.device}", flush=True)

            phase_t0 = time.perf_counter()
            phase_shown0 = state.shown_imgs
            with Prefetcher(self.source, batch, phase.resolution,
                            place=device_placer(self.device),
                            depth=cfg.data.prefetch) as pf:
                while state.shown_imgs < phase.end_img:
                    if max_steps is not None and steps_done >= max_steps:
                        self._finish()
                        return metrics
                    state, metrics = step_fn(state, pf.next())
                    steps_done += 1
                    step_i = start_step + steps_done

                    def crossed(every):
                        return every and \
                            step_i // every != (step_i - 1) // every
                    if crossed(run.log_every):
                        # the only place a step waits for the device
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(res=phase.resolution, kind=phase.kind,
                                 shown_imgs=state.shown_imgs)
                        self.logger.log(step_i, m)
                    # shown-image cadence: it survives batch-size changes
                    if run.eval_kimg:
                        per = run.eval_kimg * 1000.0
                        if int(state.shown_imgs // per) != \
                                int((state.shown_imgs - batch) // per):
                            self.run_eval(phase, state.shown_imgs, step_i)
                    if crossed(run.sample_every):
                        self.save_samples(phase.res_log2,
                                          tag=f"step{step_i:08d}")
                    if crossed(run.checkpoint_every):
                        self.save_checkpoint()
            # Per-phase throughput (the first steps of a phase build its
            # kernels' and cuDNN's plans; over a full phase steady-state
            # stepping dominates).
            self._synchronize()
            dt = time.perf_counter() - phase_t0
            shown = state.shown_imgs - phase_shown0
            if dt > 0 and shown > 0:
                print(f"phase {phase.index} ({phase.resolution} "
                      f"{phase.kind}): {shown / dt:.1f} img/s over {shown} "
                      f"imgs", flush=True)
        self._finish()
        return metrics

    # ------------------------------------------------------------------
    def _get_eval_extractor(self):
        if self._eval_extractor is None:
            from ganlab_tpu_torch.eval.fid import (
                RandomConvExtractor,
                get_extractor,
            )

            kind = self.cfg.run.eval_extractor
            if kind == "randconv":
                ext = RandomConvExtractor()
            elif kind == "inception":
                from ganlab_tpu_torch.eval.inception import (
                    InceptionExtractor,
                )

                ext = InceptionExtractor(
                    weights_path=os.environ.get("GANLAB_INCEPTION_WEIGHTS"))
            else:                       # 'auto'
                ext = get_extractor()
            self._eval_extractor = ext.to(self.device).eval()
        return self._eval_extractor

    def _eval_real_features(self, resolution: int) -> np.ndarray:
        """Real features at this resolution, computed once per run, from
        the full distribution (a ``data.num_images`` training pool is judged
        on generalization: memorizing it must not score well)."""
        if resolution not in self._eval_real:
            from ganlab_tpu_torch.eval.fid import extract, real_batch

            extractor = self._get_eval_extractor()
            data = dataclasses.replace(self.cfg.data, num_images=None)
            src = make_source(data, resolution, seed=self.cfg.run.seed + 99)
            n = self.cfg.run.eval_samples
            feats = []
            for i in range(0, n, 64):
                real = src.batch(min(64, n - i), resolution)
                feats.append(extract(extractor,
                                     real_batch(real, self.device)))
            close = getattr(src, "close", None)
            if close is not None:
                close()
            self._eval_real[resolution] = np.concatenate(feats)
        return self._eval_real[resolution]

    def run_eval(self, phase, shown: int, step_i: int) -> dict:
        """Score the G-EMA (FID and KID, untruncated, at the phase's
        resolution and fade-in alpha) against the cached real features
        and log the row to ``train.jsonl`` (and TensorBoard)."""
        from ganlab_tpu_torch.eval.fid import (
            compute_fid,
            compute_kid,
            extract,
        )

        cfg, state = self.cfg, self.state
        extractor = self._get_eval_extractor()
        real = self._eval_real_features(phase.resolution)
        sampler = self._sampler(phase.res_log2)
        alpha = float(alpha_at(phase, shown))
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.run.seed + 1013)
        n = cfg.run.eval_samples
        feats = []
        for _ in range(0, n, 64):
            z = gen_latents(gen, 64, cfg.model.latent_dim)
            with torch.inference_mode():
                fake = sampler(state.g_ema, state.w_avg, z, gen, 1.0, alpha)
            feats.append(extract(extractor, fake))
        fake_feats = np.concatenate(feats)[:n]
        row = {
            "eval_fid": compute_fid(real, fake_feats),
            "eval_kid": compute_kid(real, fake_feats,
                                    subset_size=min(1000, n // 2)),
            "eval_extractor": getattr(extractor, "name", "extractor"),
            "eval_samples": n,
            "res": phase.resolution, "kind": phase.kind,
            "shown_imgs": shown,
        }
        self.logger.log(step_i, row)
        return row

    def _finish(self) -> None:
        self.save_checkpoint()
        self.ckpt.wait()

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> None:
        self.ckpt.save(self.state.step, self.state)

    def save_samples(self, res_log2: int | None = None, tag: str = "final",
                     psi: float | None = None, out: str | None = None) -> str:
        """A fixed-z image grid from the G-EMA (truncation ``psi``)."""
        cfg, state = self.cfg, self.state
        lg = res_log2 if res_log2 is not None else cfg.model.res_log2
        dev = self.device
        z = gen_latents(torch.Generator(device=dev).manual_seed(
            cfg.run.seed + 1), cfg.run.num_sample_images,
            cfg.model.latent_dim)
        psi = psi if psi is not None else cfg.model.truncation_psi
        with torch.inference_mode():
            imgs = self._sampler(lg)(
                state.g_ema, state.w_avg, z,
                torch.Generator(device=dev).manual_seed(0), psi, 1.0)
            imgs = imgs.permute(0, 2, 3, 1).cpu().numpy()
        path = out or os.path.join(self.workdir, cfg.run.sample_dir,
                                   f"{tag}_res{2 ** lg}.png")
        return save_image_grid(imgs, path)

    def close(self) -> None:
        self.ckpt.close()
        self.logger.close()
        # a streaming source's decode workers
        close = getattr(self._source, "close", None)
        if close is not None:
            close()

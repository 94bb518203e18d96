"""Host-side training loop: the progressive schedule, on one device or
data-parallel over processes.

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

Data parallelism (``parallel/dist.py``): built after the process group is
joined (``torchrun --nproc-per-node N``, ``cli train``), the trainer is
one replica of N. Every rank restores from the same checkpoint, then the
state is broadcast from rank 0, so all replicas start identical; each
rank feeds ``batch x optim.grad_accum`` images a step from its own
source, seeded ``run.seed + 7919 x rank``, and the step averages the
gradients across the ranks. ``shown_imgs``, alpha and the phase walk
advance by the global batch, ``batch x grad_accum x N``. Rank 0 alone
writes the config, the checkpoints, the ``train.jsonl`` / TensorBoard
rows and the sample grids, and runs the in-training evaluation. With
``optim.grad_accum`` = A each step takes A microbatches of the phase's
batch (``train/steps.py``).

Profiling (``run.profile``): rank 0 traces the run's steps 10 to 19 (of
this process's run) with ``torch.profiler``, CPU and, on a card, CUDA
activities, and writes the Chrome trace to
``<workdir>/profile/trace_step<N>.json`` at step 20, or when the run ends
first. Besides the operators and kernels, the trace holds the program's
named spans (``utils/spans.py``): ``train.data`` (the wait for the next
batch), ``train.log`` (the device sync of a logged row),
``train.checkpoint``, ``train.sample`` and ``train.eval``, and within
the steppers ``train.chunk``, ``step.reg`` / ``step.pl`` /
``step.plain`` (one eager step: the D penalty firing, path length alone,
or neither) and ``graph.replay``.

Chunked stepping (``run.chunk_steps``, on by default; the JAX package's
scan-chunked stepping): where the D penalty is lazy (``loss.penalty_every``
= k > 1) and path length, where lazy, fires on a cadence that divides k
(``cfg.pl_chunkable``), the trainer feeds k batches at once, stacked on
the host and placed in one transfer, to ``make_chunked_stepper``: the
cycle's head step runs as the lazy dispatcher's, the off-run after it on a
card as a replay of a CUDA graph captured once per phase and off-run
variant (the first aligned cycle of a phase runs eagerly), and on the CPU,
with ``optim.grad_accum`` > 1 or under data parallelism as the same steps
one after another. A chunk is cut at the phase's end and at ``max_steps``;
a phase or a resume that starts mid-cycle runs single steps to the next
cycle head first. As in the JAX package, the host's cadences are checked
once a chunk (``crossed`` over the chunk's n steps): ``train.jsonl`` rows,
samples and checkpoints land on the first step key at or past each
multiple of their ``every`` that a chunk reaches, a cadence finer than the
cycle coarsens to once a cycle (a warning says so up front), and a row's
``penalty`` / ``pl_penalty`` is the chunk's largest (the fired, k-scaled
value), its other metrics the chunk's last step's. ``run.chunk_steps=False``
steps and checks one step at a time. A phase's graphs and their memory
pool are released when the trainer moves to the next phase.
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
from ganlab_tpu_torch.parallel import dist as pdist
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train.checkpoint import CheckpointManager
from ganlab_tpu_torch.train.schedule import alpha_at, build_phases, phase_at
from ganlab_tpu_torch.train.state import create_train_state, reset_moments
from ganlab_tpu_torch.train.steps import (
    make_chunked_stepper,
    make_lazy_stepper,
)
from ganlab_tpu_torch.utils.image import save_image_grid
from ganlab_tpu_torch.utils.latents import gen_latents
from ganlab_tpu_torch.utils.logging import MetricLogger
from ganlab_tpu_torch.utils.spans import span


class Trainer:
    """Owns state, schedule, step functions, IO. One instance per run."""

    def __init__(self, cfg: Config, workdir: str = ".", source=None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.phases = build_phases(cfg.schedule, cfg.model)
        # data parallelism: this process is replica ``rank`` of ``world``
        self.world, self.rank = pdist.world_size(), pdist.rank()
        self.is_main = self.rank == 0
        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.run.checkpoint_dir),
            keep=cfg.run.keep_checkpoints)
        self.logger = MetricLogger(workdir if self.is_main else None,
                                   tensorboard=cfg.run.tensorboard)
        if self.is_main:
            # The run's full config next to its checkpoints: the
            # post-training commands reload it from the workdir, so a bare
            # `--workdir` rebuilds the exact trained model.
            save_config(cfg, os.path.join(workdir, "config.json"))

        self.state = create_train_state(cfg, seed=cfg.run.seed, device=device)
        if self.ckpt.restore(self.state) is not None and self.is_main:
            print(f"resumed from step {self.state.step}", flush=True)
        # every replica starts from rank 0's state
        pdist.broadcast_state(self.state)

        # Lazy: sampling from a checkpoint must not require the dataset.
        self._source = source
        self._steps: dict[tuple, Callable] = {}
        self._samplers: dict[int, Callable] = {}
        # run.eval_kimg: the extractor, built at the first evaluation, and
        # the real features per resolution (the data side never changes)
        self._eval_extractor = None
        self._eval_real: dict[int, np.ndarray] = {}
        # run.profile: the open trace, and whether one was written
        self._trace = None
        self._trace_done = False
        self._warn_chunk_cadences()

    @property
    def chunking(self) -> bool:
        """Chunked stepping active (``Config.chunking``)."""
        return self.cfg.chunking

    def _warn_chunk_cadences(self) -> None:
        """A host cadence finer than the chunk's cycle coarsens to once a
        cycle under chunked stepping; say so once, up front."""
        if not self.chunking or not self.is_main:
            return
        cycle, run = self.cfg.loss.penalty_every, self.cfg.run
        coarsened = [f"run.{name}={val}" for name, val in (
            ("log_every", run.log_every),
            ("sample_every", run.sample_every),
            ("checkpoint_every", run.checkpoint_every),
        ) if val and val < cycle]
        if coarsened:
            print(f"warning: chunked stepping (run.chunk_steps) quantizes "
                  f"{', '.join(coarsened)} to the {cycle}-step lazy-"
                  f"regularization cycle — effective cadence is once per "
                  f"cycle; set run.chunk_steps=False for finer cadences",
                  flush=True)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def source(self):
        if self._source is None:
            # each rank draws its own stream for its shard of the batch
            self._source = make_source(
                self.cfg.data, self.cfg.model.resolution,
                seed=self.cfg.run.seed + 7919 * self.rank)
        return self._source

    # ------------------------------------------------------------------
    def _step_fn(self, phase) -> Callable:
        key = (phase.res_log2, phase.kind, phase.start_img, phase.end_img)
        if key not in self._steps:
            # the phases only move forward: the last one's graphs go
            self._close_steps()
            if self.chunking:
                self._steps[key], _ = make_chunked_stepper(
                    self.cfg, phase, initial_step=self.state.step)
            else:
                self._steps[key] = make_lazy_stepper(
                    self.cfg, phase, initial_step=self.state.step)
        return self._steps[key]

    def _close_steps(self) -> None:
        """Release the chunked steppers' CUDA graphs and their memory."""
        for stepper in self._steps.values():
            close = getattr(stepper, "close", None)
            if close is not None:
                close()

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
            # this rank feeds grad_accum microbatches a step; shown_imgs
            # advances by the global batch
            accum = cfg.optim.grad_accum
            feed_batch = phase.batch_size * accum
            global_batch = feed_batch * self.world
            if self.is_main:
                print(f"phase {phase.index}: res {phase.resolution} "
                      f"{phase.kind} [{phase.start_img}, {phase.end_img}) "
                      f"batch {phase.batch_size}"
                      + (f" x {accum} accum" if accum > 1 else "")
                      + (f" x {self.world} ranks" if self.world > 1
                         else "") + f" on {self.device}", flush=True)

            chunk = cfg.loss.penalty_every if self.chunking else 1
            phase_t0 = time.perf_counter()
            phase_shown0 = state.shown_imgs
            with Prefetcher(self.source, feed_batch, phase.resolution,
                            place=device_placer(self.device),
                            depth=cfg.data.prefetch, chunk=chunk) as pf:
                while state.shown_imgs < phase.end_img:
                    if max_steps is not None and steps_done >= max_steps:
                        self._finish()
                        return metrics
                    if run.profile and self.is_main and steps_done >= 10 \
                            and self._trace is None and not self._trace_done:
                        self._start_trace()
                    if chunk > 1:
                        # at most a cycle, cut at the phase's end and at
                        # max_steps; the stepper may take fewer (it
                        # realigns), and says how many by the metrics'
                        # length
                        n = min(chunk, -(-(phase.end_img - state.shown_imgs)
                                         // global_batch))
                        if max_steps is not None:
                            n = min(n, max_steps - steps_done)
                        with span("train.data"):
                            stack = pf.next()
                        state, stacked = step_fn(state, stack[:n])
                        n = len(stacked["d_loss"])
                        metrics = {k: v[-1] for k, v in stacked.items()}
                        # the chunk's last step never fires a lazy term:
                        # the chunk's largest is the fired, k-scaled value
                        for lazy in ("penalty", "pl_penalty"):
                            if lazy in stacked:
                                metrics[lazy] = stacked[lazy].max()
                    else:
                        n = 1
                        with span("train.data"):
                            real = pf.next()
                        state, metrics = step_fn(state, real)
                    steps_done += n
                    if self._trace is not None and steps_done >= 20:
                        self._stop_trace()
                    step_i = start_step + steps_done

                    def crossed(every):
                        return every and \
                            step_i // every != (step_i - n) // every
                    if crossed(run.log_every) and self.is_main:
                        # the only place a step waits for the device
                        with span("train.log"):
                            m = {k: float(v) for k, v in metrics.items()}
                        m.update(res=phase.resolution, kind=phase.kind,
                                 shown_imgs=state.shown_imgs)
                        self.logger.log(step_i, m)
                    # shown-image cadence: it survives batch-size changes
                    if run.eval_kimg and self.is_main:
                        per = run.eval_kimg * 1000.0
                        if int(state.shown_imgs // per) != int(
                                (state.shown_imgs - n * global_batch)
                                // per):
                            with span("train.eval"):
                                self.run_eval(phase, state.shown_imgs,
                                              step_i)
                    if crossed(run.sample_every) and self.is_main:
                        with span("train.sample"):
                            self.save_samples(phase.res_log2,
                                              tag=f"step{step_i:08d}")
                    if crossed(run.checkpoint_every):
                        with span("train.checkpoint"):
                            self.save_checkpoint()
            # Per-phase throughput (the first steps of a phase build its
            # kernels' and cuDNN's plans; over a full phase steady-state
            # stepping dominates).
            self._synchronize()
            dt = time.perf_counter() - phase_t0
            shown = state.shown_imgs - phase_shown0
            if dt > 0 and shown > 0 and self.is_main:
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

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._trace = profile(activities=activities)
        self._trace.start()

    def _stop_trace(self) -> None:
        """Close an open trace (after its last step has run on the device)
        and write it under ``<workdir>/profile``."""
        if self._trace is None:
            return
        self._synchronize()
        self._trace.stop()
        out = os.path.join(self.workdir, "profile")
        os.makedirs(out, exist_ok=True)
        self._trace.export_chrome_trace(
            os.path.join(out, f"trace_step{self.state.step:08d}.json"))
        self._trace, self._trace_done = None, True

    def _finish(self) -> None:
        self._stop_trace()          # a run that ended before step 20
        self._close_steps()
        self.save_checkpoint()
        self.ckpt.wait()
        pdist.barrier()          # the checkpoint exists for every rank

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> None:
        """Rank 0 writes the (replica-identical) state; the others skip."""
        if self.is_main:
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

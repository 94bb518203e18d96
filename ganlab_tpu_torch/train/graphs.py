"""The off-run of a lazy-regularization cycle as a CUDA graph.

The JAX package compiles a cycle's off-run (the steps on which no
regularizer fires) as one ``lax.scan`` program, so that the host issues two
dispatches a cycle instead of one a step
(``ganlab_tpu/train/steps.py::make_chunked_stepper``). Its counterpart on
the card is a CUDA graph of the same steps: ``OffRunGraphs`` captures the
eager loop of the step function over a segment of the cycle once per
off-run variant, and replays it on later cycles, one launch a segment. The
per-step arithmetic is the eager step's: the graph is captured from the
same function, and each replay reads what changes from step to step from
the graph's static inputs:

* the segment's uint8 batches, copied into one static (n, B, H, W, C)
  buffer;
* the fade-in alpha of each step (in a fade phase) and the G-EMA's beta
  (under ``optim.ema_rampup``), one 0-d tensor a step, written from the
  host's counters before each replay;
* the state itself, whose tensors the step updates in place (parameters,
  Adam moments and capturable step counts, the G-EMA, ``w_avg``,
  ``pl_mean``, ``ada_p``), and the state's random generator, registered
  with every graph so that each replay draws on from where the last draw
  ended.

Each step writes its metrics into its own row of the graph's (n,) outputs,
which a replay returns as copies. The host's counters (``state.step``,
``shown_imgs``) advance by n after a replay. Every kernel launch of ours
that a capture records is counted once a replay on its wrapper's
``launches`` (and ``nhwc_launches``: ``ops/kernels/__init__.py::COUNTS``,
``launch_counters``), not at the capture, which launches nothing.

One memory pool and one side stream serve all graphs of a phase: the
eager warm-up that precedes each capture runs on that stream (cuBLAS's
workspace and cuDNN's plans for it are then made outside the capture), and
so does the capture. A capture that fails raises; nothing falls back to
the eager steps. ``close`` releases the graphs and their pool.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ganlab_tpu_torch.ops.kernels import COUNTS, launch_counters
from ganlab_tpu_torch.train.steps import run_steps
from ganlab_tpu_torch.utils.spans import span


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    real: torch.Tensor                  # (n, B, H, W, C) uint8, static
    alphas: torch.Tensor | None         # (n,) compute dtype, in a fade
    betas: torch.Tensor | None          # (n,) float32, under ema_rampup
    metrics: dict                       # key -> (n,) float32, the output
    launches: list                      # per count: launches a replay


def _counts() -> list:
    """(wrapper, attribute) of every launch count."""
    return [(w, a) for w in launch_counters() for a in COUNTS
            if hasattr(w, a)]


class OffRunGraphs:
    """CUDA graphs of one phase's off-runs of the step function ``fn``
    (``build_train_step``'s), keyed by variant: each captures
    ``run_steps(fn, ...)`` over a stack. ``fn.alpha_moves`` /
    ``fn.beta_moves`` say whether the step reads alpha / beta from the
    graph's inputs, ``fn.scalars(shown, batch)`` gives their host values
    for a step, ``fn.compute_dtype`` alpha's dtype."""

    def __init__(self, device: torch.device, fn: Callable):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "graphed off-runs need torch.cuda.CUDAGraph."
                "register_generator_state (the state's own generator must "
                f"advance with each replay); torch {torch.__version__} has "
                "none")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._fn = fn
        self._graphs: dict = {}
        self.capture_s: dict = {}           # key -> seconds of its capture

    def warm_up(self, state, stack):
        """The eager steps over ``stack`` on the graphs' stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = run_steps(self._fn, state, stack)
        current.wait_stream(self.stream)
        return out

    def replay(self, key, state, stack):
        """The steps over ``stack`` as variant ``key``'s graph, captured
        at its first call; returns (state, metrics)."""
        with span("graph.replay"):
            return self._replay(key, state, stack)

    def _replay(self, key, state, stack):
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(key, state, stack)
        n, batch = stack.shape[0], stack.shape[1]
        g.real.copy_(stack)
        if g.alphas is not None or g.betas is not None:
            vals = [self._fn.scalars(state.shown_imgs + j * batch, batch)
                    for j in range(n)]
            for buf, i in ((g.alphas, 0), (g.betas, 1)):
                if buf is not None:
                    host = torch.tensor([v[i] for v in vals]).to(buf.dtype)
                    buf.copy_(host.pin_memory(), non_blocking=True)
        g.graph.replay()
        for (wrapper, attr), count in zip(_counts(), g.launches):
            setattr(wrapper, attr, getattr(wrapper, attr) + count)
        state.step += n
        state.shown_imgs += n * batch
        return state, {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, key, state, stack) -> _Graph:
        n = stack.shape[0]
        real = stack.clone()
        fn = self._fn
        alphas = torch.empty(n, dtype=fn.compute_dtype, device=self.device) \
            if fn.alpha_moves else None
        betas = torch.empty(n, dtype=torch.float32, device=self.device) \
            if fn.beta_moves else None
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        counts = _counts()
        before = [getattr(w, a) for w, a in counts]
        counters = (state.step, state.shown_imgs)
        t0 = time.perf_counter()
        try:
            # thread_local: the data pipeline's thread pins and copies the
            # next batches meanwhile, on a stream of its own
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                _, metrics = run_steps(fn, state, real, alphas=alphas,
                                       betas=betas)
        finally:
            # the capture ran the host's side of n steps and launched
            # nothing: the counters are where they were
            state.step, state.shown_imgs = counters
            launches = [getattr(w, a) - b
                        for (w, a), b in zip(counts, before)]
            for (w, a), b in zip(counts, before):
                setattr(w, a, b)
        self.capture_s[key] = time.perf_counter() - t0
        return _Graph(graph, real, alphas, betas, metrics, launches)

    def close(self) -> None:
        """Release the graphs (and with the last of them their pool)."""
        self._graphs.clear()

"""StyleGAN2 training traffic: the program's chunked stepper with lazy R1
and lazy path length over whole cycles.

Traffic parameters (``traffic/<mix>.json``), as ``train``'s: ``stepper``
(``chunked`` only: ``make_chunked_stepper``, as ``Trainer`` runs it with
``run.chunk_steps``), ``batch`` and ``resolution``, ``min_cycles``,
``pool_batches`` (a multiple of the cycle), ``stage_steps`` and
``reference_rows`` (the rows a block of the reference takes, the
path-length term's included).

A cycle of k = ``penalty_every`` steps with path length every
``pl_every`` = p steps (p dividing k) runs, per group of p steps, one
eager head step (R1 and path length at the cycle's head, path length
alone at the others) and the p - 1 steps on which nothing fires, one
CUDA-graph replay on a card. Set-up, window and the check are
``train``'s: set-up builds one state from the seed (the reference's
parameter lists ``reference.stylegan2``, weights made on the device, and
the path lengths' running mean at 0), runs two cycles (the eager
warm-up, then the captures and their first replays), and the window as
many whole cycles as fit.

The check adds the path-length term to ``train``'s:

* the start: step 0 from the seed, where R1 and path length both fire;
  the hooks also read the running mean of the path lengths step 0 leaves
  (at the next step's D update);
* the stage: a head step of one more cycle after the window, its state
  copied at its G update and the running mean at the next D forward
  (the program moves the mean after G's Adam step); with ``stage_steps``
  = p the reference follows the p - 1 replayed steps and the next head's
  D phase and path-length penalty;
* ``pl_err``: the program's path-length penalty against the reference's
  at step 0 and on each followed step, |prog - ref| / max(|ref|,
  ``PL_FLOOR``), the worst; ``pl_mean_err``: the running mean after step
  0, |prog - ref| / |ref| (first order in the lengths' mean);
* ``stage_traj_err``: the followed steps' losses and batch-mean scores,
  each |prog - ref| over the largest magnitude the reference's losses,
  or its scores, reach over the stage (at least 1), the worst.
  ``train``'s ``stage_err`` divides a step's scores by that step's own:
  over several followed steps D's scores can swing by tens between two
  steps (a bfloat16 and a float32 trajectory apart by a few per cent of
  the swing), and a step whose scores then cross zero reads the swing's
  error against 1.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import inputs
from portbench.drivers.train import (
    Start,
    StageSnapshot,
    _host,
    another_cycle,
    build_state,
    sampler,
)
from portbench.reference import model as M
from portbench.reference import stylegan2 as S2
from portbench.reference import train_sg2 as ref_train
from portbench.reference.compare import train_detail, train_gaps
from portbench.work import stylegan2 as W

METRICS = ("d_loss", "penalty", "g_loss", "real_score", "fake_score",
           "pl_penalty")
PL_FLOOR = 1e-3     # a penalty under this reads its error against it


def weights(m: dict, seed: int, device) -> tuple[dict, dict]:
    """The G and D parameters of run seed ``seed`` (float32, on the
    device), from ``inputs``'s streams."""
    return (M.make_params(S2.g_spec(m), inputs.sub_seed(seed,
                                                        inputs.G_WEIGHTS),
                          device),
            M.make_params(S2.d_spec(m), inputs.sub_seed(seed,
                                                        inputs.D_WEIGHTS),
                          device))


class PLStart(Start):
    """``Start``, and the running mean of the path lengths that step 0
    leaves, read before D's second update."""

    def _pre(self, opt, args, kwargs):
        if self.calls["d"] == 1:
            self.out["pl_mean"] = float(self.state.pl_mean)
        super()._pre(opt, args, kwargs)


class PLSnapshot(StageSnapshot):
    """``StageSnapshot``, and the running mean of the path lengths as the
    head step leaves it, read at the next D forward."""

    def _copy(self, state):
        super()._copy(state)
        handle = None

        def read(module, args):
            handle.remove()
            self.out["pl_mean"] = _host(state.pl_mean)

        handle = state.d.register_forward_pre_hook(read)


def _rows(ms: list) -> list:
    rows = []
    for m in ms:
        cols = [torch.atleast_1d(m[k]).float().tolist() for k in METRICS]
        rows += [dict(zip(METRICS, r)) for r in zip(*cols)]
    return rows


def pl_gap(prog: dict, ref: dict) -> float:
    """The worst |prog - ref| / max(|ref|, PL_FLOOR) of the path-length
    penalty, at step 0 and on each followed step."""
    pairs = list(zip(prog["pl"], ref["pl"], strict=True))
    if "stage" in ref:
        if len(prog.get("stage", [])) != len(ref["stage"]):
            return math.inf
        pairs += [(p.get("pl_penalty", math.nan), r["pl_penalty"])
                  for p, r in zip(prog["stage"], ref["stage"])
                  if "pl_penalty" in r]
    worst = 0.0
    for a, b in pairs:
        if not (math.isfinite(a) and math.isfinite(b)):
            return math.inf
        worst = max(worst, abs(a - b) / max(abs(b), PL_FLOOR))
    return worst


def stage_traj_gap(prog: list, ref: list) -> float:
    """The worst |prog - ref| of the followed steps' losses and batch-mean
    scores, over the largest magnitude the reference's losses (for a
    loss) or scores (for a score) reach over the stage, at least 1."""
    if len(prog) != len(ref) or not ref:
        return math.inf
    scale = {kind: max([1.0] + [abs(r[k]) for r in ref for k in keys
                                if k in r])
             for kind, keys in (("loss", ("d_loss", "g_loss")),
                                ("score", ("real_score", "fake_score")))}
    worst = 0.0
    for p, r in zip(prog, ref):
        for k in ("d_loss", "g_loss", "real_score", "fake_score"):
            if k not in r:
                continue
            a, b = p.get(k, math.nan), r[k]
            if not (math.isfinite(a) and math.isfinite(b)):
                return math.inf
            worst = max(worst, abs(a - b) / scale[
                "loss" if k.endswith("loss") else "score"])
    return worst


def gaps(prog: dict, ref: dict) -> dict:
    """``train``'s gaps and the path-length term's and the stage's over
    its trajectory."""
    out = train_gaps(prog, ref)
    if "stage" in ref:
        out["stage_traj_err"] = stage_traj_gap(prog.get("stage", []),
                                               ref["stage"])
    out["pl_err"] = pl_gap(prog, ref)
    a, b = prog["pl_mean"], ref["pl_mean"]
    out["pl_mean_err"] = abs(a - b) / abs(b) if b and math.isfinite(a) \
        else (0.0 if a == b else math.inf)
    return out


def run(h):
    from ganlab_tpu_torch.train.schedule import build_phases
    from ganlab_tpu_torch.train.steps import make_chunked_stepper

    t, m, dev = h.traffic, h.model, h.device
    B, k = t["batch"], h.c["loss"]["penalty_every"]
    S = t["stage_steps"]
    phase = build_phases(h.cfg.schedule, h.cfg.model)[0]
    if (phase.resolution, phase.batch_size) != (t["resolution"], B):
        raise ValueError(f"the configuration runs {phase.resolution}^2 at "
                         f"batch {phase.batch_size}; the traffic asks "
                         f"{t['resolution']}^2 at batch {B}")
    if t["stepper"] != "chunked" or t["pool_batches"] % k:
        raise ValueError("train_sg2 traffic: the chunked stepper, and "
                         "pool_batches a multiple of the penalty interval")
    P_g, P_d = weights(m, h.seed, dev)
    state = build_state(h, P_g, P_d)
    state.pl_mean = torch.zeros((), device=dev)
    pool = inputs.reals(m, t["pool_batches"], B, h.seed, dev)
    start = PLStart(state, P_g, P_d, sampler(h))
    del P_g, P_d
    stepper, kk = make_chunked_stepper(h.cfg, phase)
    if kk != k:
        raise ValueError(f"the stepper's cycle is {kk} steps, not {k}")
    stacks = pool.view(-1, k, *pool.shape[1:])
    calls = 0

    def cycle():
        nonlocal state, calls
        with h.span("train.cycle"):
            state, ms = stepper(state, stacks[calls % len(stacks)])
        calls += 1
        return ms

    first = [cycle(), cycle()]      # eager warm-up (step 0 compared),
                                    # then the captures and first replays
    if not {"scores", "grad_d", "grad_g", "w_avg", "pl_mean"} \
            <= set(start.out) or set(start.out["delta"]) != {"d", "g",
                                                             "g_ema"}:
        raise RuntimeError("set-up did not reach the compared steps")
    row0 = _rows(first)[0]
    prog = dict(start.out, losses=[[row0[key] for key in
                                    ("d_loss", "penalty", "g_loss")]],
                pl=[row0["pl_penalty"]])
    h.setup_done()
    n, longest = 0, 0.0
    with h.window():
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            if not another_cycle(n, t["min_cycles"], a - t0, longest,
                                 h.seconds):
                break
            cycle()
            h.sync()
            longest = max(longest, time.perf_counter() - a)
            n += 1
        window_s = time.perf_counter() - t0
    h.read_memory()
    images = n * k * B
    # one more cycle: its head step's state, the replayed segment after it
    # and the next head
    batches = [(calls % len(stacks)) * k + j for j in range(1, S + 1)]
    stage = PLSnapshot(state)
    rows = _rows([cycle()])
    h.sync()
    if stage.out is None or "pl_mean" not in stage.out:
        raise RuntimeError("no head step after the stage snapshot")
    prog["stage"] = rows[1:S + 1]
    stepper.close()
    del state, stepper, pool, stacks, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    elem = torch.finfo(getattr(torch, h.c["run"]["compute_dtype"])).bits // 8
    work = dict(W.window_work(h.c, B, n, h.kernel_files, elem, h.peaks),
                window_s=window_s)
    h.log(f"window: {n} cycles of {k} steps, {images} images in "
          f"{window_s:.4f} s (longest cycle {longest:.4f} s; "
          f"{2 * k} set-up steps, set-up {h.setup_s:.3f} s)")

    # -- the check ---------------------------------------------------------
    t0 = time.perf_counter()
    ref = reference(h, stage.out, batches)
    out = gaps(prog, ref)
    h.log(f"reference: step 0 and {S} stage steps in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in train_detail(prog, ref):
        h.log(line)
    h.log(f"path length: penalty program {prog['pl']} reference "
          f"{ref['pl']}, stage program "
          f"{[r['pl_penalty'] for r in prog['stage']]} reference "
          f"{[r.get('pl_penalty') for r in ref['stage']]}; pl_mean "
          f"program {prog['pl_mean']!r} reference {ref['pl_mean']!r}")
    return {"end_to_end": {"train_img_per_s": images / window_s},
            "attempted": n * k, "failed": 0, "work": work, "gaps": out}


def reference(h, snap, batches, prec=M.F32, fault=None,
              keep_state=False) -> dict:
    """The plain float32 reference (``prec``, ``fault``: the control and
    the planted faults in the program's place): step 0 from the inputs
    made again from the seed, then, with a snapshot, the stage steps from
    it on the pool's ``batches``."""
    t, m, dev = h.traffic, h.model, h.device
    P_g, P_d = weights(m, h.seed, dev)
    pool = inputs.reals(m, t["pool_batches"], t["batch"], h.seed, dev)
    first = pool[0].clone()
    del pool
    with h.reference_precision():
        out = ref_train.first_step(
            h.c, P_g, P_d, first, inputs.sub_seed(h.seed, inputs.STEP_DRAWS),
            dev, t["reference_rows"], sampler(h), prec, fault, keep_state)
    del P_g, P_d, first
    if snap is not None:
        out["stage"] = stage_reference(h, snap, batches, prec, fault)
    return out


def stage_reference(h, snap, batches, prec=M.F32, fault=None) -> list:
    """The stage steps from ``snap`` on the pool's ``batches``."""
    t, m, dev = h.traffic, h.model, h.device
    pool = inputs.reals(m, t["pool_batches"], t["batch"], h.seed, dev)
    reals = [pool[i].clone() for i in batches]
    del pool
    with h.reference_precision():
        return ref_train.follow(h.c, snap, reals, dev, t["reference_rows"],
                                prec, fault)

"""One rank of the port's two-process data-parallel tests.

``python tests/torch_dist_worker.py <rank> <world> <port> <outdir>`` joins
a ``gloo`` process group on ``tcp://localhost:<port>`` on the CPU and
runs, as this rank of the world:

1. ``steps``: three steps of a small ``stylegan-256`` (R1 on steps 0 and
   2), each rank fed its shard of ``global_batch(i)``; writes the state's
   tensors, the metrics, the D latents each step drew and the G-EMA
   betas the steps used;
2. ``pl``: two path-length steps of a small ``stylegan2-256``; writes the
   state and each step's local mean length and new ``pl_mean``;
   ``composed``: one step of the first configuration with
   ``optim.grad_accum`` = 2 on each rank, its gradients; ``ada``: three
   steps of the first configuration with ``aug.mode=ada`` and all six
   categories (each rank's draws, rt averaged over the ranks, ``ada_p``);
   ``fused_seq``: the three steps under ``loss.fused_seq``; ``same_*``:
   three steps of ``loss.fused_g_step`` and of ``loss.reg_separate`` with
   every rank fed the same shard and the same injected draws;
   ``chunked``: the chunked stepper over two cycles and a tail of the
   first configuration;
3. ``trainer``: a ``Trainer`` on one shared workdir for three steps, then
   a second ``Trainer`` restored from that workdir: whether it holds the
   live state bit for bit and whether both stay equal over two more steps
   on the same batches; which files each rank wrote; whether the rank's
   data source is ``make_source(seed=run.seed + 7919 * rank)``.

``tests/test_torch_dist.py`` starts two of these and holds what they
write against the port's ``optim.grad_accum`` = 2 step in one process.
The configurations and batches are defined here for both sides.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

MICRO = 2                       # images a rank (a microbatch) a step
RES = 16
SMALL = {"model.resolution": RES, "model.fmap_base": 64,
         "model.fmap_max": 8, "model.latent_dim": 8,
         "model.mapping_layers": 1, "run.compute_dtype": "float32",
         "schedule.progressive": False,
         "schedule.batch_schedule": {RES: MICRO},
         "data.dataset": "synthetic"}


def steps_cfg(**over):
    from ganlab_tpu_torch.config import get_config

    return get_config("stylegan-256", **dict(
        SMALL, **{"loss.penalty_every": 2, "optim.ema_kimg": 0.01}, **over))


def pl_cfg(**over):
    from ganlab_tpu_torch.config import get_config

    return get_config("stylegan2-256", **dict(
        SMALL, **{"loss.penalty_every": 2, "loss.pl_every": 1}, **over))


def ada_cfg(**over):
    """``steps_cfg`` with adaptive augmentation of every category, p
    starting at 0.5 and moving 0.04 a step of the global batch of 4."""
    return steps_cfg(**{"aug.mode": "ada", "aug.categories": "bcgfnu",
                        "aug.p_init": 0.5, "aug.kimg": 0.1}, **over)


def same_cfg(recipe: str):
    """``steps_cfg`` under ``loss.<recipe>`` with a G-EMA beta that does
    not depend on the global batch (``optim.ema_kimg`` 0: ``ema_beta``)."""
    from ganlab_tpu_torch.config import get_config

    return get_config("stylegan-256", **dict(
        SMALL, **{"loss.penalty_every": 2, "optim.ema_kimg": 0.0,
                  f"loss.{recipe}": True}))


def trainer_cfg():
    from ganlab_tpu_torch.config import get_config

    # a row every step (chunked stepping logs once a chunk)
    return get_config("stylegan-256", **dict(
        SMALL, **{"loss.penalty_every": 2, "run.log_every": 1,
                  "run.chunk_steps": False,
                  "run.checkpoint_every": 0, "run.sample_every": 0,
                  "schedule.total_kimg": 1.0}))


def global_batch(i: int, world: int = 2) -> torch.Tensor:
    """Step i's images for all ranks, rank-major: rank r's shard is
    ``[r * MICRO, (r + 1) * MICRO)``."""
    rs = np.random.RandomState(100 + i)
    return torch.from_numpy(
        rs.randint(0, 256, (MICRO * world, RES, RES, 3)).astype(np.uint8))


def _tensors(state) -> dict:
    from ganlab_tpu_torch.train import state_tensors

    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in state_tensors(state).items()}


def record_draws(tsteps) -> list:
    """Wrap ``draw_step`` in ``tsteps`` to keep each call's D latents."""
    seen, draw = [], tsteps.draw_step

    def recording(*a, **k):
        out = draw(*a, **k)
        seen.append(out.d.z1.clone())
        return out

    tsteps.draw_step = recording
    return seen


def record_betas(tsteps) -> list:
    seen, update = [], tsteps._ema_update

    def recording(ema, model, beta):
        seen.append(beta)
        return update(ema, model, beta)

    tsteps._ema_update = recording
    return seen


def run_steps(cfg, n: int, rank: int, world: int,
              live: bool = False) -> tuple:
    """n lazy steps from seed 0; this rank's shard of global_batch(i), its
    ``optim.grad_accum`` microbatches (the whole global batch in one
    process). ``live``: every term of G and D made live first (at init
    the 4x4 planes are constant, where AdaIN's gradient is rounding noise
    times 1e4)."""
    from ganlab_tpu_torch.parallel import dist as pdist
    from ganlab_tpu_torch.train import (
        build_phases,
        create_train_state,
        make_lazy_stepper,
    )

    state = create_train_state(cfg, seed=0, device="cpu")
    if live:
        gen = torch.Generator().manual_seed(6)
        with torch.no_grad():
            for net in (state.g, state.d):
                for k, v in net.state_dict().items():
                    if k.endswith(("noise.scale", ".bias", ".b", "const")):
                        v += 0.2 * torch.randn(v.shape, generator=gen)
    pdist.broadcast_state(state)
    stepper = make_lazy_stepper(cfg, build_phases(cfg.schedule,
                                                  cfg.model)[-1])
    metrics, feed = [], MICRO * cfg.optim.grad_accum
    for i in range(n):
        batch = global_batch(i, world * cfg.optim.grad_accum)
        state, m = stepper(state, batch[rank * feed:(rank + 1) * feed])
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def part_steps(rank: int, world: int, cfg=None) -> dict:
    """Three steps of ``steps_cfg()`` (or ``cfg``) with the draws and the
    G-EMA betas recorded."""
    from ganlab_tpu_torch.train import steps as tsteps

    saved = tsteps.draw_step, tsteps._ema_update
    draws, betas = record_draws(tsteps), record_betas(tsteps)
    try:
        state, metrics = run_steps(cfg or steps_cfg(), 3, rank, world)
    finally:
        tsteps.draw_step, tsteps._ema_update = saved
    return {"tensors": _tensors(state), "metrics": metrics,
            "draws": draws, "betas": betas, "shown": state.shown_imgs,
            "step": state.step}


# the chunked stepper's calls over the batches 0..4 of ``steps_cfg`` (R1
# every 2nd step): two cycles, then a tail of one
CHUNKS = ((0, 2), (2, 4), (4, 5))


def part_chunked(rank: int, world: int, cfg=None) -> dict:
    """``make_chunked_stepper`` over ``CHUNKS`` of ``steps_cfg()`` (or
    ``cfg``), each rank fed its shards of ``global_batch(i)`` stacked (the
    off-run's steps run eagerly under a process group): the state, each
    call's consumed count and the stacked metrics."""
    from ganlab_tpu_torch.parallel import dist as pdist
    from ganlab_tpu_torch.train import build_phases, create_train_state
    from ganlab_tpu_torch.train.steps import make_chunked_stepper

    cfg = cfg or steps_cfg()
    state = create_train_state(cfg, seed=0, device="cpu")
    pdist.broadcast_state(state)
    stepper, _ = make_chunked_stepper(
        cfg, build_phases(cfg.schedule, cfg.model)[-1])
    feed = MICRO * cfg.optim.grad_accum
    stack = torch.stack([
        global_batch(i, world * cfg.optim.grad_accum)[
            rank * feed:(rank + 1) * feed] for i in range(CHUNKS[-1][1])])
    consumed, metrics = [], []
    for lo, hi in CHUNKS:
        state, m = stepper(state, stack[lo:hi])
        consumed.append(len(m["d_loss"]))
        metrics.append({k: v.tolist() for k, v in m.items()})
    return {"tensors": _tensors(state), "consumed": consumed,
            "metrics": metrics}


def part_composed(rank: int, world: int, accum: int) -> dict:
    """One R1 step of ``steps_cfg`` with ``accum`` microbatches a rank,
    every term live and D's lr 0: the gradients, the generator's state
    and the counters. (Adam's first update, with beta1 = 0, is about
    lr * sign(g): where D's gradient is about 0, a rounding of another
    summation order would move D, and G's gradient with it, by up to
    2 lr.)"""
    state, _ = run_steps(steps_cfg(**{"optim.grad_accum": accum,
                                      "optim.lr_d": 0.0}), 1, rank, world,
                         live=True)
    grads = {f"{net}.{k}": p.grad.clone()
             for net in ("g", "d")
             for k, p in getattr(state, net).named_parameters()
             if p.grad is not None}
    return {"grads": grads, "generator": state.generator.get_state(),
            "counters": (state.step, state.shown_imgs)}


def part_same(rank: int, world: int, recipe: str) -> dict:
    """Three steps of ``same_cfg(recipe)`` (penalty on steps 0 and 2), every
    rank fed the first shard of ``global_batch(i)`` and the same injected
    draws: the mean over the ranks of equal gradients is the gradient, so
    the state is one process's step's."""
    from ganlab_tpu_torch.parallel import dist as pdist
    from ganlab_tpu_torch.train import (
        build_phases,
        create_train_state,
        make_lazy_stepper,
    )
    from ganlab_tpu_torch.train import steps as tsteps

    cfg = same_cfg(recipe)
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    pdist.broadcast_state(state)
    stepper = make_lazy_stepper(cfg, phase)
    metrics = []
    for i in range(3):
        draws = tsteps.draw_step(cfg, phase.res_log2, MICRO,
                                 torch.Generator().manual_seed(50 + i), "cpu")
        state, m = stepper(state, global_batch(i)[:MICRO], draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"tensors": _tensors(state), "metrics": metrics,
            "counters": (state.step, state.shown_imgs)}


def part_pl(rank: int, world: int) -> dict:
    from ganlab_tpu_torch.train import steps as tsteps

    seen, penalty = [], tsteps.path_length_penalty

    def recording(g, pl_mean, dr, *a, **k):
        out = penalty(g, pl_mean, dr, *a, **k)
        seen.append((float(pl_mean), float(out[2].mean()), float(out[1])))
        return out

    tsteps.path_length_penalty = recording
    try:
        state, metrics = run_steps(pl_cfg(), 2, rank, world)
    finally:
        tsteps.path_length_penalty = penalty
    return {"tensors": _tensors(state), "metrics": metrics, "pl": seen}


def part_trainer(rank: int, outdir: str) -> dict:
    from ganlab_tpu_torch.data import make_source
    from ganlab_tpu_torch.train import Trainer, build_phases
    from ganlab_tpu_torch.train.steps import make_lazy_stepper

    cfg = trainer_cfg()
    wd = os.path.join(outdir, "run")
    tr = Trainer(cfg, workdir=wd, device="cpu")
    own = make_source(cfg.data, RES, seed=cfg.run.seed + 7919 * rank)
    first = tr.source.batch(MICRO, RES)
    out = {"source_seeded": bool(np.array_equal(first,
                                                own.batch(MICRO, RES))),
           "first_batch": first}
    tr.train(max_steps=3)
    out["shown"], out["step"] = tr.state.shown_imgs, tr.state.step
    live = tr.state
    tr.close()
    again = Trainer(cfg, workdir=wd, device="cpu")
    a, b = _tensors(live), _tensors(again.state)
    out["restored_equal"] = a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    steppers = [make_lazy_stepper(cfg, phase, initial_step=s.step)
                for s in (live, again.state)]
    for i in range(2):
        batch = global_batch(10 + i)[rank * MICRO:(rank + 1) * MICRO]
        for stepper, s in zip(steppers, (live, again.state)):
            stepper(s, batch)
    a, b = _tensors(live), _tensors(again.state)
    out["continued_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    out["tensors"] = b
    again.close()
    return out


def main(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    from ganlab_tpu_torch.parallel import dist as pdist

    pdist.initialize("gloo", device="cpu", rank=rank, world_size=world,
                     init_method=f"tcp://localhost:{port}")
    try:
        result = {"steps": part_steps(rank, world),
                  "pl": part_pl(rank, world),
                  "composed": part_composed(rank, world, 2),
                  "ada": part_steps(rank, world, ada_cfg()),
                  "fused_seq": part_steps(rank, world, steps_cfg(
                      **{"loss.fused_seq": True})),
                  **{f"same_{r}": part_same(rank, world, r)
                     for r in ("fused_g_step", "reg_separate")},
                  "chunked": part_chunked(rank, world),
                  "trainer": part_trainer(rank, outdir),
                  "world": pdist.world_size(), "rank": pdist.rank()}
    finally:
        pdist.shutdown()
    torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

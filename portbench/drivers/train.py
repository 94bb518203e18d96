"""Training traffic: the program's lazy-R1 stepper over whole cycles.

Traffic parameters (``traffic/<mix>.json``): ``stepper`` is ``chunked``
(``make_chunked_stepper``: per cycle the R1 head step, then the off-run,
a CUDA-graph replay on a card, as ``Trainer`` runs it with
``run.chunk_steps``) or ``lazy`` (``make_lazy_stepper``, one call a step,
as ``Trainer`` runs it without chunking); ``batch`` and ``resolution``;
``min_cycles``; ``pool_batches``, the distinct uint8 batches made on the
device and fed in turn; ``setup_steps`` (lazy), the steps set-up runs;
``stage_steps``, the steps after a head step that the reference follows
from the program's state; ``reference_rows``, the rows a block of the
reference's discriminator takes.

Set-up builds one training state from the seed (weights made on the
device), makes the stepper, and drives it through its first steps, which
warm every shape the window uses: chunked, two cycles (the eager
warm-up, then the capture and its first replay); lazy, an R1 step and
off steps. The window then runs a whole number of cycles (16 steps hold
one R1 step wherever they start), as many as fit into ``--seconds`` at
the cycle time of the longest cycle so far, and at least ``min_cycles``;
the host waits for the card at the end of each cycle.

The check has two parts, both through the window's own stepper and
state:

* the start: hooks on the optimizers read step 0's first gradients (D's
  with R1, G's), the change of D and G after their first Adam step, and
  of the G-EMA and w-average after step 0; the reference runs step 0 from
  the seed;
* the stage after a head step: a hook at the head step's G update copies
  the program's state (parameters, Adam moments, generator); the
  reference follows the next ``stage_steps`` steps from it and is held to
  the metrics the program returned for them. Lazy: step 0 of set-up.
  Chunked: the head step of one more cycle after the window, so that the
  steps compared are a replay of the graph the window replayed.
"""

from __future__ import annotations

import copy
import gc
import time

import torch

from portbench import inputs
from portbench.reference import model as M
from portbench.reference import train as ref_train
from portbench.reference.compare import sample, train_detail, train_gaps
from portbench.work import flops, ops


def build_state(h, P_g, P_d):
    """A ``TrainState`` of the program holding the given weights, made as
    ``create_train_state`` makes one (same optimizers, G-EMA, w-average
    and step generator), with the weights filled in on the device."""
    from ganlab_tpu_torch.models import build_models
    from ganlab_tpu_torch.train.state import TrainState, make_optimizers

    cfg, dev = h.cfg, h.device
    with torch.device("meta"):
        g, d = build_models(cfg.model)
    g, d = g.to_empty(device=dev), d.to_empty(device=dev)
    g.load_state_dict(P_g, strict=True)
    d.load_state_dict(P_d, strict=True)
    g_ema = copy.deepcopy(g).requires_grad_(False)
    opt_g, opt_d = make_optimizers(cfg, g, d)
    gen = torch.Generator(device=dev).manual_seed(
        inputs.sub_seed(h.seed, inputs.STEP_DRAWS))
    return TrainState(g=g, d=d, g_ema=g_ema, opt_g=opt_g, opt_d=opt_d,
                      w_avg=torch.zeros(cfg.model.latent_dim, device=dev),
                      generator=gen)


class Start:
    """Hooks that read, from the program's own state at step 0: D's
    scores of its first two forwards (the real rows, then the fake rows);
    the first gradients and each leaf's change after its first Adam step
    (``sample``d); the G-EMA's change and the w-average before D's second
    update, when step 0 has left them."""

    def __init__(self, state, P_g, P_d, sample):
        self.state, self.P_g, self.P_d = state, P_g, P_d
        self.sample = sample
        self.out: dict = {"delta": {}}
        self.calls = {"d": 0, "g": 0}
        self._scores: list = []
        self._handles = [
            state.d.register_forward_hook(self._forward),
            state.opt_d.register_step_post_hook(self._post("d", state.d,
                                                           P_d)),
            state.opt_g.register_step_post_hook(self._post("g", state.g,
                                                           P_g)),
            state.opt_d.register_step_pre_hook(self._pre)]

    def _forward(self, module, args, output):
        if len(self._scores) < 2:
            self._scores.append(output.detach().float().clone())
            if len(self._scores) == 2:
                self.out["scores"] = torch.cat(self._scores).tolist()

    def _post(self, net, module, P0):
        def hook(opt, args, kwargs):
            self.calls[net] += 1
            if self.calls[net] == 1:
                ps = dict(module.named_parameters())
                self.out[f"grad_{net}"] = self.sample(
                    {n: p.grad for n, p in ps.items()})
                with torch.no_grad():
                    self.out["delta"][net] = self.sample(
                        {n: p - P0[n] for n, p in ps.items()})
        return hook

    def _pre(self, opt, args, kwargs):
        if self.calls["d"] != 1:
            return
        s = self.state
        with torch.no_grad():
            e = dict(s.g_ema.named_parameters())
            self.out["delta"]["g_ema"] = self.sample(
                {n: e[n] - self.P_g[n] for n in e})
            self.out["w_avg"] = s.w_avg.float().tolist()
        self.close()

    def close(self):
        for hd in self._handles:
            hd.remove()
        self._handles = []
        self.P_g = self.P_d = None


def _host(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy on the host (a copy on a CPU device too)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def _moments(opt, module) -> dict:
    out = {}
    for n, p in module.named_parameters():
        st = opt.state.get(p)
        if st:
            out[n] = (_host(st["exp_avg"]), _host(st["exp_avg_sq"]),
                      float(st["step"]))
    return out


class StageSnapshot:
    """A hook at the next G update: copies the program's state to the
    host as the step leaves it there (G and D updated; the G-EMA and
    w-average, which no later metric reads, not yet): parameters, both
    Adams' moments and the generator's state, from which the next step
    draws."""

    def __init__(self, state):
        self.out = None
        self._handle = state.opt_g.register_step_post_hook(
            lambda opt, args, kwargs: self._copy(state))

    def _copy(self, state):
        self._handle.remove()
        with torch.no_grad():
            self.out = {
                "g": {n: _host(p) for n, p in state.g.named_parameters()},
                "d": {n: _host(p) for n, p in state.d.named_parameters()},
                "moments_g": _moments(state.opt_g, state.g),
                "moments_d": _moments(state.opt_d, state.d),
                "gen": state.generator.get_state().clone()}


METRICS = ("d_loss", "penalty", "g_loss", "real_score", "fake_score")


def _rows(ms: list) -> list:
    """Per step, the metrics of a list of (stacked) metric dicts."""
    rows = []
    for m in ms:
        cols = [torch.atleast_1d(m[k]).float().tolist() for k in METRICS]
        rows += [dict(zip(METRICS, r)) for r in zip(*cols)]
    return rows


def another_cycle(done: int, min_cycles: int, elapsed: float,
                  longest: float, seconds: float) -> bool:
    """Whether the window runs one more whole cycle: until ``min_cycles``
    always, then only while one more of the longest so far ends within
    ``seconds``."""
    return done < min_cycles or elapsed + longest <= seconds


def window_work(m: dict, batch: int, k: int, cycles: int, kernel_files,
                elem: int, peaks) -> dict:
    """Model FLOPs and the kernels' least seconds of ``cycles`` whole
    cycles of ``k`` steps: each holds one R1 step and k - 1 off steps."""
    def per_cycle(f):
        return cycles * (f(True) + (k - 1) * f(False))

    least = {name: per_cycle(lambda r1, kf=kf: ops.least_seconds(
        m, kf["passes"], "train", batch, r1, elem, peaks)) if peaks else None
        for name, kf in kernel_files.items()}
    flops_ = per_cycle(lambda r1: flops.train_step_flops(m, batch, r1))
    return {"model_flops": flops_, "conv_flops": flops_, "least_s": least}


def run(h):
    from ganlab_tpu_torch.train.schedule import build_phases
    from ganlab_tpu_torch.train.steps import (
        make_chunked_stepper,
        make_lazy_stepper,
    )

    t, m, dev = h.traffic, h.model, h.device
    B, k = t["batch"], h.c["loss"]["penalty_every"]
    S = t["stage_steps"]
    phase = build_phases(h.cfg.schedule, h.cfg.model)[0]
    if (phase.resolution, phase.batch_size) != (t["resolution"], B):
        raise ValueError(f"the configuration runs {phase.resolution}^2 at "
                         f"batch {phase.batch_size}; the traffic asks "
                         f"{t['resolution']}^2 at batch {B}")
    P_g, P_d = inputs.weights(m, h.seed, dev)
    state = build_state(h, P_g, P_d)
    pool = inputs.reals(m, t["pool_batches"], B, h.seed, dev)
    chunked = t["stepper"] == "chunked"
    start = Start(state, P_g, P_d, sampler(h))
    del P_g, P_d
    first = []
    if chunked:
        stepper, kk = make_chunked_stepper(h.cfg, phase)
        if kk != k or t["pool_batches"] % k:
            raise ValueError("chunked traffic: pool_batches a multiple of "
                             "the penalty interval")
        stacks = pool.view(-1, k, *pool.shape[1:])
        calls = 0

        def cycle():
            nonlocal state, calls
            with h.span("train.cycle"):
                state, ms = stepper(state, stacks[calls % len(stacks)])
            calls += 1
            return ms

        first.append(cycle())           # eager warm-up, compared step 0
        first.append(cycle())           # capture and first replay
        steps_done = 2 * k
    else:
        stepper = make_lazy_stepper(h.cfg, phase)
        stage = StageSnapshot(state)    # the state step 0 leaves
        at = 0

        def step():
            nonlocal state, at
            with h.span("train.step"):
                state, ms = stepper(state, pool[at % len(pool)])
            at += 1
            return ms

        def cycle():
            with h.span("train.cycle"):
                for _ in range(k):
                    step()

        for _ in range(max(t["setup_steps"], S + 1)):
            first.append(step())
        steps_done = len(first)
    if not {"scores", "grad_d", "grad_g", "w_avg"} <= set(start.out) \
            or set(start.out["delta"]) != {"d", "g", "g_ema"}:
        raise RuntimeError("set-up did not reach the compared steps")
    prog = dict(start.out, losses=[[_rows(first)[0][key] for key in
                                     ("d_loss", "penalty", "g_loss")]])
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
    steps = n * k
    images = steps * B
    if chunked:
        # one more cycle of the window's call: its off-run replays the
        # graph that the window replayed
        batches = [(calls % len(stacks)) * k + j for j in range(1, S + 1)]
        stage = StageSnapshot(state)
        rows = _rows([cycle()])
        h.sync()
    else:
        batches = [j % len(pool) for j in range(1, S + 1)]
        rows = _rows(first)
    if stage.out is None:
        raise RuntimeError("no head step after the stage snapshot")
    prog["stage"] = rows[1:S + 1]
    close = getattr(stepper, "close", None)
    if close is not None:
        close()
    del state, stepper, pool, first, close
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    elem = torch.finfo(getattr(torch, h.c["run"]["compute_dtype"])).bits // 8
    work = dict(window_work(m, B, k, n, h.kernel_files, elem, h.peaks),
                window_s=window_s)
    h.log(f"window: {n} cycles of {k} steps, {images} images in "
          f"{window_s:.4f} s (longest cycle {longest:.4f} s; "
          f"{steps_done} set-up steps, set-up {h.setup_s:.3f} s)")

    # -- the check ---------------------------------------------------------
    t0 = time.perf_counter()
    ref = reference(h, stage.out, batches)
    gaps = train_gaps(prog, ref)
    h.log(f"reference: step 0 and {S} stage steps in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in train_detail(prog, ref):
        h.log(line)
    return {"end_to_end": {"train_img_per_s": images / window_s},
            "attempted": steps, "failed": 0,
            "work": work, "gaps": gaps}


def sampler(h):
    """The sampling of gradients and changes that both sides share."""
    seed = inputs.sub_seed(h.seed, inputs.SAMPLES)
    return lambda tensors: sample(tensors, seed)


def reference(h, snap, batches, prec=M.F32, fault=None,
              keep_state=False) -> dict:
    """The plain float32 reference (``prec``, ``fault``: the control and
    the planted faults in the program's place): step 0 from the inputs
    made again from the seed, then, with a snapshot, the stage steps from
    it on the pool's ``batches``."""
    t, m, dev = h.traffic, h.model, h.device
    P_g, P_d = inputs.weights(m, h.seed, dev)
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

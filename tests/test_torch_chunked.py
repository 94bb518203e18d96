"""Chunked lazy-regularization stepping (``make_chunked_stepper``), the
trainer's chunk cycle and ``load_jax_train_state`` under
``loss.reg_separate``, on the CPU.

The tiny configuration of ``tests/test_chunked.py`` (stylegan at 16x16,
K = ``loss.penalty_every`` = 4, batch 4, float32):

* the port's chunked stepper against the port's lazy stepper over the
  same batches, bit for bit (every tensor of the state, the generator's
  state included, and the stacked metrics): aligned full cycles, a
  misaligned start that runs only the steps up to the next cycle head and
  drops the rest of its stack, and a partial tail; under
  ``loss.fused_g_step`` (the JAX tests' recipe), the sequential step,
  ``loss.fused_seq``, ``loss.reg_separate``, path length every 2nd step
  (the off-run cut into segments between the PL steps, as
  ``tests/test_pl.py``), ADA (``ada_p`` moving through the off-run, as
  ``tests/test_augment.py``) and n-critic. A step that takes its alpha and
  G-EMA beta as tensors (what a CUDA graph of it reads) equals the eager
  step bit for bit in a fade phase and under ``optim.ema_rampup``;
* the port's chunked stepper against the JAX package's on the same
  parameters and the JAX steps' own draws (drawn here from the JAX
  state's key as its step draws them and injected into the port): the
  counts each call consumes, the stacked metrics within 1e-2 relative /
  2e-3 absolute and the parameters within ``tests/test_chunked.py``'s
  statistics (mean |diff| < 1e-4, max < 2.5e-2: ten steps of Adam, whose
  first steps move a parameter by lr x sign(g), turn float32 rounding on
  a gradient near 0 into a step of 2 lr);
* the port's ``Trainer`` with ``run.chunk_steps`` against the JAX
  package's on a tiny 4 -> 8 progressive schedule whose fade phase
  starts mid-cycle: the same ``(step, res, kind, shown_imgs, alpha)``
  rows (alpha within 1e-6), the logged ``penalty`` above 0 on each row of
  a full cycle (the chunk's largest: the fired one) and 0 on the
  realignment's row;
* ``load_jax_train_state`` of a ``reg_separate`` state (optax's count
  holds the penalty steps): ``opt_step0`` is where the moments began, and
  a D head seeded later takes optax's count;
* which configurations replay their off-runs as CUDA graphs, and so make
  their Adams ``capturable`` (``train/state.py::graphs_capture``).

The JAX side runs as its own tests run it (CPU, ``highest`` matmul
precision, ``tests/conftest.py``), built once a module. The graphed
off-run is held to the lazy stepper on the card by
``tests/test_torch_graphs.py`` and ``chip_smoke.py`` phase 16.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.layers import NoiseInjection
from ganlab_tpu.parallel import make_single_step
from ganlab_tpu.train.loop import Trainer as JaxTrainer
from ganlab_tpu.train.schedule import build_phases as jax_build_phases
from ganlab_tpu.train.state import create_train_state as jax_create_state
from ganlab_tpu.train.state import make_optimizers as jax_make_optimizers
from ganlab_tpu.train.steps import make_chunked_stepper as jax_chunked
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax, load_jax_train_state
from ganlab_tpu_torch.models.stylegan import num_style_layers
from ganlab_tpu_torch.train import (
    Trainer,
    build_phases,
    create_train_state,
    state_tensors,
)
from ganlab_tpu_torch.train import steps as tsteps
from ganlab_tpu_torch.train.state import graphs_capture
from ganlab_tpu_torch.train.steps import (
    make_chunked_stepper,
    make_lazy_stepper,
    stack_metrics,
)

torch.set_num_threads(1)

K = 4
B = 4
RES = 16
TINY = {"model.model": "stylegan", "model.resolution": RES,
        "model.latent_dim": 8, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.mapping_layers": 2, "schedule.progressive": False,
        "schedule.batch_schedule": {RES: B}, "loss.penalty_every": K,
        "run.compute_dtype": "float32"}
RECIPES = {
    "fused_g_step": {"loss.fused_g_step": True},
    "sequential": {},
    "fused_seq": {"loss.fused_seq": True},
    "reg_separate": {"loss.reg_separate": True},
    "pl": {"loss.pl_weight": 2.0, "loss.pl_every": 2},
    "ada": {"aug.mode": "ada", "aug.categories": "bcgfnu",
            "aug.p_init": 0.5, "aug.kimg": 0.1},
    "n_critic": {"loss.d_steps_per_g": 2},
}


def tiny_config(**over):
    return get_config("stylegan-256", **dict(TINY, **over))


def batches(n, seed=0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return np.stack([rs.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
                     for _ in range(n)])


def assert_bitwise(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb) and len(ta) > 100
    assert [k for k in ta if not torch.equal(ta[k], tb[k])] == []


def lazy_over(cfg, phase, stack, initial_step=0):
    state = create_train_state(cfg, seed=0, device="cpu")
    stepper = make_lazy_stepper(cfg, phase, initial_step=initial_step)
    ms = []
    for batch in stack:
        state, m = stepper(state, batch)
        ms.append(m)
    return state, stack_metrics(ms, "cpu")


# (initial step, pieces offered, consumed per piece): aligned cycles, a
# start two steps into a cycle (realigns on two steps, drops two batches),
# a partial tail
SCENARIOS = {"aligned": (0, [K, K], [K, K]),
             "misaligned": (2, [K, K], [K - 2, K]),
             "tail": (0, [K, 2], [K, 2])}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_chunked_equals_lazy_bitwise(recipe, scenario):
    cfg = tiny_config(**RECIPES[recipe])
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    initial, pieces, consumed = SCENARIOS[scenario]
    data = torch.from_numpy(batches(sum(pieces)))

    state = create_train_state(cfg, seed=0, device="cpu")
    stepper, k = make_chunked_stepper(cfg, phase, initial_step=initial)
    assert k == K
    parts, used, start = [], [], 0
    for n, want in zip(pieces, consumed):
        state, m = stepper(state, data[start:start + n])
        assert len(m["d_loss"]) == want
        assert all(v.shape == (want,) and v.dtype == torch.float32
                   for v in m.values())
        used.append(data[start:start + want])
        parts.append(m)
        start += n
    assert stepper.graphs is None              # the CPU runs it eagerly
    got = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    ref, want = lazy_over(cfg, phase, torch.cat(used), initial)
    assert_bitwise(ref, state)
    assert got.keys() == want.keys()
    assert [key for key in got if not torch.equal(got[key], want[key])] == []
    fired = [(initial + i) % K == 0 for i in range(len(got["penalty"]))]
    assert [bool(p > 0) for p in got["penalty"]] == fired
    if recipe == "pl":
        assert [bool(p > 0) for p in got["pl_penalty"]] == \
            [(initial + i) % 2 == 0 for i in range(len(got["penalty"]))]
    if recipe == "ada":
        # p moves every step, by batch / (aug.kimg * 1000) either way
        moves = torch.diff(torch.cat([torch.tensor([0.5]), got["aug_p"]]))
        torch.testing.assert_close(moves.abs(), torch.full_like(moves, 0.04))


def test_chunked_stepper_refuses_what_does_not_chunk():
    phase = build_phases(tiny_config().schedule, tiny_config().model)[-1]
    for over in ({"loss.penalty_every": 1}, {"loss.penalty": "none"},
                 {"loss.pl_weight": 2.0, "loss.pl_every": 3}):
        with pytest.raises(ValueError, match="chunked stepping"):
            make_chunked_stepper(tiny_config(**over), phase)


@pytest.mark.parametrize("over,phase_index", [
    ({"schedule.progressive": True, "schedule.start_res": 8,
      "schedule.fade_kimg": 0.04, "schedule.stabilize_kimg": 0.04,
      "schedule.batch_schedule": {8: B, RES: B}}, 1),
    ({"optim.ema_rampup": 0.05}, -1)], ids=["fade_alpha", "ema_rampup_beta"])
def test_step_takes_alpha_and_beta_as_tensors(over, phase_index):
    """What a CUDA graph of a step reads from its inputs, given as 0-d
    tensors holding the host's values, makes the same bits as the eager
    step that takes them from the host's counters."""
    cfg = tiny_config(**over)
    phase = build_phases(cfg.schedule, cfg.model)[phase_index]
    fn = tsteps.build_train_step(cfg, phase, penalty_override=False)
    data = torch.from_numpy(batches(3))
    a = create_train_state(cfg, seed=0, device="cpu")
    b = create_train_state(cfg, seed=0, device="cpu")
    a.shown_imgs = b.shown_imgs = phase.start_img + B
    for batch in data:
        alpha, beta = fn.scalars(b.shown_imgs, B)
        a, ma = fn(a, batch)
        b, mb = fn(b, batch,
                   alpha=torch.tensor(alpha).to(fn.compute_dtype)
                   if fn.alpha_moves else None,
                   beta=torch.tensor(beta) if fn.beta_moves else None)
        assert all(torch.equal(torch.as_tensor(ma[k]).float(),
                               torch.as_tensor(mb[k]).float()) for k in ma)
    assert fn.alpha_moves == (phase.kind == "fade")
    assert fn.beta_moves == ("optim.ema_rampup" in over)
    assert_bitwise(a, b)


# -- the port's chunked stepper against the JAX package's ---------------------

def _jax_noises(jg, batch):
    """``noises(params, key)``: the noise maps the JAX synthesis draws
    from ``key`` at ``batch`` (NHWC, in layer order), read through a flax
    interceptor (jitted: the draws do not depend on the inputs)."""
    lg = RES.bit_length() - 1

    def noises(params, key):
        seen = []

        def intercept(next_fun, args, kwargs, context):
            if isinstance(context.module, NoiseInjection) and \
                    context.method_name == "__call__" and \
                    kwargs.get("noise") is None:
                x = args[0]
                noise = jax.random.normal(context.module.make_rng("noise"),
                                          (*x.shape[:3], 1), x.dtype)
                seen.append(noise)
                return next_fun(x, noise=noise)
            return next_fun(*args, **kwargs)

        ws = jnp.zeros((batch, num_style_layers(lg), 8))
        with nn.intercept_methods(intercept):
            jg.apply(params, ws, lg, 1.0, method="synthesize",
                     rngs={"noise": key})
        return seen

    return jax.jit(noises)


def jax_fused_draws(jcfg, jg, params, rng, n):
    """The port's ``StepDraws`` of n JAX ``step_fused`` steps from the
    state key ``rng`` (``ganlab_tpu/train/steps.py``: one split of the key
    a step into the next key and flip / z / noise / gp keys; the fakes'
    latents, mixing and noise from the z and noise keys)."""
    nl = num_style_layers(RES.bit_length() - 1)
    noises = _jax_noises(jg, B)
    out = []
    for _ in range(n):
        ks = jax.random.split(rng, 5)
        rng, (k_flip, k_z, k_n, _) = ks[0], ks[1:]
        flip = np.array(jax.random.bernoulli(k_flip, 0.5, (B, 1, 1, 1)))
        k1, k2, kp, kc = jax.random.split(k_z, 4)
        gen = tsteps.GenDraws(
            torch.from_numpy(np.array(jax.random.normal(k1, (B, 8)))),
            torch.from_numpy(np.array(jax.random.normal(k2, (B, 8)))),
            torch.tensor(bool(jax.random.bernoulli(
                kp, jcfg.model.style_mixing_prob))),
            torch.tensor(int(jax.random.randint(kc, (), 1, nl))),
            [torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())
             for a in noises(params, k_n)])
        out.append(tsteps.StepDraws(torch.from_numpy(flip.reshape(B)), gen,
                                    gen, torch.zeros(B, 1, 1, 1)))
    return out


def jax_state_arrays(js) -> dict:
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    arrays = {k: to_np(getattr(js, k)) for k in
              ("params_g", "params_d", "params_ema", "w_avg")}
    for k in ("opt_g", "opt_d"):
        adam = getattr(js, k)[0]
        arrays[k] = {"count": int(adam.count), "mu": to_np(adam.mu),
                     "nu": to_np(adam.nu)}
    arrays.update(step=int(js.step), shown_imgs=float(js.shown_imgs))
    return arrays


# (batches offered, consumed): two full cycles (the realignment and the
# tail run the lazy dispatcher's steps, held to JAX's by the trainers'
# rows below and by tests/test_torch_train_step.py)
JAX_PIECES = [(K, K), (K, K)]


@pytest.fixture(scope="module")
def jax_chunked_run():
    jcfg = jax_get_config("stylegan-256",
                          **dict(TINY, **RECIPES["fused_g_step"]))
    phase = jax_build_phases(jcfg.schedule, jcfg.model)[-1]
    js = jax_create_state(jcfg, jax.random.PRNGKey(0))
    # before the first step, which donates the state's buffers
    jg, _ = jax_build_models(jcfg.model)
    draws = jax_fused_draws(jcfg, jg, js.params_g, js.rng,
                            sum(c for _, c in JAX_PIECES))
    arrays0 = jax_state_arrays(js)
    stepper, k = jax_chunked(jcfg, phase, make_single_step, make_single_step)
    assert k == K
    data = batches(sum(n for n, _ in JAX_PIECES), seed=3)
    ms, start = [], 0
    for n, _ in JAX_PIECES:
        js, m = stepper(js, jnp.asarray(data[start:start + n]))
        ms.append({key: np.asarray(v) for key, v in m.items()})
        start += n
    return dict(arrays0=arrays0, arrays=jax_state_arrays(js), metrics=ms,
                data=data, draws=draws)


def test_chunked_matches_the_jax_chunked_stepper(jax_chunked_run):
    run = jax_chunked_run
    cfg = tiny_config(**RECIPES["fused_g_step"])
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = load_jax_train_state(create_train_state(cfg, seed=9,
                                                    device="cpu"),
                                 run["arrays0"], cfg)
    stepper, _ = make_chunked_stepper(cfg, phase)
    data = torch.from_numpy(run["data"])
    start, drawn = 0, 0
    for (n, consumed), want in zip(JAX_PIECES, run["metrics"]):
        state, m = stepper(state, data[start:start + n],
                           draws=run["draws"][drawn:drawn + n])
        assert len(m["d_loss"]) == consumed == want["d_loss"].shape[0]
        for key in ("d_loss", "g_loss", "penalty", "real_score",
                    "fake_score", "alpha"):
            np.testing.assert_allclose(m[key].numpy(), want[key], rtol=1e-2,
                                       atol=2e-3, err_msg=key)
        start += n
        drawn += consumed
    assert (state.step, state.shown_imgs) == (
        sum(c for _, c in JAX_PIECES), sum(c for _, c in JAX_PIECES) * B)
    tot, count = 0.0, 0
    for module, key in ((state.g, "params_g"), (state.d, "params_d"),
                        (state.g_ema, "params_ema")):
        want = from_flax(run["arrays"][key])
        for name, p in module.state_dict().items():
            d = (p.double() - want[name].double()).abs()
            assert float(d.max()) < 2.5e-2, (key, name, float(d.max()))
            tot, count = tot + float(d.sum()), count + d.numel()
    assert tot / count < 1e-4, tot / count


# -- the trainers: the chunk cycle's log rows ---------------------------------

TRAINER = {"model.resolution": 8, "model.fmap_base": 64,
           "model.fmap_max": 8, "model.latent_dim": 8,
           "model.mapping_layers": 1, "run.compute_dtype": "float32",
           "schedule.start_res": 4, "schedule.stabilize_kimg": 0.012,
           "schedule.fade_kimg": 0.012, "schedule.total_kimg": 0.1,
           "schedule.batch_schedule": {4: 2, 8: 2},
           "data.dataset": "synthetic", "run.log_every": 1,
           "run.checkpoint_every": 0, "run.sample_every": 0,
           "run.total_steps": 12, "run.chunk_steps": True,
           "loss.penalty": "r1", "loss.penalty_every": K}
ROW = ("step", "res", "kind", "shown_imgs")


def read_rows(workdir) -> list:
    with open(os.path.join(workdir, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_trainer_rows(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("jax_chunked"))
    trainer = JaxTrainer(jax_get_config("stylegan-256", **TRAINER), workdir,
                         use_mesh=False)
    assert trainer.chunking
    trainer.train()
    trainer.close()
    return read_rows(workdir)


def test_trainer_chunk_rows_match_jax(jax_trainer_rows, tmp_path, capsys):
    cfg = get_config("stylegan-256", **TRAINER)
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    assert trainer.chunking
    assert "quantizes run.log_every=1" in capsys.readouterr().out
    trainer.train()
    trainer.close()
    rows = read_rows(str(tmp_path))
    # 4x4: a cycle (step 4) and a tail of two (6, a cycle head among
    # them); the 8x8 fade starts two steps into a cycle: two steps to
    # realign (8), then a cycle (12)
    assert [r["step"] for r in rows] == [4, 6, 8, 12]
    assert [tuple(r[k] for k in ROW) for r in rows] == \
        [tuple(r[k] for k in ROW) for r in jax_trainer_rows]
    for got, want in zip(rows, jax_trainer_rows):
        assert got["alpha"] == pytest.approx(want["alpha"], abs=1e-6)
    assert [r["penalty"] > 0 for r in rows] == [True, True, False, True]
    assert [r["penalty"] > 0 for r in jax_trainer_rows] == \
        [True, True, False, True]
    assert trainer.state.step == 12
    assert all(s.graphs is None for s in trainer._steps.values())


# -- load_jax_train_state under reg_separate ----------------------------------

def test_load_reg_separate_state_seeds_heads_with_optax_count():
    """A JAX run under ``loss.reg_separate`` with R1 every 2nd step, three
    steps in: D's optax count is 3 + 2 (steps 0 and 2 took two updates).
    Loaded with the config, the moments began at step 0; a D parameter
    without moments (a head seeded later) takes the count at the port's
    next step, as optax's single count moves on to 6."""
    over = {"loss.reg_separate": True, "loss.penalty_every": 2}
    jcfg = jax_get_config("stylegan-256", **dict(TINY, **over))
    js = jax_create_state(jcfg, jax.random.PRNGKey(0))
    _, jopt_d = jax_make_optimizers(jcfg, resolution=RES)
    rs = np.random.RandomState(0)

    def d_update(js):
        grads = jax.tree_util.tree_map(
            lambda a: rs.randn(*a.shape).astype(np.float32), js.params_d)
        upd, opt = jopt_d.update(grads, js.opt_d, js.params_d)
        return js.replace(opt_d=opt, params_d=optax.apply_updates(
            js.params_d, upd))

    for _ in range(5):                  # steps 0, 1, 2 with two ticks
        js = d_update(js)
    js = js.replace(step=js.step + 3, shown_imgs=js.shown_imgs + 3.0 * B)
    arrays = jax_state_arrays(js)
    assert arrays["opt_d"]["count"] == 5

    cfg = tiny_config(**over)
    st = load_jax_train_state(create_train_state(cfg, seed=1, device="cpu"),
                              arrays, cfg)
    assert (st.step, st.opt_step0) == (3, 0)
    head = st.d.fromrgb16.w                   # reached at 16x16
    del st.opt_d.state[head]
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    stepper = make_lazy_stepper(cfg, phase, initial_step=st.step)
    st, _ = stepper(st, torch.from_numpy(batches(1)[0]))    # an off step
    js = d_update(js)
    counts = {float(st.opt_d.state[p]["step"]) for p in st.d.parameters()
              if p.grad is not None}
    assert counts == {float(js.opt_d[0].count)} == {6.0}


# -- where the off-runs are graphs --------------------------------------------

@pytest.mark.parametrize("preset,over,graphed", [
    ("stylegan-256", {}, True),
    ("stylegan2-256", {}, True),
    ("stylegan-256", {"run.chunk_steps": False}, False),
    ("stylegan-256", {"optim.grad_accum": 2}, False),
    ("stylegan-1024", {}, False),
    ("progan-128", {}, False),
    ("resnetgan-cifar10", {}, False),
])
def test_adam_is_capturable_only_where_off_runs_are_graphs(preset, over,
                                                          graphed):
    """``graphs_capture``: a card, chunked stepping on (the stylegan-256
    and stylegan2-256 presets; stylegan-1024 opts out, ProGAN and
    ResNet-GAN penalize every step), no accumulation, one process. On the
    CPU it never holds, and a CPU state's Adams are the default ones."""
    cfg = get_config(preset, **over)
    assert graphs_capture(cfg, "cuda") is graphed
    assert graphs_capture(cfg, "cpu") is False
    st = create_train_state(tiny_config(**over), seed=0, device="cpu")
    assert not any(g["capturable"] for opt in (st.opt_g, st.opt_d)
                   for g in opt.param_groups)

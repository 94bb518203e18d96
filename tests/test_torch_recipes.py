"""The opt-in step recipes of the port (``loss.reg_separate``,
``loss.fused_seq``, ``loss.fused_g_step``) against the JAX package.

Small configs (16², fmap_max 16, latent 16, 2 mapping layers, batch 4,
float32, JAX matmuls at ``highest``), the worlds of
``test_torch_train_step.py`` (StyleGAN), ``test_torch_augment.py`` (ADA,
``bcgfnu``) and a StyleGAN2 one with path length, each fed to both
packages as the same perturbed trees and injected draws. The JAX side is
assembled from its pieces as ``ganlab_tpu/train/steps.py`` assembles the
recipes (``build_train_step`` draws its own keys). Gradients within 1e-4
of each leaf's largest magnitude, as the sequential step's tests.

* ``reg_separate``: off a penalty step the state is the sequential
  step's bit for bit; on one, D's two Adam steps (every D parameter's
  count +2, +1 off it) take the main loss's gradients (harness at the
  step's D) and then R1's alone at the port's post-main D (harness at the
  same weights: Adam with beta1 = 0 moves each weight by about lr *
  sign(g)); the ``penalty`` metric is R1's value; a head a fade phase
  switches on is seeded with the steps since the moments began plus the
  penalty steps among them; WGAN-GP and drift on ProGAN take two D
  updates a step.
* ``fused_seq``: D's state and ``d_loss`` bit-equal to the sequential
  step's on the same draws; G's gradients against the harness fed the D
  phase's latents and noise; the shared forward bit-equal to the
  sequential step whose G draws are the D draws (the recompute).
* ``fused_g_step``: both networks' gradients against
  ``jax.value_and_grad`` of the fused objective at the pre-update D, plain
  (R1 on), under ADA (one augmentation of the fakes for both losses; rt
  and p) and with path length on StyleGAN2; scaling either loss leaves
  the other network's gradients the same bits; the one D forward with two
  backwards over disjoint parameter sets bit-equal to the literal route
  (a second D forward with D's parameters out of the graph, one
  backward); p rising at the documented rate under ADA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.stylegan import mix_styles as jax_mix_styles
from ganlab_tpu.ops import augment as JA
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.ops import losses as L
from ganlab_tpu_torch.train import (
    build_phases,
    create_train_state,
    make_lazy_stepper,
    state_tensors,
)
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_augment import ADA, _ada_cfg
from tests.test_torch_augment import _batch as ada_batch
from tests.test_torch_augment import _port_draws as ada_port_draws
from tests.test_torch_stylegan2 import (
    _jax_pl_term,
    _port_state as sg2_port_state,
    _step_draws as sg2_step_draws,
    _tree,
)
from tests.test_torch_stylegan2 import SMALL as SG2_SMALL
from tests.test_torch_train_step import (
    FADE,
    SMALL,
    assert_grads,
    jax_harness,
    make_world,
    perturb,
    port_state,
    to_flax,
    to_port_draws,
)

torch.set_num_threads(1)

B, LG, NL = 4, 4, 6
GAMMA = 10.0 * 16                  # R1 on a lazy tick: weight x k


@pytest.fixture(scope="module")
def world():
    w = make_world()
    w["jaug"] = [JA.sample_params(jax.random.PRNGKey(20 + i), B, 16, 0.5,
                                  "bcgfnu") for i in range(3)]
    return w


def recipe_cfg(recipe=None, base=SMALL, preset="stylegan-256", **over):
    sets = dict(base, **over)
    if recipe:
        sets[f"loss.{recipe}"] = True
    return get_config(preset, **sets)


def draws_of(w):
    return to_port_draws(w["flip"], w["dd"], w["dg"])


def run_step(w, recipe, penalty_on, draws=None, cfg=None, state=None):
    """One port step of ``recipe`` from the world's state, with every
    Adam step's gradients (before) and D's parameters (after) recorded."""
    cfg = cfg or recipe_cfg(recipe)
    st = state or port_state(w)
    calls = []
    adam_step = st.opt_d.step

    def recording(*a, **k):
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in st.d.named_parameters()}
        out = adam_step(*a, **k)
        calls.append((grads, to_flax(st.d)))
        return out

    st.opt_d.step = recording
    step = tsteps.build_train_step(cfg, w["phase"],
                                   penalty_override=penalty_on)
    st, m = step(st, torch.from_numpy(w["real"]), draws or draws_of(w))
    del st.opt_d.step
    return st, {k: float(v) for k, v in m.items()}, calls


def assert_recorded(grads: dict, want_tree, what):
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(grads) == set(want), what
    for name, g in grads.items():
        ref = want[name].numpy()
        if g is None:
            assert not ref.any(), (what, name)
            continue
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{what} {name}")


def assert_states_equal(a, b, skip=()):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    bad = [k for k in ta if k not in skip and not torch.equal(ta[k], tb[k])]
    assert not bad, bad[:5]


def adam_counts(opt) -> set:
    return {int(s["step"]) for s in opt.state.values()}


def _real(w):
    real = jax_steps._preprocess(jnp.asarray(w["real"]), False, None,
                                 jnp.float32)
    return jnp.where(jnp.asarray(w["flip"])[:, None, None, None],
                     real[:, :, ::-1, :], real)


def _gen_fwd(jg, nl, lg):
    def gen_fwd(params_g, d):
        ww = jg.apply(params_g, jnp.concatenate([d["z1"], d["z2"]]),
                      method="map_latents")
        ws = jax_mix_styles(ww[:B], ww[B:], jnp.where(d["use_mix"],
                                                      d["cross"], nl), nl)
        img = jg.apply(params_g, ws, lg, 1.0, list(d["noises"]),
                       method="synthesize")
        return img, jnp.mean(ww[:B].astype(jnp.float32), axis=0)

    return gen_fwd


# -- loss.reg_separate ------------------------------------------------------

@pytest.fixture(scope="module")
def reg_tick(world):
    st, m, calls = run_step(world, "reg_separate", True)
    return st, m, calls


def test_reg_separate_off_tick_is_the_sequential_step(world):
    a, ma, calls = run_step(world, "reg_separate", False)
    b, mb, _ = run_step(world, None, False)
    assert len(calls) == 1 and ma == mb
    assert_states_equal(a, b)


def test_reg_separate_main_pass_gradients(world, reg_tick):
    """The first Adam step takes the main loss alone at the step's D; G
    is scored against the D after both updates (its loss here; its
    gradients are the sequential step's code)."""
    st, m, calls = reg_tick
    want, d_grads, _, _ = jax_harness(world, False, to_flax(st.d))
    assert len(calls) == 2
    assert_recorded(calls[0][0], d_grads, "D main")
    for k in ("d_loss", "g_loss", "real_score", "fake_score"):
        np.testing.assert_allclose(m[k], float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_reg_separate_reg_pass_gradients_and_metric(world, reg_tick):
    """The second Adam step takes R1 alone at the port's post-main D; the
    penalty metric is its value."""
    _, m, calls = reg_tick
    jd = world["jd"]
    real = _real(world)

    def reg(params_d):
        return JL.r1_penalty(
            lambda x: jd.apply(params_d, x, LG, 1.0).astype(jnp.float32),
            real, GAMMA)

    value, grads = jax.jit(jax.value_and_grad(reg))(calls[0][1])
    assert_recorded(calls[1][0], grads, "D reg")
    np.testing.assert_allclose(m["penalty"], float(value), rtol=1e-4)
    assert m["penalty"] > 0


def test_reg_separate_adam_counts(world, reg_tick):
    """Every D parameter's Adam count: +2 on a tick (D's output bias too,
    which R1 does not reach: a zero gradient, as optax steps every leaf),
    +1 off it; G's +1 a step."""
    st, _, _ = reg_tick
    assert adam_counts(st.opt_d) == {2}
    assert len(st.opt_d.state) == sum(
        1 for n, _ in st.d.named_parameters() if not n.startswith(
            ("fromrgb8", "fromrgb4")))
    step = tsteps.build_train_step(recipe_cfg("reg_separate"),
                                   world["phase"], penalty_override=False)
    st, _ = step(st, torch.from_numpy(world["real"]), draws_of(world))
    assert adam_counts(st.opt_d) == {3} and adam_counts(st.opt_g) == {2}


@pytest.mark.parametrize("k,start,stop", [(2, 0, 5), (16, 3, 40), (1, 2, 9),
                                          (4, 4, 4), (3, 7, 8)])
def test_penalty_ticks_count_the_lazy_dispatch(k, start, stop):
    cfg = recipe_cfg("reg_separate", **{"loss.penalty_every": k})
    combo_at, _ = tsteps._lazy_combos(cfg)
    want = sum(combo_at(i)[0] is not False for i in range(start, stop))
    assert tsteps.penalty_ticks(cfg, start, stop) == want


def test_reg_separate_seeds_a_late_head_with_steps_plus_ticks():
    """8² for 5 steps (ticks at 0, 2, 4: 8 D updates), then the 16² fade
    phase with ``optim.reset_moments_on_phase=False``: the heads it
    switches on take count 8 and, after one step, read 9 like the rest
    (optax's one count for the tree)."""
    cfg = get_config("stylegan-256", **dict(FADE, **{
        "loss.reg_separate": True, "loss.penalty_every": 2,
        "optim.reset_moments_on_phase": False}))
    phases = build_phases(cfg.schedule, cfg.model)
    st = create_train_state(cfg, seed=0, device="cpu")
    real8 = torch.randint(0, 256, (B, 8, 8, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    stepper = make_lazy_stepper(cfg, phases[0])
    for _ in range(5):
        st, _ = stepper(st, real8)
    assert adam_counts(st.opt_d) == {8} and st.step == 5
    before = set(st.opt_d.state)
    real16 = torch.randint(0, 256, (B, 16, 16, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    st, m = make_lazy_stepper(cfg, phases[1], initial_step=5)(st, real16)
    late = set(st.opt_d.state) - before
    assert late and m["penalty"] == 0.0
    assert adam_counts(st.opt_d) == {9} and adam_counts(st.opt_g) == {6}


def test_reg_separate_progan_wgan_gp_two_updates_a_step():
    """progan-128's WGAN-GP and drift every step: two D updates a step,
    the penalty metric WGAN-GP's alone (drift rides in the main pass)."""
    cfg = get_config("progan-128", **{
        "model.resolution": 16, "model.fmap_base": 64,
        "model.latent_dim": 16, "run.compute_dtype": "float32",
        "schedule.progressive": False, "schedule.batch_schedule": {16: B},
        "loss.reg_separate": True})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    st = create_train_state(cfg, seed=0, device="cpu")
    stepper = make_lazy_stepper(cfg, phase)
    real = torch.randint(0, 256, (B, 16, 16, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    for i in range(2):
        st, m = stepper(st, real)
        assert adam_counts(st.opt_d) == {2 * (i + 1)}
        assert m["penalty"] > 0 and np.isfinite(float(m["d_loss"]))


# -- loss.fused_seq ---------------------------------------------------------

@pytest.mark.parametrize("r1", [True, False], ids=["r1_on", "r1_off"])
def test_fused_seq_d_bitwise_g_against_the_harness(world, r1):
    a, ma, _ = run_step(world, "fused_seq", r1)
    b, mb, _ = run_step(world, None, r1)
    for k in ("d_loss", "penalty", "real_score", "fake_score"):
        assert ma[k] == mb[k], k
    for k, v in state_tensors(a).items():
        if k.startswith(("d.", "opt_d.")):
            assert torch.equal(v, state_tensors(b)[k]), k
    assert not torch.equal(a.g.mapping.fc0.w, b.g.mapping.fc0.w)
    shared = dict(world, dg=world["dd"])      # G scores the D phase's batch
    want, _, g_grads, _ = jax_harness(shared, r1, to_flax(a.d))
    assert_grads(a.g, g_grads, "G")
    np.testing.assert_allclose(ma["g_loss"], float(want["g_loss"]),
                               rtol=1e-4)


def test_fused_seq_shared_forward_equals_the_recompute(world):
    """The shared graph against the sequential step whose G phase draws
    what the D phase drew: every state leaf the same bits."""
    a, ma, _ = run_step(world, "fused_seq", True)
    dr = draws_of(world)
    dr.g = dr.d
    b, mb, _ = run_step(world, None, True, draws=dr)
    assert ma == mb
    assert_states_equal(a, b)


# -- loss.fused_g_step ------------------------------------------------------

def jax_fused(w, jg, nl, penalty_on, aug=None, pl=None):
    """``step_fused``'s objective from its pieces: d_loss + penalty + g_loss
    (+ path length), D's loss on the detached (augmented) fakes, G's
    through D with its parameters stopped. ``aug`` (the reals', the fakes'
    params); ``pl`` (z, noises, y, pl_mean, weight)."""
    jd = w["jd"]
    real = _real(w)
    gen_fwd = _gen_fwd(jg, nl, LG)

    def d_apply(params_d, x):
        return jd.apply(params_d, x, LG, 1.0).astype(jnp.float32)

    def objective(params, dd):
        pd, pg = params
        fake, w_mean = gen_fwd(pg, dd)
        real_a = real
        if aug is not None:
            real_a = JA.apply_augment(real, aug[0])
            fake = JA.apply_augment(fake, aug[1])
        fake_sg = jax.lax.stop_gradient(fake)
        real_s, fake_s = d_apply(pd, real_a), d_apply(pd, fake_sg)
        d_loss = JL.d_loss_nonsaturating(real_s, fake_s)
        pen = (JL.r1_penalty(lambda x: d_apply(pd, x), real_a, GAMMA)
               if penalty_on else jnp.float32(0.0))
        g_loss = JL.g_loss_nonsaturating(
            d_apply(jax.tree.map(jax.lax.stop_gradient, pd), fake))
        pl_pen, new_mean = jnp.float32(0.0), jnp.float32(0.0)
        if pl is not None:
            pl_pen, new_mean, _ = _jax_pl_term(jg, pg, *pl)
        aux = {"d_loss": d_loss, "g_loss": g_loss, "penalty": pen,
               "real_score": jnp.mean(real_s), "fake_score": jnp.mean(fake_s),
               "rt": jnp.mean(jnp.sign(real_s)), "pl_penalty": pl_pen,
               "pl_mean": new_mean, "w_mean": w_mean}
        return d_loss + pen + g_loss + pl_pen, aux

    (_, aux), (d_grads, g_grads) = jax.jit(jax.value_and_grad(
        objective, has_aux=True))((w["pd"], w["pg"]), w["dd"])
    return aux, d_grads, g_grads


def assert_fused(st, m, aux, d_grads, g_grads):
    assert_grads(st.d, d_grads, "D")
    assert_grads(st.g, g_grads, "G")
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score"):
        np.testing.assert_allclose(m[k], float(aux[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("r1", [True, False], ids=["r1_on", "r1_off"])
def test_fused_g_step_against_the_jax_objective(world, r1):
    st, m, calls = run_step(world, "fused_g_step", r1)
    aux, d_grads, g_grads = jax_fused(world, world["jg"], NL, r1)
    assert len(calls) == 1
    assert_fused(st, m, aux, d_grads, g_grads)
    assert (m["penalty"] > 0) == r1
    wb = np.float32(world["jcfg"].model.w_avg_beta)
    np.testing.assert_allclose(
        st.w_avg.numpy(),
        world["w_avg"] * wb + np.asarray(aux["w_mean"]) * (1 - wb),
        rtol=1e-5, atol=1e-6)
    assert adam_counts(st.opt_d) == adam_counts(st.opt_g) == {1}


def test_fused_g_step_with_ada(world):
    """Reals take aug[0], the fakes aug[1] once for both losses; aug[2]
    is drawn and not read. rt from the real scores, p by the rule."""
    cfg = recipe_cfg("fused_g_step", **ADA)
    st = create_train_state(cfg, seed=0, device="cpu")
    ref = port_state(world)
    for net in ("g", "d", "g_ema"):
        getattr(st, net).load_state_dict(getattr(ref, net).state_dict())
    st.w_avg.copy_(ref.w_avg)
    p0 = float(st.ada_p)
    st, m, _ = run_step(world, None, True, draws=ada_port_draws(world),
                        cfg=cfg, state=st)
    aux, d_grads, g_grads = jax_fused(world, world["jg"], NL, True,
                                      aug=world["jaug"][:2])
    assert_fused(st, m, aux, d_grads, g_grads)
    assert m["aug_rt"] == float(aux["rt"])
    rate = np.float32(B) / np.float32(cfg.aug.kimg * 1000.0)
    want = np.clip(np.float32(p0) + np.sign(np.float32(aux["rt"]) - np.float32(
        cfg.aug.target)) * rate, 0.0, np.float32(cfg.aug.p_max))
    assert m["aug_p"] == float(st.ada_p) == float(np.float32(want))


@pytest.fixture(scope="module")
def sg2_world():
    jcfg = jax_get_config("stylegan2-256", **SG2_SMALL)
    jg, jd = jax_build_models(jcfg.model)
    pg, pd = perturb(_tree(jg, 0), 1), perturb(_tree(jd, 1), 2)
    rs = np.random.RandomState(4)
    from ganlab_tpu.models.stylegan2 import noise_shapes as jax_noise_shapes

    def gen_draws():
        return dict(z1=rs.randn(B, 16).astype(np.float32),
                    z2=rs.randn(B, 16).astype(np.float32),
                    use_mix=True, cross=3,
                    noises=[rs.randn(B, h, w, 1).astype(np.float32)
                            for h, w in jax_noise_shapes(LG)])

    nb = B // 2
    data = dict(real=rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
                flip=np.array([True, False, False, True]),
                dd=gen_draws(), dg=gen_draws(),
                pl_z=rs.randn(nb, 16).astype(np.float32),
                pl_noises=[rs.randn(nb, h, w, 1).astype(np.float32)
                           for h, w in jax_noise_shapes(LG)],
                pl_y=(rs.randn(nb, 16, 16, 3) / 16).astype(np.float32),
                w_avg=rs.randn(16).astype(np.float32), pl_mean=0.3)
    cfg = get_config("stylegan2-256", **dict(SG2_SMALL, **{
        "loss.fused_g_step": True}))
    return dict(jcfg=jcfg, jg=jg, jd=jd, pg=pg, pd=pd, cfg=cfg,
                phase=build_phases(cfg.schedule, cfg.model)[-1], **data)


def test_fused_g_step_with_path_length_stylegan2(sg2_world):
    """R1 + PL program of stylegan2-256: the PL term in the one objective
    with ``StepDraws.pl`` and ``pl_decay``; ``pl_mean`` moved."""
    w = sg2_world
    lc = w["cfg"].loss
    st = tsteps.build_train_step(w["cfg"], w["phase"], penalty_override=True,
                                 pl_override=True)(
        sg2_port_state(w), torch.from_numpy(w["real"]), sg2_step_draws(w))
    st, m = st
    pl = (jnp.float32(w["pl_mean"]), w["pl_z"],
          [jnp.asarray(n) for n in w["pl_noises"]], w["pl_y"],
          lc.pl_weight * lc.pl_every, lc.pl_decay)
    aux, d_grads, g_grads = jax_fused(w, w["jg"], NL, True, pl=pl)
    assert_fused(st, {k: float(v) for k, v in m.items()}, aux, d_grads,
                 g_grads)
    np.testing.assert_allclose(float(m["pl_penalty"]),
                               float(aux["pl_penalty"]), rtol=1e-4)
    np.testing.assert_allclose(float(st.pl_mean), float(aux["pl_mean"]),
                               rtol=1e-5)
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for n, p in st.g.named_parameters() if n.startswith("mapping."))


@pytest.mark.parametrize("scaled", ["g", "d"])
def test_fused_g_step_losses_reach_only_their_network(world, monkeypatch,
                                                      scaled):
    """A loss 1000x larger changes its own network's gradients only: the
    other's are the same bits."""
    base, _, _ = run_step(world, "fused_g_step", True)
    table = L.G_LOSSES if scaled == "g" else L.D_LOSSES
    fn = table["nonsaturating"]
    monkeypatch.setitem(table, "nonsaturating", lambda *s: 1e3 * fn(*s))
    st, _, _ = run_step(world, "fused_g_step", True)
    same, moved = ("d", "g") if scaled == "g" else ("g", "d")
    for a, b in zip(getattr(st, same).parameters(),
                    getattr(base, same).parameters()):
        assert (a.grad is None) == (b.grad is None)
        assert a.grad is None or torch.equal(a.grad, b.grad)
    assert any(not torch.equal(a.grad, b.grad) for a, b in zip(
        getattr(st, moved).parameters(), getattr(base, moved).parameters())
        if a.grad is not None)


def test_fused_g_step_route_equals_the_literal_one(world):
    """The step's one D forward of the attached fakes with two backwards
    (the first keeping the graph through the autograd Functions) against
    a second D forward with D's parameters out of the graph and one
    backward: the same bits in every gradient."""
    cfg = recipe_cfg("fused_g_step")
    got, _, _ = run_step(world, "fused_g_step", True)
    st = port_state(world)
    dr = draws_of(world)
    real = tsteps._preprocess(torch.from_numpy(world["real"]), True, dr.flip,
                              torch.float32)
    fake, _ = tsteps.build_generator_forward(cfg, LG)(st.g, dr.d, 1.0)

    def critic(x):
        return st.d(x, LG, 1.0).float()

    real_s, fake_s = critic(real), critic(fake.detach())
    objective = L.d_loss_nonsaturating(real_s, fake_s) + L.r1_penalty(
        critic, real, GAMMA)
    st.d.requires_grad_(False)
    objective = objective + L.g_loss_nonsaturating(critic(fake))
    st.d.requires_grad_(True)
    objective.backward()
    for net in ("d", "g"):
        for (n, a), b in zip(getattr(got, net).named_parameters(),
                             getattr(st, net).parameters()):
            assert (a.grad is None) == (b.grad is None), n
            assert a.grad is None or torch.equal(a.grad, b.grad), n


def test_fused_g_step_p_rises_at_documented_rate():
    """``tests/test_augment.py``'s rate test with ``fused=True``: target -2
    < rt always, so p rises by batch / (kimg * 1000) every step."""
    cfg = _ada_cfg(**{"loss.fused_g_step": True})
    st = create_train_state(cfg, seed=0, device="cpu")
    stepper = make_lazy_stepper(cfg, build_phases(cfg.schedule,
                                                  cfg.model)[0])
    for _ in range(6):                      # R1 on the first, then off
        st, m = stepper(st, ada_batch())
    assert abs(float(st.ada_p) - 6 * 4 / 500.0) < 1e-5
    assert float(m["aug_p"]) == float(st.ada_p)
    assert float(m["aug_rt"]) >= -1.0


@pytest.mark.parametrize("over,match", [
    ({"loss.fused_g_step": True, "optim.grad_accum": 2}, "sequential"),
    ({"loss.fused_g_step": True, "loss.d_steps_per_g": 2}, "d_steps_per_g"),
    ({"loss.fused_g_step": True, "loss.fused_seq": True}, "exclusive"),
    ({"loss.reg_separate": True, "loss.fused_g_step": True}, "sequential"),
    ({"loss.reg_separate": True, "optim.grad_accum": 2}, "grad_accum")])
def test_refused_combinations_raise_the_jax_errors(world, over, match):
    with pytest.raises(ValueError, match=match):
        tsteps.build_train_step(recipe_cfg(**over), world["phase"])


def test_every_recipe_builds_for_the_presets():
    """Each recipe builds a lazy stepper for stylegan-256, stylegan2-256
    (with path length) and progan-128, and n-critic with fused_seq."""
    for preset in ("stylegan-256", "stylegan2-256", "progan-128"):
        for recipe in ("reg_separate", "fused_seq", "fused_g_step"):
            cfg = get_config(preset, **{f"loss.{recipe}": True})
            phase = build_phases(cfg.schedule, cfg.model)[-1]
            assert callable(make_lazy_stepper(cfg, phase))
    cfg = get_config("resnetgan-cifar10", **{"loss.fused_seq": True,
                                             "loss.d_steps_per_g": 5})
    assert callable(tsteps.build_train_step(
        cfg, build_phases(cfg.schedule, cfg.model)[-1]))

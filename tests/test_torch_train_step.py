"""The port's training step vs a harness built from the JAX package's pieces.

Small config (16², fmap_max 16, latent 16, 2 mapping layers, batch 4,
float32, JAX matmuls at ``highest``). Both sides start from the same
perturbed flax trees (``from_flax``) and the same injected draws: flip
mask, latents, mixing switch, crossover layer and noise maps, made with
numpy. The JAX side is assembled from ``map_latents`` / ``synthesize``,
``mix_styles``, the discriminator's ``apply``, ``ganlab_tpu.ops.losses``,
``make_optimizers`` (optax), ``_preprocess`` and ``_ema_update`` -- not
from ``build_train_step``, which draws its own keys.

The same again for a fade phase (16x16 fading in over 8x8, ``shown_imgs``
set mid-phase so that alpha = 0.4): the port's step takes alpha from the
state's counter, the harness is handed the same alpha as a traced scalar,
so that both packages run the fade branch of G and of D (and of R1's
critic), with the same limits as the stabilize cases.

Compared, for one R1-on and one R1-off step: the losses, the penalty and
the mean scores (1e-4 relative), every gradient leaf of D and of G (1e-4
of the leaf's largest magnitude: float32, other summation orders, a
double backward). G's gradients are taken against the port's updated D
on both sides: with Adam's beta1 = 0 the first update is about
lr * sign(g), so the two updated D's differ by up to 2 lr where g ~ 0,
and Adam is held against optax on the same gradients separately. The
G-EMA is held against ``_ema_update`` (1e-6 of each leaf's largest
magnitude: XLA reorders the blend by a few ulps) and the w-average
against the JAX update rule (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.stylegan import mix_styles as jax_mix_styles
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu.train.state import make_optimizers as jax_make_optimizers
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models.stylegan import noise_shapes
from ganlab_tpu_torch.train import (
    build_phases,
    create_train_state,
    make_lazy_stepper,
    make_optimizers,
)
from ganlab_tpu_torch.train import steps as tsteps

# The tensors here are small: one intra-op thread is as fast as eight, and
# test processes that run side by side do not fight over the cores.
torch.set_num_threads(1)

RES, B, LG, NL = 16, 4, 4, 6
SMALL = {"model.resolution": RES, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32",
         "schedule.progressive": False, "schedule.batch_schedule": {RES: B}}
REL = 1e-4
# the fade world: 8x8 stabilize [0, 20), 16x16 fade [20, 40), then stabilize
FADE = dict(SMALL, **{"schedule.progressive": True, "schedule.start_res": 8,
                      "schedule.fade_kimg": 0.02,
                      "schedule.stabilize_kimg": 0.02,
                      "schedule.batch_schedule": {8: B, RES: B}})
FADE_SHOWN = 28                # alpha = (28 - 20) / 20 = 0.4


def perturb(tree, seed, scale=0.3):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rs.randn(*np.shape(a))).astype(np.float32),
        tree)


def to_flax(module: torch.nn.Module) -> dict:
    """The inverse of from_flax for a module's parameters."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        a = t.detach().cpu().numpy().copy()   # no view of the live tensor
        last = name.rsplit(".", 1)[-1]
        if a.ndim == 4 and last == "w":
            a = a.transpose(2, 3, 1, 0)            # OIHW -> HWIO
        elif a.ndim == 4 and last == "const":
            a = a.transpose(0, 2, 3, 1)            # NCHW -> NHWC
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return {"params": tree}


def gen_draws_np(rs):
    return dict(z1=rs.randn(B, 16).astype(np.float32),
                z2=rs.randn(B, 16).astype(np.float32),
                use_mix=True, cross=3,
                noises=[rs.randn(B, h, w, 1).astype(np.float32)
                        for h, w in noise_shapes(LG)])


def to_port_draws(flip, dd, dg):
    def gd(d):
        return tsteps.GenDraws(
            torch.from_numpy(d["z1"]), torch.from_numpy(d["z2"]),
            torch.tensor(d["use_mix"]), torch.tensor(d["cross"]),
            [torch.from_numpy(n.transpose(0, 3, 1, 2).copy())
             for n in d["noises"]])

    return tsteps.StepDraws(torch.from_numpy(flip), gd(dd), gd(dg),
                            torch.zeros(B, 1, 1, 1))


@pytest.fixture(scope="module")
def world():
    return make_world()


def make_world():
    jcfg = jax_get_config("stylegan-256", **SMALL)
    jg, jd = jax_build_models(jcfg.model)
    tree = lambda m, k: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, m.init_all(jax.random.PRNGKey(k)))
    pg, pd = perturb(tree(jg, 0), 1), perturb(tree(jd, 1), 2)
    pema = perturb(pg, 3, scale=0.1)
    rs = np.random.RandomState(4)
    data = dict(real=rs.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8),
                flip=np.array([True, False, False, True]),
                dd=gen_draws_np(rs), dg=gen_draws_np(rs),
                w_avg=rs.randn(16).astype(np.float32))
    cfg = get_config("stylegan-256", **SMALL)
    fade_cfg = get_config("stylegan-256", **FADE)
    fade_phase = build_phases(fade_cfg.schedule, fade_cfg.model)[1]
    assert (fade_phase.kind, fade_phase.resolution, fade_phase.start_img,
            fade_phase.end_img) == ("fade", RES, 20, 40)
    return dict(jcfg=jcfg, jg=jg, jd=jd, pg=pg, pd=pd, pema=pema,
                cfg=cfg, phase=build_phases(cfg.schedule, cfg.model)[-1],
                fade_cfg=fade_cfg, fade_phase=fade_phase, **data)


def port_state(w, fade=False):
    st = create_train_state(w["fade_cfg" if fade else "cfg"], seed=0,
                            device="cpu")
    if fade:
        st.shown_imgs = FADE_SHOWN
    st.g.load_state_dict(from_flax(w["pg"]))
    st.d.load_state_dict(from_flax(w["pd"]))
    st.g_ema.load_state_dict(from_flax(w["pema"]))
    st.w_avg.copy_(torch.from_numpy(w["w_avg"]))
    return st


def jax_harness(w, penalty_on: bool, port_new_d: dict, alpha=None):
    """``alpha`` None: a stabilize phase (the static 1.0 that skips the
    fade branch); a float: a fade phase at that alpha, passed as a traced
    scalar as ``build_train_step`` does, so the fade branch runs."""
    jg, jd, jcfg = w["jg"], w["jd"], w["jcfg"]
    alpha = 1.0 if alpha is None else jnp.float32(alpha)
    real = jax_steps._preprocess(jnp.asarray(w["real"]), False, None,
                                 jnp.float32)
    real = jnp.where(jnp.asarray(w["flip"])[:, None, None, None],
                     real[:, :, ::-1, :], real)

    def gen_fwd(params_g, d):
        ww = jg.apply(params_g, jnp.concatenate([d["z1"], d["z2"]]),
                      method="map_latents")
        w1, w2 = ww[:B], ww[B:]
        crossover = jnp.where(d["use_mix"], d["cross"], NL)
        ws = jax_mix_styles(w1, w2, crossover, NL)
        img = jg.apply(params_g, ws, LG, alpha, list(d["noises"]),
                       method="synthesize")
        return img, jnp.mean(w1.astype(jnp.float32), axis=0)

    def d_apply(params_d, x):
        return jd.apply(params_d, x, LG, alpha).astype(jnp.float32)

    gamma = jcfg.loss.penalty_weight * jcfg.loss.penalty_every

    def run(pg, pd, new_d, dd, dg):
        fake_d, _ = gen_fwd(pg, dd)

        def d_objective(params_d):
            real_s = d_apply(params_d, real)
            fake_s = d_apply(params_d, fake_d)
            loss = JL.d_loss_nonsaturating(real_s, fake_s)
            pen = (JL.r1_penalty(lambda x: d_apply(params_d, x), real, gamma)
                   if penalty_on else jnp.float32(0.0))
            return loss + pen, {"d_loss": loss, "penalty": pen,
                                "real_score": jnp.mean(real_s),
                                "fake_score": jnp.mean(fake_s)}

        (_, aux), d_grads = jax.value_and_grad(d_objective, has_aux=True)(pd)

        def g_objective(params_g):
            fake, w_mean = gen_fwd(params_g, dg)
            return JL.g_loss_nonsaturating(d_apply(new_d, fake)), w_mean

        (g_loss, w_mean), g_grads = jax.value_and_grad(
            g_objective, has_aux=True)(pg)
        return dict(aux, g_loss=g_loss), d_grads, g_grads, w_mean

    # one jitted program: op by op, the R1 double backward takes ~50 s
    return jax.jit(run)(w["pg"], w["pd"], port_new_d, w["dd"], w["dg"])


def assert_grads(module, want_tree, what):
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    named = dict(module.named_parameters())
    assert set(named) == set(want), what
    for name, p in named.items():
        ref = want[name].numpy()
        if p.grad is None:  # a head of another resolution: JAX gives zeros
            assert not ref.any(), (what, name)
            continue
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=REL * scale, err_msg=f"{what} {name}")


@pytest.fixture(scope="module",
                params=[(True, False), (False, False), (True, True),
                        (False, True)],
                ids=["r1_on", "r1_off", "fade_r1_on", "fade_r1_off"])
def stepped(world, request):
    """One port step (penalty on or off, stabilize or fade phase) and the
    JAX harness beside it."""
    penalty_on, fade = request.param
    st = port_state(world, fade)
    shown_before = st.shown_imgs
    g_before = {k: v.clone() for k, v in st.g.state_dict().items()}
    ema_before = to_flax(st.g_ema)
    step = tsteps.build_train_step(
        world["fade_cfg" if fade else "cfg"],
        world["fade_phase" if fade else "phase"],
        penalty_override=penalty_on)
    draws = to_port_draws(world["flip"], world["dd"], world["dg"])
    st, metrics = step(st, torch.from_numpy(world["real"]), draws)
    alpha = 0.4 if fade else None
    assert metrics["alpha"] == pytest.approx(0.4 if fade else 1.0, abs=1e-7)
    want, d_grads, g_grads, w_mean = jax_harness(world, penalty_on,
                                                 to_flax(st.d), alpha)
    return dict(st=st, metrics=metrics, want=want, d_grads=d_grads,
                g_grads=g_grads, w_mean=w_mean, g_before=g_before,
                ema_before=ema_before, penalty_on=penalty_on, fade=fade,
                shown_before=shown_before)


def test_step_losses_and_scores(stepped):
    m, want = stepped["metrics"], stepped["want"]
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)
    assert (float(m["penalty"]) > 0) == stepped["penalty_on"]


def test_step_d_gradients(stepped):
    assert_grads(stepped["st"].d, stepped["d_grads"], "D")


def test_step_g_gradients(stepped):
    assert_grads(stepped["st"].g, stepped["g_grads"], "G")


def test_step_ema_w_avg_and_counters(stepped, world):
    st = stepped["st"]
    beta = world["jcfg"].optim.ema_beta_for(B)
    want = jax_steps._ema_update(stepped["ema_before"], to_flax(st.g), beta)
    want = from_flax(jax.tree_util.tree_map(np.asarray, want))
    for name, t in st.g_ema.state_dict().items():
        ref = want[name].numpy()
        np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()),
                                   err_msg=name)
    wb = np.float32(world["jcfg"].model.w_avg_beta)
    want_w = world["w_avg"] * wb + np.asarray(stepped["w_mean"]) * (1 - wb)
    np.testing.assert_allclose(st.w_avg.numpy(), want_w, rtol=1e-5,
                               atol=1e-6)
    changed = {k for k, v in st.g.state_dict().items()
               if not torch.equal(v, stepped["g_before"][k])}
    with_grad = {k for k, p in st.g.named_parameters() if p.grad is not None}
    assert changed == with_grad
    assert all(k.startswith("synthesis.torgb") for k in
               set(stepped["g_before"]) - changed)   # other resolutions
    assert (st.step, st.shown_imgs) == (1, stepped["shown_before"] + B)
    if stepped["fade"]:  # the fade branch reached the 8x8 heads too
        assert {"synthesis.torgb8.w", "synthesis.torgb16.w"} <= changed
        assert stepped["st"].d.fromrgb8.w.grad is not None


def test_adam_matches_optax(world):
    """The port's optimizers and optax's, fed the same gradients."""
    st = port_state(world)
    opt_g, opt_d = make_optimizers(world["cfg"], st.g, st.d, resolution=RES)
    jopt_g, jopt_d = jax_make_optimizers(world["jcfg"], resolution=RES)
    rs = np.random.RandomState(5)
    for module, opt, jopt in ((st.g, opt_g, jopt_g), (st.d, opt_d, jopt_d)):
        params = to_flax(module)
        jstate = jopt.init(params)
        for _ in range(3):
            grads = jax.tree_util.tree_map(
                lambda a: rs.randn(*a.shape).astype(np.float32), params)
            upd, jstate = jopt.update(grads, jstate, params)
            params = optax.apply_updates(params, upd)
            sd_grads = from_flax(grads)
            for name, p in module.named_parameters():
                p.grad = sd_grads[name].clone()
            opt.step()
        want = from_flax(jax.tree_util.tree_map(np.asarray, params))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("over", [
    {}, {"loss.penalty_every": 1}, {"loss.penalty": "none"},
    {"loss.penalty_every": 4, "optim.lazy_adjust": False}])
def test_lazy_combos_match_jax(over):
    over = dict(SMALL, **over)
    tc, tl = tsteps._lazy_combos(get_config("stylegan-256", **over))
    jc, jl = jax_steps._lazy_combos(jax_get_config("stylegan-256", **over))
    assert tl == jl
    assert [tc(i) for i in range(40)] == [jc(i) for i in range(40)]


def test_lazy_stepper_cadence_and_generator(world):
    """Counter 15 runs the R1-off step, 16 the R1-on step; the state's
    generator makes the draws, so one seed gives one trajectory."""
    real = torch.from_numpy(world["real"])

    def run():
        st = create_train_state(world["cfg"], seed=7, device="cpu")
        stepper = make_lazy_stepper(world["cfg"], world["phase"],
                                    initial_step=15)
        out = []
        for _ in range(2):
            st, m = stepper(st, real)
            out.append({k: float(v) for k, v in m.items()})
        return st, out

    st, m1 = run()
    _, m2 = run()
    assert m1 == m2
    assert m1[0]["penalty"] == 0.0 and m1[1]["penalty"] > 0.0
    assert (st.step, st.shown_imgs) == (2, 2 * B)
    assert all(np.isfinite(v) for m in m1 for v in m.values())


@pytest.mark.parametrize("knob", [
    {"loss.fused_seq": True}, {"loss.fused_g_step": True},
    {"loss.reg_separate": True}, {"loss.pl_weight": 2.0},
    {"aug.mode": "ada"}, {"optim.grad_accum": 2},
    {"loss.pl_weight": 2.0, "loss.d_steps_per_g": 2}])
def test_options_build_or_raise_as_in_jax(world, knob):
    """Every option of the JAX step is ported. Path-length regularization
    (tests/test_torch_stylegan2.py): ``loss.pl_weight`` alone builds a step
    that takes the term, and with ``d_steps_per_g`` > 1 it raises the JAX
    package's ValueError. Gradient accumulation
    (tests/test_torch_grad_accum.py): ``optim.grad_accum`` = 2 builds a
    step. ADA (tests/test_torch_augment.py): ``aug.mode`` = ada builds a
    step whose draws carry three augmentations. The opt-in recipes
    ``loss.fused_seq``, ``loss.fused_g_step`` and ``loss.reg_separate``
    (tests/test_torch_recipes.py) each build a step that runs."""
    cfg = get_config("stylegan-256", **dict(SMALL, **knob))
    if knob == {"aug.mode": "ada"}:
        assert callable(tsteps.build_train_step(cfg, world["phase"]))
        assert cfg.ada_active and len(tsteps.draw_step(
            cfg, LG, B, torch.Generator(), "cpu").aug) == 3
        return
    if knob == {"loss.pl_weight": 2.0}:
        step = tsteps.build_train_step(cfg, world["phase"])
        assert step.pl_weight == 2.0 and cfg.pl_active
        return
    if knob == {"optim.grad_accum": 2}:
        assert callable(tsteps.build_train_step(cfg, world["phase"]))
        assert cfg.optim.grad_accum == 2
        return
    if "loss.pl_weight" in knob:
        with pytest.raises(ValueError, match="d_steps_per_g"):
            tsteps.build_train_step(cfg, world["phase"])
        return
    step = tsteps.build_train_step(cfg, world["phase"],
                                   penalty_override=True)
    st, m = step(port_state(world), torch.from_numpy(world["real"]),
                 to_port_draws(world["flip"], world["dd"], world["dg"]))
    assert (st.step, st.shown_imgs) == (1, B)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["penalty"]) > 0


def test_fade_phase_raises(world):
    """A fade phase builds and steps under every recipe (no longer
    raising): here ``loss.fused_seq`` in the fade world, whose step runs
    at the alpha of the state's shown-image counter (0.4) and moves the
    8x8 heads of G and D as the fade branch does."""
    cfg = get_config("stylegan-256", **dict(FADE, **{"loss.fused_seq": True}))
    fade = [p for p in build_phases(cfg.schedule, cfg.model)
            if p.kind == "fade"][0]
    st = port_state(world, fade=True)
    torgb8 = st.g.synthesis.torgb8.w.detach().clone()
    step = tsteps.build_train_step(cfg, fade, penalty_override=False)
    st, m = step(st, torch.from_numpy(world["real"]),
                 to_port_draws(world["flip"], world["dd"], world["dg"]))
    assert m["alpha"] == pytest.approx(0.4, abs=1e-7)
    assert st.shown_imgs == FADE_SHOWN + B
    assert st.d.fromrgb8.w.grad is not None
    assert not torch.equal(st.g.synthesis.torgb8.w, torgb8)


def test_fade_alpha_follows_the_jax_schedule(world):
    """alpha of a step = the JAX package's ``alpha_at`` at the state's
    shown-image count before the step: 0.0 at the phase's first step,
    below 1.0 at its last, and the static 1.0 in a stabilize phase."""
    from ganlab_tpu.train.schedule import alpha_at as jax_alpha_at
    from ganlab_tpu.train.schedule import build_phases as jax_build_phases

    jcfg = jax_get_config("stylegan-256", **FADE)
    jfade = jax_build_phases(jcfg.schedule, jcfg.model)[1]
    fade = world["fade_phase"]
    assert (jfade.start_img, jfade.end_img) == (fade.start_img, fade.end_img)
    for shown in range(fade.start_img, fade.end_img, B):
        assert tsteps.phase_alpha(fade, shown) == pytest.approx(
            jax_alpha_at(jfade, shown), abs=1e-6)
    assert tsteps.phase_alpha(fade, fade.start_img) == 0.0
    assert tsteps.phase_alpha(fade, fade.end_img + 5) == 1.0
    assert tsteps.phase_alpha(world["phase"], 3) == 1.0
    # rounded to the blend's dtype, as fade_in rounds it in the JAX package
    a = tsteps.phase_alpha(fade, fade.start_img + 3, torch.bfloat16)
    assert a == float(torch.tensor(3 / 20).bfloat16())

    st = port_state(world, fade=True)
    st.shown_imgs = fade.start_img
    step = tsteps.build_train_step(world["fade_cfg"], fade,
                                   penalty_override=False)
    st, m = step(st, torch.from_numpy(world["real"]),
                 to_port_draws(world["flip"], world["dd"], world["dg"]))
    assert m["alpha"] == 0.0 and isinstance(m["alpha"], float)
    assert st.shown_imgs == fade.start_img + B


def test_fade_branch_runs_at_alpha_one(world):
    """In a fade phase the models blend whatever alpha's value: with
    ``fade=True`` and alpha 1.0 the old heads stay in the graph (zero
    gradient, not none), as in the JAX package's traced-alpha step."""
    st = port_state(world)
    x = torch.from_numpy(world["real"]).permute(0, 3, 1, 2).float() / 127.5 - 1
    st.d(x, LG, 1.0, fade=True).sum().backward()
    assert st.d.fromrgb8.w.grad is not None
    assert not st.d.fromrgb8.w.grad.any()
    st.d.zero_grad(set_to_none=True)
    st.d(x, LG, 1.0).sum().backward()
    assert st.d.fromrgb8.w.grad is None          # the static skip


def test_d_fade_branch_second_derivative_float64():
    """R1 differentiates twice through the D's fade branch (average pool,
    the old fromRGB, the blend, blur+down and mbstd): first and second
    derivatives with respect to the image against finite differences, in
    float64 (gradcheck's defaults)."""
    from ganlab_tpu_torch.models import build_models

    cfg = get_config("stylegan-256", **{
        "model.resolution": 8, "model.fmap_base": 16, "model.fmap_max": 4,
        "model.latent_dim": 8, "model.mapping_layers": 1})
    torch.manual_seed(0)
    _, d = build_models(cfg.model)
    d = d.double()
    with torch.no_grad():
        for p in d.parameters():            # biases are zero at init
            p.add_(0.3 * torch.randn_like(p))
    x = torch.randn(3, 3, 8, 8, dtype=torch.float64, requires_grad=True)

    def critic(img):
        return d(img, 3, 0.4, fade=True)

    assert torch.autograd.gradcheck(critic, (x,))
    assert torch.autograd.gradgradcheck(critic, (x,))

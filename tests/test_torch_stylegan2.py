"""The port's StyleGAN2 (``stylegan2-256``) vs the JAX package, on the CPU.

Small configs (16x16 and 32x32, fmap_max 16, latent 16, 2 mapping layers,
float32, JAX matmuls at ``highest``). Both packages start from the same
perturbed flax trees (``from_flax``; at init the noise scales and biases
are 0, which would hide those terms) and the same numpy-seeded draws.

* ``modulated_conv2d`` with demodulation on and off: values and the
  gradients of input, weight and styles within 1e-5 of their scale.
* The G with explicit noise maps within 1e-5 in float32; in bf16 no
  further from the float32 image than twice the JAX bf16 image; the
  family's ``noise_shapes`` (one 4x4 map); mixing and truncation from z
  through the sample function and the G's call within 1e-4, as
  ``test_torch_stylegan.py`` holds StyleGAN's.
* The residual D with and without ``model.remat``: scores, the input's
  and every parameter's gradient within 1e-5 of their scale.
* Path-length regularization: the lengths, the new running mean, the
  penalty and G's gradients of the penalty (the mapping layers' too,
  asserted nonzero) against a harness written from
  ``ganlab_tpu/train/steps.py::build_train_step.pl_term`` with the same
  z, noise and projection; then one step of each of the three lazy
  programs of the preset (R1 + PL, PL alone, neither), leaf by leaf
  (1e-4 of each leaf's scale, as ``test_torch_train_step.py``).
* ``make_lazy_stepper`` builds those three programs and no other, with
  the interval-scaled weights; Adam against optax with G's lazy
  compensation for ``pl_every``.
* The launch counts ``chip_smoke.stylegan2_step_launches`` derives,
  against the plain versions' calls counted on the CPU, shape by shape.
* ``pl_mean`` in checkpoints: round trip, bitwise resume across a PL
  step, a pre-PL checkpoint resuming into a PL config (and back), and
  ``load_jax_train_state`` carrying it.
* PPL's pair images on the StyleGAN2 G against the JAX package's; ``cli
  train`` / ``sample`` / ``eval-ppl`` on a tiny ``stylegan2-256``; and
  ``stylegan-256`` with ``loss.pl_weight=2``.
"""

import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.stylegan import mix_styles as jax_mix_styles
from ganlab_tpu.models.stylegan import noise_shapes as jax_sg1_noise_shapes
from ganlab_tpu.models.stylegan2 import noise_shapes as jax_noise_shapes
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.ops.modulated import modulated_conv2d as jax_modconv
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu.train.state import create_train_state as jax_create_state
from ganlab_tpu.train.state import make_optimizers as jax_make_optimizers
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax, load_jax_train_state
from ganlab_tpu_torch.eval.ppl import _drawn, ppl_pairs
from ganlab_tpu_torch.models import build_generator, build_models
from ganlab_tpu_torch.models import NoiseInjection, noise_shapes
from ganlab_tpu_torch.models.stylegan2 import StyleGAN2Generator
from ganlab_tpu_torch.ops.kernels import mbstd, pixelnorm, resample
from ganlab_tpu_torch.ops.modulated import modulated_conv2d
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train import (
    CheckpointManager,
    build_phases,
    create_train_state,
    make_lazy_stepper,
    make_optimizers,
    state_tensors,
)
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_ppl import _jax_pairs, _pair
from tests.test_torch_progan_g import _nchw, _nhwc
from tests.test_torch_train_step import assert_grads, perturb, to_flax

torch.set_num_threads(1)

TOL = 1e-5
SAMPLE_TOL = 1e-4      # z -> image through the mapping, the truncation or
                       # the mixing, and the clip: as test_torch_stylegan.py
G_SMALL = {"model.resolution": 32, "model.fmap_base": 128,
           "model.fmap_max": 16, "model.latent_dim": 16,
           "model.mapping_layers": 2, "run.compute_dtype": "float32"}
RES, B, LG = 16, 4, 4
NL, NB = 2 * (LG - 1), B // 2          # style layers; the PL batch
SMALL = dict(G_SMALL, **{"model.resolution": RES,
                         "schedule.batch_schedule": {RES: B},
                         "data.dataset": "synthetic"})


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _tree(model, seed):
    return jax.tree_util.tree_map(
        np.asarray, model.init_all(jax.random.PRNGKey(seed)))


# -- modulated conv ---------------------------------------------------------

@pytest.mark.parametrize("demod", [True, False], ids=["demod", "no_demod"])
def test_modulated_conv2d_matches_jax(demod):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 7, 5).astype(np.float32)           # NHWC
    w = rs.randn(3, 3, 5, 4).astype(np.float32)           # HWIO
    s = (1 + 0.5 * rs.randn(2, 5)).astype(np.float32)
    ct = rs.randn(2, 6, 7, 4).astype(np.float32)

    def jf(x, w, s):
        return jax_modconv(x, w, s, demodulate=demod)

    want = jf(x, w, s)
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * ct), (0, 1, 2))(x, w, s)
    tx = _nchw(x).requires_grad_()
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    got = modulated_conv2d(tx, tw, ts, demodulate=demod)
    _close(_nhwc(got), want, "value")
    gx, gw, gs = torch.autograd.grad(got, (tx, tw, ts), _nchw(ct))
    _close(_nhwc(gx), want_g[0], "d/dx")
    _close(gw.numpy().transpose(2, 3, 1, 0), want_g[1], "d/dw")
    _close(gs.numpy(), want_g[2], "d/ds")


# -- the generator ----------------------------------------------------------

@pytest.fixture(scope="module")
def g_pair():
    jcfg = jax_get_config("stylegan2-256", **G_SMALL)
    jg, _ = jax_build_models(jcfg.model)
    params = perturb(_tree(jg, 0), 1)
    tg = build_generator(get_config("stylegan2-256", **G_SMALL).model)
    tg.load_state_dict(from_flax(params))
    return jg, params, tg.eval().requires_grad_(False)


def _noises(lg, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, h, w, 1).astype(np.float32)
            for h, w in jax_noise_shapes(lg)]


def test_generator_builds_the_jax_tree(g_pair):
    jg, params, tg = g_pair
    assert isinstance(tg, StyleGAN2Generator)
    assert len(jax.tree_util.tree_leaves(params)) == len(tg.state_dict())
    assert {"synthesis.torgb32.conv.affine.w", "synthesis.conv4.noise.scale",
            "synthesis.block32.conv1.w"} <= set(tg.state_dict())
    g, d = build_models(get_config("stylegan2-256").model)
    assert isinstance(g, StyleGAN2Generator) and d.block8.resnet
    assert d.block8.blur


def test_noise_shapes_match_jax():
    for lg in range(2, 9):
        mc2 = get_config("stylegan2-256", **{
            "model.resolution": 2 ** max(lg, 3)}).model
        mc1 = get_config("stylegan-256").model
        assert noise_shapes(mc2, lg) == jax_noise_shapes(lg)
        assert noise_shapes(mc1, lg) == jax_sg1_noise_shapes(lg)
    mc = get_config("stylegan2-256", **{"model.fmap_base": 64}).model
    assert len(noise_shapes(mc, 8)) == 13
    # what serving and sampling draw without explicit maps: one map a
    # noise layer of the G
    assert sum(isinstance(m, NoiseInjection)
               for m in build_generator(mc).modules()) == 13


def test_map_latents(g_pair):
    jg, params, tg = g_pair
    z = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    want = jg.apply(params, jnp.asarray(z), method="map_latents")
    _close(tg.map_latents(torch.from_numpy(z)).numpy(), want, "w")


@pytest.mark.parametrize("lg", [5, 3])
def test_synthesize_explicit_noise(g_pair, lg):
    jg, params, tg = g_pair
    ws = np.random.RandomState(3).randn(3, 2 * (lg - 1), 16).astype(
        np.float32)
    nz = _noises(lg, 3, 4)
    want = jg.apply(params, jnp.asarray(ws), lg, 1.0,
                    [jnp.asarray(a) for a in nz], method="synthesize")
    got = tg.synthesize(torch.from_numpy(ws), lg, 0.3, [_nchw(a) for a in nz])
    assert got.shape == (3, 3, 2 ** lg, 2 ** lg)
    _close(_nhwc(got), want, "image")


def test_synthesize_bf16(g_pair):
    """The port's bf16 image is no further from the float32 image than
    twice the JAX package's bf16 image is."""
    jg, params, tg = g_pair
    ws = np.random.RandomState(5).randn(3, 8, 16).astype(np.float32)
    nz = _noises(5, 3, 6)

    def jax_run(dt):
        out = jg.apply(params, jnp.asarray(ws, dt), 5, 1.0,
                       [jnp.asarray(a, dt) for a in nz], method="synthesize")
        return np.asarray(out.astype(jnp.float32))

    want, jax_bf16 = jax_run(jnp.float32), jax_run(jnp.bfloat16)
    got = tg.synthesize(torch.from_numpy(ws).bfloat16(), 5, 1.0,
                        [_nchw(a).bfloat16() for a in nz])
    assert got.dtype == torch.bfloat16
    got = _nhwc(got.float())
    for stat in (np.max, np.mean):
        err_port = float(stat(np.abs(got - want)))
        err_jax = float(stat(np.abs(jax_bf16 - want)))
        assert err_port <= 2 * err_jax, (stat.__name__, err_port, err_jax)


@pytest.fixture(scope="module")
def quiet_pair():
    """The G with its noise scales at 0: the two RNG streams then do not
    matter."""
    jcfg = jax_get_config("stylegan2-256", **G_SMALL)
    jg, _ = jax_build_models(jcfg.model)

    def f(path, leaf):
        return np.zeros_like(leaf) if "noise" in jax.tree_util.keystr(path) \
            else leaf

    params = jax.tree_util.tree_map_with_path(f, perturb(_tree(jg, 7), 8))
    cfg = get_config("stylegan2-256", **G_SMALL)
    tg = build_generator(cfg.model)
    tg.load_state_dict(from_flax(params))
    return jcfg, cfg, jg, params, tg.eval().requires_grad_(False)


@pytest.mark.parametrize("cutoff", [8, 3])
def test_sample_fn_truncated(quiet_pair, cutoff):
    jcfg, cfg, _, params, tg = quiet_pair
    jcfg = jcfg.replace(model=jcfg.model.__class__(**{
        **jcfg.model.__dict__, "truncation_cutoff": cutoff}))
    cfg = get_config("stylegan2-256", **dict(
        G_SMALL, **{"model.truncation_cutoff": cutoff}))
    rs = np.random.RandomState(9)
    z = rs.randn(3, 16).astype(np.float32)
    w_avg = rs.randn(16).astype(np.float32)
    want = jax_steps.build_sample_fn(jcfg, 5)(
        params, jnp.asarray(w_avg), jnp.asarray(z), jax.random.PRNGKey(1),
        0.7, 1.0)
    with torch.inference_mode():
        got = build_sample_fn(cfg, 5)(tg, torch.from_numpy(w_avg),
                                      torch.from_numpy(z), None, 0.7, 1.0)
    assert float(got.abs().max()) <= 1.0
    _close(_nhwc(got), want, "image", SAMPLE_TOL)


def test_generator_call_with_mixing(quiet_pair):
    _, _, jg, params, tg = quiet_pair
    rs = np.random.RandomState(10)
    z1, z2 = (rs.randn(3, 16).astype(np.float32) for _ in range(2))
    cross = np.array([0, 3, 8], np.int32)
    want = jg.apply(params, jnp.asarray(z1), 5, 1.0, jnp.asarray(z2),
                    jnp.asarray(cross), rngs={"noise": jax.random.PRNGKey(2)})
    with torch.inference_mode():
        got = tg(torch.from_numpy(z1), 5, 1.0, torch.from_numpy(z2),
                 torch.from_numpy(cross))
    _close(_nhwc(got), want, "image", SAMPLE_TOL)


# -- the residual discriminator ---------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_resnet_d_matches_jax(remat):
    over = dict(SMALL, **{"model.remat": remat})
    _, jd = jax_build_models(jax_get_config("stylegan2-256", **over).model)
    params = perturb(_tree(jd, 1), 2)
    _, td = build_models(get_config("stylegan2-256", **over).model)
    assert td.remat == remat and td.block16.resnet
    td.load_state_dict(from_flax(params))
    rs = np.random.RandomState(3)
    img = rs.randn(B, RES, RES, 3).astype(np.float32)
    ct = rs.randn(B).astype(np.float32)

    def f(p, x):
        return jnp.sum(jd.apply(p, x, LG, 1.0) * ct)

    want = jd.apply(params, jnp.asarray(img), LG, 1.0)
    want_p, want_x = jax.grad(f, (0, 1))(params, jnp.asarray(img))
    x = _nchw(img).requires_grad_()
    got = td(x, LG, 1.0)
    _close(got.detach().numpy(), want, "scores")
    (got * torch.from_numpy(ct)).sum().backward()
    _close(_nhwc(x.grad), want_x, "d/dimage")
    want_p = from_flax(jax.tree_util.tree_map(np.asarray, want_p))
    for name, p in td.named_parameters():
        if p.grad is None:       # the heads of the lower resolutions
            assert not want_p[name].any(), name
            continue
        _close(p.grad.numpy(), want_p[name].numpy(), name)
    assert td.block16.skip.w.grad.abs().max() > 0


# -- path-length regularization ---------------------------------------------

def _jax_pl_term(jg, params_g, pl_mean, z, noises, y, weight, decay):
    """``pl_term`` of ``ganlab_tpu/train/steps.py::build_train_step`` with
    its draws given: z, explicit noise maps and the projection y (NHWC,
    already scaled by 1/2^lg)."""
    w = jg.apply(params_g, z, method="map_latents")
    ws = jnp.repeat(w[:, None, :], NL, axis=1)

    def img_proj(ws_):
        img = jg.apply(params_g, ws_, LG, 1.0, noises, method="synthesize")
        return jnp.sum(img.astype(jnp.float32) * y)

    g = jax.grad(img_proj)(ws)
    pl_len = jnp.sqrt(jnp.mean(
        jnp.sum(jnp.square(g.astype(jnp.float32)), axis=2), axis=1))
    new_mean = pl_mean + jnp.float32(decay) * (jnp.mean(pl_len) - pl_mean)
    new_mean = jax.lax.stop_gradient(new_mean)
    pen = jnp.float32(weight) * jnp.mean(jnp.square(pl_len - new_mean))
    return pen, new_mean, pl_len


@pytest.fixture(scope="module")
def world():
    jcfg = jax_get_config("stylegan2-256", **SMALL)
    jg, jd = jax_build_models(jcfg.model)
    pg, pd = perturb(_tree(jg, 0), 1), perturb(_tree(jd, 1), 2)
    rs = np.random.RandomState(4)

    def gen_draws():
        return dict(z1=rs.randn(B, 16).astype(np.float32),
                    z2=rs.randn(B, 16).astype(np.float32),
                    use_mix=True, cross=3,
                    noises=[rs.randn(B, h, w, 1).astype(np.float32)
                            for h, w in jax_noise_shapes(LG)])

    data = dict(real=rs.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8),
                flip=np.array([True, False, False, True]),
                dd=gen_draws(), dg=gen_draws(),
                pl_z=rs.randn(NB, 16).astype(np.float32),
                pl_noises=[rs.randn(NB, h, w, 1).astype(np.float32)
                           for h, w in jax_noise_shapes(LG)],
                pl_y=(rs.randn(NB, RES, RES, 3) / RES).astype(np.float32),
                w_avg=rs.randn(16).astype(np.float32), pl_mean=0.3)
    cfg = get_config("stylegan2-256", **SMALL)
    return dict(jcfg=jcfg, jg=jg, jd=jd, pg=pg, pd=pd, cfg=cfg,
                phase=build_phases(cfg.schedule, cfg.model)[-1], **data)


def _pl_draws(w):
    return tsteps.PLDraws(torch.from_numpy(w["pl_z"]),
                          [_nchw(n) for n in w["pl_noises"]],
                          _nchw(w["pl_y"]))


def _step_draws(w):
    def gd(d):
        return tsteps.GenDraws(
            torch.from_numpy(d["z1"]), torch.from_numpy(d["z2"]),
            torch.tensor(d["use_mix"]), torch.tensor(d["cross"]),
            [_nchw(n) for n in d["noises"]])

    return tsteps.StepDraws(torch.from_numpy(w["flip"]), gd(w["dd"]),
                            gd(w["dg"]), torch.zeros(B, 1, 1, 1),
                            _pl_draws(w))


def _port_state(w):
    st = create_train_state(w["cfg"], seed=0, device="cpu")
    st.g.load_state_dict(from_flax(w["pg"]))
    st.d.load_state_dict(from_flax(w["pd"]))
    st.g_ema.load_state_dict(from_flax(w["pg"]))
    st.w_avg.copy_(torch.from_numpy(w["w_avg"]))
    st.pl_mean.fill_(w["pl_mean"])
    return st


def test_pl_term_matches_jax(world):
    """Lengths, the updated mean, the penalty and G's gradients of the
    penalty alone, the mapping layers' included."""
    w = world
    pen_j, mean_j, len_j = _jax_pl_term(
        w["jg"], w["pg"], jnp.float32(w["pl_mean"]), w["pl_z"],
        [jnp.asarray(n) for n in w["pl_noises"]], w["pl_y"], 2.0, 0.01)
    grads_j = jax.grad(lambda p: _jax_pl_term(
        w["jg"], p, jnp.float32(w["pl_mean"]), w["pl_z"],
        [jnp.asarray(n) for n in w["pl_noises"]], w["pl_y"], 2.0,
        0.01)[0])(w["pg"])

    g = _port_state(w).g
    pen, new_mean, pl_len = tsteps.path_length_penalty(
        g, torch.tensor(w["pl_mean"]), _pl_draws(w), LG, 1.0, weight=2.0,
        decay=0.01)
    assert pl_len.shape == (NB,) and not new_mean.requires_grad
    _close(pl_len.detach().numpy(), len_j, "pl_len")
    _close(float(new_mean), float(mean_j), "pl_mean")
    _close(float(pen.detach()), float(pen_j), "penalty")
    assert float(pen.detach()) > 0
    pen.backward()
    assert_grads(g, grads_j, "G of the PL penalty")
    mapping = [p.grad for n, p in g.named_parameters()
               if n.startswith("mapping.")]
    assert mapping and all(t is not None and t.abs().max() > 0
                           for t in mapping)


def _jax_step(w, r1: bool, pl: bool, new_d):
    """The sequential step of ``ganlab_tpu/train/steps.py`` for
    stylegan2-256 from its pieces, with the port's updated D for the G
    phase: R1 weighted x penalty_every and PL x pl_every where they fire
    (the lazy programs' weights)."""
    jg, jd, lc = w["jg"], w["jd"], w["jcfg"].loss
    real = jax_steps._preprocess(jnp.asarray(w["real"]), False, None,
                                 jnp.float32)
    real = jnp.where(jnp.asarray(w["flip"])[:, None, None, None],
                     real[:, :, ::-1, :], real)

    def gen_fwd(params_g, d):
        ww = jg.apply(params_g, jnp.concatenate([d["z1"], d["z2"]]),
                      method="map_latents")
        w1, w2 = ww[:B], ww[B:]
        ws = jax_mix_styles(w1, w2, jnp.where(d["use_mix"], d["cross"], NL),
                            NL)
        img = jg.apply(params_g, ws, LG, 1.0, list(d["noises"]),
                       method="synthesize")
        return img, jnp.mean(w1.astype(jnp.float32), axis=0)

    def d_apply(params_d, x):
        return jd.apply(params_d, x, LG, 1.0).astype(jnp.float32)

    def run(pg, pd, new_d, dd, dg, pl_z, pl_noises, pl_y, pl_mean):
        fake_d, _ = gen_fwd(pg, dd)

        def d_objective(params_d):
            real_s, fake_s = d_apply(params_d, real), d_apply(params_d,
                                                              fake_d)
            loss = JL.d_loss_nonsaturating(real_s, fake_s)
            pen = (JL.r1_penalty(lambda x: d_apply(params_d, x), real,
                                 lc.penalty_weight * lc.penalty_every)
                   if r1 else jnp.float32(0.0))
            return loss + pen, {"d_loss": loss, "penalty": pen,
                                "real_score": jnp.mean(real_s),
                                "fake_score": jnp.mean(fake_s)}

        (_, aux), d_grads = jax.value_and_grad(d_objective, has_aux=True)(pd)

        def g_objective(params_g):
            fake, w_mean = gen_fwd(params_g, dg)
            g_loss = JL.g_loss_nonsaturating(d_apply(new_d, fake))
            if not pl:
                return g_loss, (g_loss, jnp.float32(0.0), pl_mean, w_mean)
            pen, new_mean, _ = _jax_pl_term(
                jg, params_g, pl_mean, pl_z, pl_noises, pl_y,
                lc.pl_weight * lc.pl_every, lc.pl_decay)
            return g_loss + pen, (g_loss, pen, new_mean, w_mean)

        (_, (g_loss, pl_pen, new_mean, w_mean)), g_grads = \
            jax.value_and_grad(g_objective, has_aux=True)(pg)
        return (dict(aux, g_loss=g_loss, pl_penalty=pl_pen), d_grads,
                g_grads, new_mean, w_mean)

    return jax.jit(run)(w["pg"], w["pd"], new_d, w["dd"], w["dg"],
                        w["pl_z"], w["pl_noises"], w["pl_y"],
                        jnp.float32(w["pl_mean"]))


@pytest.fixture(scope="module",
                params=[(True, True), (False, True), (False, False)],
                ids=["r1_pl", "pl", "neither"])
def stepped(world, request):
    r1, pl = request.param
    st = _port_state(world)
    step = tsteps.build_train_step(world["cfg"], world["phase"],
                                   penalty_override=r1, pl_override=pl)
    st, metrics = step(st, torch.from_numpy(world["real"]),
                       _step_draws(world))
    want, d_grads, g_grads, new_mean, w_mean = _jax_step(
        world, r1, pl, to_flax(st.d))
    return dict(st=st, metrics=metrics, want=want, d_grads=d_grads,
                g_grads=g_grads, new_mean=new_mean, w_mean=w_mean, r1=r1,
                pl=pl)


def test_lazy_program_losses_and_pl_mean(stepped, world):
    m, want = stepped["metrics"], stepped["want"]
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score",
              "pl_penalty"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (float(m["penalty"]) > 0) == stepped["r1"]
    assert (float(m["pl_penalty"]) > 0) == stepped["pl"]
    st = stepped["st"]
    np.testing.assert_allclose(float(st.pl_mean), float(stepped["new_mean"]),
                               rtol=1e-5)
    assert (float(st.pl_mean) != float(np.float32(world["pl_mean"]))) == \
        stepped["pl"]
    wb = np.float32(world["jcfg"].model.w_avg_beta)
    np.testing.assert_allclose(
        st.w_avg.numpy(),
        world["w_avg"] * wb + np.asarray(stepped["w_mean"]) * (1 - wb),
        rtol=1e-5, atol=1e-6)


def test_lazy_program_d_gradients(stepped):
    assert_grads(stepped["st"].d, stepped["d_grads"], "D")


def test_lazy_program_g_gradients(stepped):
    """Every leaf of G, the mapping layers' included (they get gradients
    from the G loss and, on a PL program, from the penalty)."""
    assert_grads(stepped["st"].g, stepped["g_grads"], "G")
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for n, p in stepped["st"].g.named_parameters()
               if n.startswith("mapping."))


def test_make_lazy_stepper_builds_three_programs(world):
    """k = 16 and pl_every = 4: R1 + PL on step 0, PL alone on 4, 8 and
    12, neither on the rest; three step functions, weights x k and x 4."""
    st = create_train_state(world["cfg"], seed=3, device="cpu")
    stepper = make_lazy_stepper(world["cfg"], world["phase"])
    real = torch.from_numpy(world["real"])
    pens = []
    for _ in range(16):
        st, m = stepper(st, real)
        pens.append((float(m["penalty"]) > 0, float(m["pl_penalty"]) > 0))
    assert pens == [(i == 0, i % 4 == 0) for i in range(16)]
    weights = {k: (f.pen_weight, f.pl_weight)
               for k, f in stepper.programs.items()}
    assert weights == {(True, True): (160.0, 8.0), (False, True): (0.0, 8.0),
                       (False, False): (0.0, 0.0)}
    assert float(st.pl_mean) > 0


def test_adam_matches_optax_with_pl_compensation(world):
    """G's Adam takes lr x 4/5 and betas ** (4/5) from pl_every, D's 16/17
    from penalty_every: updates against optax's on the same gradients."""
    st = _port_state(world)
    opt_g, opt_d = make_optimizers(world["cfg"], st.g, st.d)
    assert opt_g.param_groups[0]["lr"] == pytest.approx(1e-3 * 4 / 5)
    assert opt_d.param_groups[0]["lr"] == pytest.approx(1e-3 * 16 / 17)
    jopt_g, jopt_d = jax_make_optimizers(world["jcfg"])
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


def test_pl_with_n_critic_raises(world):
    cfg = get_config("stylegan2-256", **dict(SMALL, **{
        "loss.d_steps_per_g": 2}))
    with pytest.raises(ValueError, match="d_steps_per_g"):
        tsteps.build_train_step(cfg, world["phase"])
    no_pl = get_config("stylegan2-256", **dict(SMALL, **{
        "loss.pl_weight": 0.0}))
    with pytest.raises(ValueError, match="pl_override"):
        tsteps.build_train_step(no_pl, world["phase"], pl_override=True)


# -- launch counts ----------------------------------------------------------

PLAIN = {"pixelnorm": (pixelnorm, "pixel_norm_ref"),
         "upsample_blur_2x": (resample, "upsample_blur_2x_ref"),
         "blur_downsample_2x": (resample, "blur_downsample_2x_ref"),
         "minibatch_stddev": (mbstd, "minibatch_stddev_ref")}


@pytest.fixture
def counts(monkeypatch):
    """kernel -> Counter of the input shapes its plain version saw."""
    seen = collections.defaultdict(collections.Counter)
    for name, (mod, attr) in PLAIN.items():
        def counted(x, *a, _f=getattr(mod, attr), _n=name, **k):
            seen[_n][tuple(x.shape)] += 1
            return _f(x, *a, **k)
        monkeypatch.setattr(mod, attr, counted)
    return seen


@pytest.mark.parametrize("pl", [False, True], ids=["pl_off", "pl_on"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_stylegan2_step_launches_match_a_counted_step(counts, r1, pl):
    """On the card each call of a kernel's Function launches the kernel
    once; on the CPU the same call runs the plain version, so counting
    those calls counts the step's launches, shape by shape."""
    cfg = get_config("stylegan2-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "schedule.batch_schedule": {32: 4}})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1,
                                   pl_override=pl)
    counts.clear()
    step(state, torch.zeros(4, 32, 32, 3, dtype=torch.uint8))
    want = chip_smoke.stylegan2_step_launches(cfg.model, r1, pl, batch=4,
                                              pl_batch=2)
    assert {n: dict(c) for n, c in counts.items()} == want

    counts.clear()
    with torch.inference_mode():
        build_sample_fn(cfg, 5)(state.g_ema, state.w_avg, torch.zeros(3, 8))
    assert {n: dict(c) for n, c in counts.items()} == \
        chip_smoke.stylegan2_serving_launches(cfg.model, batch=3)


# -- checkpoints ------------------------------------------------------------

def _batch(i):
    return torch.from_numpy(np.random.RandomState(100 + i).randint(
        0, 256, (B, RES, RES, 3)).astype(np.uint8))


def _run(cfg, state, start, n):
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    stepper = make_lazy_stepper(cfg, phase, initial_step=start)
    for i in range(start, start + n):
        state, _ = stepper(state, _batch(i))
    return state


def _assert_bitwise(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, bad[:5]


def test_pl_mean_checkpoint_round_trip(tmp_path):
    cfg = get_config("stylegan2-256", **SMALL)
    st = _run(cfg, create_train_state(cfg, seed=0, device="cpu"), 0, 1)
    assert float(st.pl_mean) > 0 and "pl_mean" in state_tensors(st)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(st.step, st)
    back = ckpt.restore(create_train_state(cfg, seed=9, device="cpu"))
    _assert_bitwise(back, st)


def test_bitwise_resume_across_a_pl_step(tmp_path):
    """Steps 0-5 in one go against 0-2, a checkpoint, a new process's state
    and steps 3-5: PL fires at 4, R1 at 0."""
    cfg = get_config("stylegan2-256", **SMALL)
    whole = _run(cfg, create_train_state(cfg, seed=0, device="cpu"), 0, 6)
    first = _run(cfg, create_train_state(cfg, seed=0, device="cpu"), 0, 3)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(first.step, first)
    resumed = ckpt.restore(create_train_state(cfg, seed=1, device="cpu"))
    assert resumed.step == 3
    _assert_bitwise(_run(cfg, resumed, 3, 3), whole)


def test_pre_pl_checkpoint_resumes_into_pl_config(tmp_path):
    """As the JAX package's migration: a checkpoint without pl_mean gives a
    PL config a fresh 0, whose first PL step runs; one with pl_mean
    resumes into a config without PL by dropping it."""
    old = get_config("stylegan2-256", **dict(SMALL, **{
        "loss.pl_weight": 0.0}))
    new = get_config("stylegan2-256", **SMALL)
    st_old = create_train_state(old, seed=0, device="cpu")
    assert st_old.pl_mean is None
    ckpt = CheckpointManager(str(tmp_path / "a"))
    ckpt.save(0, st_old)
    template = create_train_state(new, seed=1, device="cpu")
    template.pl_mean.fill_(5.0)
    st = ckpt.restore(template)
    assert float(st.pl_mean) == 0.0
    phase = build_phases(new.schedule, new.model)[-1]
    st, m = make_lazy_stepper(new, phase)(st, _batch(0))
    assert float(m["pl_penalty"]) > 0 and float(st.pl_mean) > 0

    ckpt2 = CheckpointManager(str(tmp_path / "b"))
    ckpt2.save(1, st)
    back = ckpt2.restore(create_train_state(old, seed=2, device="cpu"))
    assert back.pl_mean is None and "pl_mean" not in state_tensors(back)
    assert torch.equal(back.w_avg, st.w_avg)


def test_load_jax_train_state_carries_pl_mean():
    jcfg = jax_get_config("stylegan2-256", **SMALL)
    js = jax_create_state(jcfg, jax.random.PRNGKey(0))
    js = js.replace(pl_mean=jnp.float32(0.37))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def adam(opt):
        return {"count": int(opt[0].count), "mu": np_(opt[0].mu),
                "nu": np_(opt[0].nu)}

    arrays = {"params_g": np_(js.params_g), "params_d": np_(js.params_d),
              "params_ema": np_(js.params_ema), "opt_g": adam(js.opt_g),
              "opt_d": adam(js.opt_d), "w_avg": np.asarray(js.w_avg),
              "step": 0, "shown_imgs": 0, "pl_mean": np.asarray(js.pl_mean)}
    cfg = get_config("stylegan2-256", **SMALL)
    st = load_jax_train_state(create_train_state(cfg, seed=0, device="cpu"),
                              arrays, cfg)
    assert float(st.pl_mean) == pytest.approx(0.37)
    for name, t in st.g.state_dict().items():
        np.testing.assert_array_equal(
            t.numpy(), from_flax(arrays["params_g"])[name].numpy())
    del arrays["pl_mean"]
    st.pl_mean.fill_(3.0)
    assert float(load_jax_train_state(st, arrays, cfg).pl_mean) == 0.0


# -- PPL ----------------------------------------------------------------------

@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_pairs_match_jax(space):
    over = dict(G_SMALL, **{"model.resolution": 16})
    _, jg, params, g = _pair("stylegan2-256", over, 0)
    rs = np.random.RandomState(1)
    b, eps = 3, 1e-2
    z = rs.randn(2, b, 16).astype(np.float32)
    t = rs.rand(b, 1).astype(np.float32)
    noises = [rs.randn(b, h, w, 1).astype(np.float32)
              for h, w in jax_noise_shapes(LG)]
    want = _jax_pairs(jg, params, jnp.asarray(z), jnp.asarray(t), eps,
                      space, LG, [jnp.asarray(n) for n in noises], True)
    got = ppl_pairs(get_config("stylegan2-256", **over), g,
                    torch.from_numpy(z), torch.from_numpy(t), eps, space, LG,
                    [_nchw(n) for n in noises])
    for a, w in zip(got, want):
        _close(_nhwc(a), w, f"pair image ({space})")
    assert not np.array_equal(_nhwc(got[0]), _nhwc(got[1]))


def test_ppl_draws_the_family_noise():
    cfg = get_config("stylegan2-256")
    _, _, noises = next(_drawn(cfg, "full", 2, 8, 0, "cpu"))
    assert [tuple(n.shape[2:]) for n in noises] == noise_shapes(cfg.model, 8)
    assert len(noises) == 13


# -- the command line --------------------------------------------------------

def _train_args(preset, wd, over, steps):
    args = ["train", "--preset", preset, "--device", "cpu", "--workdir", wd,
            "--max-steps", str(steps)]
    for k, v in over.items():
        args += ["--set", f"{k}={v}"]
    return args


def test_cli_train_sample_eval_ppl_stylegan2(tmp_path, capsys):
    """``cli train --preset stylegan2-256`` (narrowed) logs pl_penalty every
    step, > 0 on steps 1 and 5 of the log (counter 0 and 4); then ``cli
    sample`` and ``cli eval-ppl --space w`` from the workdir."""
    wd = str(tmp_path / "run")
    # a row every step (chunked stepping logs once a chunk)
    over = dict(SMALL, **{"run.log_every": 1, "run.chunk_steps": False})
    assert cli.main(_train_args("stylegan2-256", wd, over, 5)) == 0
    with open(os.path.join(wd, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["pl_penalty"] > 0 for r in rows] == \
        [True, False, False, False, True]
    assert rows[0]["penalty"] > 0 and rows[1]["penalty"] == 0
    png = str(tmp_path / "grid.png")
    assert cli.main(["sample", "--workdir", wd, "--device", "cpu",
                     "--num", "4", "--out", png]) == 0
    assert os.path.getsize(png) > 0
    capsys.readouterr()
    assert cli.main(["eval-ppl", "--workdir", wd, "--device", "cpu",
                     "--num-samples", "8", "--space", "w"]) == 0
    assert "PPL (w-full, n=8):" in capsys.readouterr().out


def test_cli_train_stylegan_with_pl(tmp_path):
    """``stylegan-256 --set loss.pl_weight=2``: path length on the AdaIN G
    too (JAX's pl_active covers both style families)."""
    wd = str(tmp_path / "run")
    over = {"model.resolution": 16, "model.fmap_base": 128,
            "model.fmap_max": 16, "model.latent_dim": 16,
            "model.mapping_layers": 2, "run.compute_dtype": "float32",
            "schedule.progressive": False, "schedule.batch_schedule":
            {16: B}, "data.dataset": "synthetic", "loss.pl_weight": 2.0,
            "run.log_every": 1, "run.chunk_steps": False}
    assert cli.main(_train_args("stylegan-256", wd, over, 2)) == 0
    with open(os.path.join(wd, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["pl_penalty"] > 0 for r in rows] == [True, False]
    assert all(np.isfinite(r["pl_penalty"]) for r in rows)

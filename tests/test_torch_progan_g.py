"""The port's ProGAN generator, pixelnorm over NCHW channels and the ProGAN
training steps vs the JAX package at a small config.

* ``pixel_norm(x, dim=1)`` (the plain version, which the CPU runs) on the
  same numpy input against the JAX ``pixel_norm`` (XLA) and against
  ``pixel_norm_pallas(..., interpret=True)`` on its NHWC transpose, values
  and VJP, float32 within 1e-5; bfloat16 against the Pallas reference (it
  works in float32, as the port does; the XLA path squares in x's dtype)
  within 2 bf16 ulps of the scale; a float64 ``gradcheck``.
* The generator (progan-128 cut to 16x16, fmap_base 64, latent 16): one
  flax tree, perturbed by seeded numpy noise, converted with
  ``from_flax``; images at 8x8 and 16x16, stabilize and alpha 0.4, with and
  without ``model.remat``, within 1e-5; parameter gradients within 1e-4 of
  each leaf's scale.
* One training step each, leaf by leaf against a harness built from the
  JAX pieces (as ``test_torch_train_step.py`` does): progan-128's WGAN-GP
  with drift in a fade phase (the interpolation weights injected), and
  progan-64's R1. Losses 1e-4 relative, gradients 1e-4 of the leaf scale.
* ``cli train --preset progan-128`` for a few steps on the CPU through the
  4x4 stabilize and 8x8 fade phases.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.ops.normalization import pixel_norm as jax_pixel_norm
from ganlab_tpu.ops.pallas.pixelnorm import pixel_norm_pallas
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.models.progan import ProGenerator
from ganlab_tpu_torch.ops import pixel_norm
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    PixelNorm,
    pixel_norm_nchw_ref,
)
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_train_step import perturb, to_flax

torch.set_num_threads(1)

RES, B = 16, 4
SMALL = {"model.resolution": RES, "model.fmap_base": 64,
         "model.latent_dim": 16, "run.compute_dtype": "float32"}
REL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# -- pixelnorm over dim 1 ------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 4, 32), (3, 8, 8, 16),
                                   (2, 7, 5, 3)])
def test_pixel_norm_dim1_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 1.7
    got = pixel_norm(_nchw(x), dim=1)
    for want in (jax_pixel_norm(jnp.asarray(x)),
                 pixel_norm_pallas(jnp.asarray(x), 1e-8, True)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # the VJP, against jax.vjp of both JAX versions
    ct = np.random.RandomState(1).randn(*shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(pixel_norm(xt, dim=1), xt, _nchw(ct))
    for fn in (jax_pixel_norm,
               lambda a: pixel_norm_pallas(a, 1e-8, True)):
        _, vjp = jax.vjp(fn, jnp.asarray(x))
        (want,) = vjp(jnp.asarray(ct))
        np.testing.assert_allclose(_nhwc(gx), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_pixel_norm_dim1_bf16_matches_pallas():
    x = np.random.RandomState(2).randn(2, 8, 8, 16).astype(np.float32) * 3
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pixel_norm_pallas(xb, 1e-8, True), np.float32)
    xt = _nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = pixel_norm(xt, dim=1)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    np.testing.assert_allclose(_nhwc(got.float()), want, rtol=0,
                               atol=2 * ulp)


def test_pixel_norm_dim1_gradcheck_and_layouts():
    x = torch.randn(2, 5, 3, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: PixelNorm.apply(t, 1e-8, 1),
                                    (x,))
    assert torch.autograd.gradgradcheck(
        lambda t: PixelNorm.apply(t, 1e-8, 1), (x,))
    # dim=1 of NCHW is the last axis of the NHWC permutation
    xf = x.detach().float()
    torch.testing.assert_close(
        pixel_norm_nchw_ref(xf),
        pixel_norm(xf.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="dim"):
        pixel_norm(xf, dim=2)


# -- the generator -------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_pair():
    jcfg = jax_get_config("progan-128", **SMALL)
    jg, _ = jax_build_models(jcfg.model)
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(0))), seed=1)
    return jcfg, params


def test_from_flax_covers_every_g_parameter(gen_pair):
    _, params = gen_pair
    g, _ = build_models(get_config("progan-128", **SMALL).model)
    assert isinstance(g, ProGenerator)
    sd = from_flax(params)
    assert set(sd) == set(g.state_dict())
    g.load_state_dict(sd)
    for name, shape in (("block4.dense.w", (16, 16 * 32)),
                        ("block4.conv.w", (32, 32, 3, 3)),
                        ("block8.conv0.w", (16, 32, 3, 3)),
                        ("block16.conv1.b", (8,)),
                        ("torgb16.w", (3, 8, 1, 1))):
        assert tuple(g.state_dict()[name].shape) == shape, name


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("lg,alpha", [(3, 1.0), (4, 1.0), (4, 0.4)])
def test_generator_matches_jax(gen_pair, lg, alpha, remat):
    jcfg, params = gen_pair
    over = dict(SMALL, **{"model.remat": remat})
    jg, _ = jax_build_models(jax_get_config("progan-128", **over).model)
    g, _ = build_models(get_config("progan-128", **over).model)
    g.load_state_dict(from_flax(params))
    rs = np.random.RandomState(3)
    z = rs.randn(3, 16).astype(np.float32)
    ct = rs.randn(3, 2 ** lg, 2 ** lg, 3).astype(np.float32)
    ja = 1.0 if alpha == 1.0 else jnp.float32(alpha)

    def loss(p):
        return jnp.sum(jg.apply(p, jnp.asarray(z), lg, ja) * ct)

    want = jg.apply(params, jnp.asarray(z), lg, ja)
    want_g = from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    got = g(torch.from_numpy(z), lg, alpha)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    (got * _nchw(ct)).sum().backward()
    for name, p in g.named_parameters():
        ref = want_g[name].numpy()
        if p.grad is None:      # a head of another resolution
            assert not ref.any(), name
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=REL * max(float(np.abs(ref).max()), 1e-12), err_msg=name)


def test_batch_sampler_serves_a_progan_generator(gen_pair):
    """``BatchSampler(params=)`` takes a flax tree of a ProGAN G-EMA with no
    w-average (the family has none; a style family still needs one) and
    keeps the serving contract: index-stable latents, a fixed batch."""
    from ganlab_tpu_torch.serve import BatchSampler

    _, params = gen_pair
    cfg = get_config("progan-128", **SMALL)
    s = BatchSampler(cfg, params=params, batch_size=4, device="cpu")
    a = s.generate(6, seed=1)
    assert a.shape == (6, RES, RES, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a[:3], s.generate(3, seed=1))
    assert float(a.astype(np.float32).std()) > 1.0
    with pytest.raises(ValueError, match="w_avg"):
        BatchSampler(get_config("stylegan-256", **{
            "model.resolution": 16, "model.fmap_base": 64}),
            params={"x": np.zeros(1)}, device="cpu")


def test_generator_rejects_tpu_knobs():
    """fused_up_conv (tests/test_torch_up2conv.py) and fold_width
    (tests/test_torch_folded.py) are ported: under fold_width every block
    of this narrow G folds, and its images are the unfolded G's."""
    ProGenerator(get_config("progan-128", **dict(
        SMALL, **{"model.fused_up_conv": True})).model)
    torch.manual_seed(0)
    g = ProGenerator(get_config("progan-128", **dict(
        SMALL, **{"model.fold_width": True})).model)
    torch.manual_seed(0)
    ref = ProGenerator(get_config("progan-128", **SMALL).model)
    assert [g.block8.fold, g.block16.fold] == [True, True]
    z = torch.from_numpy(np.random.RandomState(4).randn(B, 16).astype(
        np.float32))
    with torch.no_grad():
        torch.testing.assert_close(g(z), ref(z), rtol=REL, atol=REL)


# -- one training step against a harness of JAX pieces --------------------------

def _jax_step(jcfg, lg, alpha, pg, pd, new_d, real, flip, z_d, z_g, gp_key):
    """The sequential step of ``ganlab_tpu/train/steps.py`` for a family
    without a mapping network, from its pieces, with the port's updated D
    for the G phase."""
    jg, jd = jax_build_models(jcfg.model)
    lc = jcfg.loss
    ja = 1.0 if alpha is None else jnp.float32(alpha)
    x = jax_steps._preprocess(jnp.asarray(real), False, None, jnp.float32)
    x = jnp.where(jnp.asarray(flip)[:, None, None, None], x[:, :, ::-1, :], x)

    def d_apply(p, imgs):
        return jd.apply(p, imgs, lg, ja).astype(jnp.float32)

    def run(pg, pd, new_d):
        fake_d = jg.apply(pg, z_d, lg, ja)

        def d_objective(p):
            real_s, fake_s = d_apply(p, x), d_apply(p, fake_d)
            loss = JL.D_LOSSES[lc.loss](real_s, fake_s)
            critic = lambda imgs: d_apply(p, imgs)  # noqa: E731
            pen = (JL.wgan_gp(critic, x, fake_d, gp_key, lc.penalty_weight)
                   if lc.penalty == "wgan-gp"
                   else JL.r1_penalty(critic, x, lc.penalty_weight))
            if lc.drift_weight:
                pen = pen + JL.drift_penalty(real_s, lc.drift_weight)
            return loss + pen, {"d_loss": loss, "penalty": pen,
                                "real_score": jnp.mean(real_s),
                                "fake_score": jnp.mean(fake_s)}

        (_, aux), d_grads = jax.value_and_grad(d_objective, has_aux=True)(pd)

        def g_objective(p):
            return JL.G_LOSSES[lc.loss](d_apply(new_d, jg.apply(p, z_g, lg,
                                                                 ja)))

        g_loss, g_grads = jax.value_and_grad(g_objective)(pg)
        return dict(aux, g_loss=g_loss), d_grads, g_grads

    return jax.jit(run)(pg, pd, new_d)


def assert_grads(module, want_tree, what):
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    named = dict(module.named_parameters())
    assert set(named) == set(want), what
    for name, p in named.items():
        ref = want[name].numpy()
        if p.grad is None:
            assert not ref.any(), (what, name)
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=REL * max(float(np.abs(ref).max()), 1e-12),
            err_msg=f"{what} {name}")


def run_step_pair(preset, over, phase_index, shown=None, seed=0):
    """One port step from perturbed weights and injected draws, and the JAX
    harness on the same; returns (port state, metrics, harness outputs,
    EMA tree before the step)."""
    jcfg = jax_get_config(preset, **over)
    cfg = get_config(preset, **over)
    jg, jd = jax_build_models(jcfg.model)
    pg = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(seed))), seed + 1)
    pd = perturb(jax.tree_util.tree_map(
        np.asarray, jd.init_all(jax.random.PRNGKey(seed + 1))), seed + 2)
    phase = build_phases(cfg.schedule, cfg.model)[phase_index]
    b, res = phase.batch_size, phase.resolution
    rs = np.random.RandomState(seed + 4)
    real = rs.randint(0, 256, (b, res, res, 3)).astype(np.uint8)
    flip = rs.rand(b) < 0.5
    z_d = rs.randn(b, cfg.model.latent_dim).astype(np.float32)
    z_g = rs.randn(b, cfg.model.latent_dim).astype(np.float32)
    gp_key = jax.random.PRNGKey(seed + 5)
    gp_eps = np.array(jax.random.uniform(gp_key, (b, 1, 1, 1)))

    st = create_train_state(cfg, seed=0, device="cpu")
    if shown is not None:
        st.shown_imgs = shown
    st.g.load_state_dict(from_flax(pg))
    st.d.load_state_dict(from_flax(pd))
    st.g_ema.load_state_dict(from_flax(perturb(pg, seed + 3, 0.1)))
    ema_before = to_flax(st.g_ema)
    draws = tsteps.StepDraws(torch.from_numpy(flip),
                             tsteps.GenDraws(torch.from_numpy(z_d)),
                             tsteps.GenDraws(torch.from_numpy(z_g)),
                             torch.from_numpy(gp_eps))
    st, metrics = tsteps.build_train_step(cfg, phase)(
        st, torch.from_numpy(real), draws)
    alpha = metrics["alpha"] if phase.kind == "fade" else None
    want = _jax_step(jcfg, phase.res_log2, alpha, pg, pd, to_flax(st.d),
                     real, flip, jnp.asarray(z_d), jnp.asarray(z_g), gp_key)
    return jcfg, st, metrics, want, ema_before


STEP_CASES = {
    # progan-128: WGAN-GP + drift every step, in the 16x16 fade phase
    "progan128_wgan_gp_drift_fade": (
        "progan-128", dict(SMALL, **{"schedule.fade_kimg": 0.016,
                                     "schedule.stabilize_kimg": 0.016,
                                     "schedule.batch_schedule": {4: B, 8: B,
                                                                 16: B}}),
        3, 56),
    # progan-64: R1 every step, fixed resolution
    "progan64_r1": ("progan-64", dict(SMALL, **{
        "schedule.start_res": RES, "schedule.batch_schedule": {RES: B}}),
        0, None),
}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def stepped(request):
    preset, over, index, shown = STEP_CASES[request.param]
    return (request.param, *run_step_pair(preset, over, index, shown))


def test_progan_step_matches_jax(stepped):
    case, jcfg, st, metrics, (want, d_grads, g_grads), ema_before = stepped
    if "fade" in case:
        # 16x16 fade [48, 64) at batch 4: shown 56 -> alpha 0.5
        assert metrics["alpha"] == pytest.approx(0.5)
        assert jcfg.loss.penalty == "wgan-gp" and jcfg.loss.drift_weight
    else:
        assert jcfg.loss.penalty == "r1" and metrics["alpha"] == 1.0
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score"):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]),
                                   rtol=REL, atol=1e-6, err_msg=k)
    assert float(metrics["penalty"]) > 0
    assert_grads(st.d, d_grads, "D")
    assert_grads(st.g, g_grads, "G")
    # G-EMA blended with the updated G; no w-average for this family
    beta = jcfg.optim.ema_beta_for(B)
    want_ema = from_flax(jax.tree_util.tree_map(
        np.asarray, jax_steps._ema_update(ema_before, to_flax(st.g), beta)))
    for name, t in st.g_ema.state_dict().items():
        ref = want_ema[name].numpy()
        np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()),
                                   err_msg=name)
    assert not st.w_avg.any() and st.step == 1


# -- cli train ---------------------------------------------------------------

def test_cli_train_progan128_through_a_fade(tmp_path, capsys):
    """Four steps of the progan-128 preset on the CPU, narrow: two of the
    4x4 stabilize phase and two of the 8x8 fade, with WGAN-GP and drift
    every step."""
    wd = str(tmp_path / "run")
    args = ["train", "--preset", "progan-128", "--device", "cpu",
            "--workdir", wd, "--max-steps", "4"]
    for k, v in {"model.resolution": 16, "model.fmap_base": 64,
                 "model.latent_dim": 16, "data.dataset": "ellipses",
                 "schedule.fade_kimg": 0.008,
                 "schedule.stabilize_kimg": 0.008,
                 "schedule.batch_schedule": {4: B, 8: B, 16: B},
                 "run.log_every": 1}.items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    rows = [json.loads(line) for line in open(f"{wd}/train.jsonl")]
    assert [(r["res"], r["kind"], r["alpha"]) for r in rows] == [
        (4, "stabilize", 1.0), (4, "stabilize", 1.0), (8, "fade", 0.0),
        (8, "fade", 0.5)]
    assert all(r["penalty"] > 0 and math.isfinite(r["d_loss"])
               and math.isfinite(r["g_loss"]) for r in rows)
    assert "final samples" in capsys.readouterr().out

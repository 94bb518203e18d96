"""Gradient accumulation of the port (``optim.grad_accum``) vs a JAX
harness built from the JAX package's pieces.

Small ``stylegan2-256`` (16², fmap_max 16, latent 16, 2 mapping layers,
float32, JAX matmuls at ``highest``), two microbatches of 4. Both sides
start from the same perturbed flax trees and take the same injected draws
per microbatch (flips, latents, mixing, noise maps, the path-length batch),
made with numpy. The harness is the JAX package's ``step_accum`` written
out from ``map_latents`` / ``synthesize``, ``mix_styles``, the
discriminator's ``apply``, ``ganlab_tpu.ops.losses`` and the path-length
term of ``tests/test_torch_stylegan2.py``: D's gradient is the mean of the
microbatches' gradients at the step's D; G's is the mean of the
microbatches' gradients against the port's updated D, with ``pl_mean``
chained from one microbatch to the next at the decay
1 - (1 - pl_decay)^(1/2) (``ganlab_tpu/train/steps.py:641-642``).

Compared on the R1 + PL program and on the program with neither: every
gradient leaf of D and of G (1e-4 of the leaf's largest magnitude), the
metrics (means over the microbatches, 1e-4 relative), ``pl_mean`` and the
w-average (1e-5 relative). Then, without JAX: every preset family trains
with two microbatches (finite losses, the global batch counted, n-critic
leaving G alone off its steps), a microbatch count that does not divide
the batch or draws of the wrong count raise, and ``loss.fused_g_step``
with accumulation raises the JAX package's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.stylegan import mix_styles as jax_mix_styles
from ganlab_tpu.models.stylegan2 import noise_shapes as jax_noise_shapes
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_progan_g import _nchw
from tests.test_torch_stylegan2 import _jax_pl_term, _tree
from tests.test_torch_train_step import assert_grads, perturb, to_flax

torch.set_num_threads(1)

A, B, RES, LG = 2, 4, 16, 4
NL, NB = 2 * (LG - 1), B // 2
SMALL = {"model.resolution": RES, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32",
         "schedule.batch_schedule": {RES: B}, "data.dataset": "synthetic",
         "optim.grad_accum": A}


@pytest.fixture(scope="module")
def world():
    jcfg = jax_get_config("stylegan2-256", **SMALL)
    jg, jd = jax_build_models(jcfg.model)
    pg, pd = perturb(_tree(jg, 0), 1), perturb(_tree(jd, 1), 2)
    rs = np.random.RandomState(4)

    def gen_draws():
        return dict(z1=rs.randn(B, 16).astype(np.float32),
                    z2=rs.randn(B, 16).astype(np.float32),
                    use_mix=True, cross=2 + len(micro) % 2,
                    noises=[rs.randn(B, h, w, 1).astype(np.float32)
                            for h, w in jax_noise_shapes(LG)])

    micro = []
    for _ in range(A):
        micro.append(dict(
            flip=rs.rand(B) < 0.5, dd=gen_draws(), dg=gen_draws(),
            pl_z=rs.randn(NB, 16).astype(np.float32),
            pl_noises=[rs.randn(NB, h, w, 1).astype(np.float32)
                       for h, w in jax_noise_shapes(LG)],
            pl_y=(rs.randn(NB, RES, RES, 3) / RES).astype(np.float32)))
    cfg = get_config("stylegan2-256", **SMALL)
    return dict(jcfg=jcfg, jg=jg, jd=jd, pg=pg, pd=pd, cfg=cfg, micro=micro,
                phase=build_phases(cfg.schedule, cfg.model)[-1],
                real=rs.randint(0, 256, (A * B, RES, RES, 3)).astype(
                    np.uint8),
                w_avg=rs.randn(16).astype(np.float32), pl_mean=0.3)


def _port_draws(m):
    def gd(d):
        return tsteps.GenDraws(
            torch.from_numpy(d["z1"]), torch.from_numpy(d["z2"]),
            torch.tensor(d["use_mix"]), torch.tensor(d["cross"]),
            [_nchw(n) for n in d["noises"]])

    return tsteps.StepDraws(
        torch.from_numpy(m["flip"]), gd(m["dd"]), gd(m["dg"]),
        torch.zeros(B, 1, 1, 1),
        tsteps.PLDraws(torch.from_numpy(m["pl_z"]),
                       [_nchw(n) for n in m["pl_noises"]],
                       _nchw(m["pl_y"])))


def _port_state(w):
    st = create_train_state(w["cfg"], seed=0, device="cpu")
    st.g.load_state_dict(from_flax(w["pg"]))
    st.d.load_state_dict(from_flax(w["pd"]))
    st.g_ema.load_state_dict(from_flax(w["pg"]))
    st.w_avg.copy_(torch.from_numpy(w["w_avg"]))
    st.pl_mean.fill_(w["pl_mean"])
    return st


def _jax_accum_step(w, r1: bool, pl: bool, new_d):
    """``step_accum`` of ``ganlab_tpu/train/steps.py`` from its pieces,
    with the port's updated D for the G phase."""
    jg, jd, lc = w["jg"], w["jd"], w["jcfg"].loss
    decay = 1.0 - (1.0 - lc.pl_decay) ** (1.0 / A)

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

    def run(pg, pd, new_d, micro, real_u8, pl_mean):
        d_sum, g_sum, auxs = None, None, []
        for j, m in enumerate(micro):
            real = jax_steps._preprocess(real_u8[j * B:(j + 1) * B], False,
                                         None, jnp.float32)
            real = jnp.where(jnp.asarray(m["flip"])[:, None, None, None],
                             real[:, :, ::-1, :], real)
            fake_d, _ = gen_fwd(pg, m["dd"])

            def d_objective(params_d):
                real_s = d_apply(params_d, real)
                fake_s = d_apply(params_d, fake_d)
                loss = JL.d_loss_nonsaturating(real_s, fake_s)
                pen = (JL.r1_penalty(lambda x: d_apply(params_d, x), real,
                                     lc.penalty_weight * lc.penalty_every)
                       if r1 else jnp.float32(0.0))
                return loss + pen, {"d_loss": loss, "penalty": pen,
                                    "real_score": jnp.mean(real_s),
                                    "fake_score": jnp.mean(fake_s)}

            (_, aux), grads = jax.value_and_grad(d_objective,
                                                 has_aux=True)(pd)

            def g_objective(params_g, pl_m=pl_mean):
                fake, w_mean = gen_fwd(params_g, m["dg"])
                g_loss = JL.g_loss_nonsaturating(d_apply(new_d, fake))
                if not pl:
                    return g_loss, (g_loss, jnp.float32(0.0), pl_m, w_mean)
                pen, new_mean, _ = _jax_pl_term(
                    jg, params_g, pl_m, m["pl_z"], m["pl_noises"],
                    m["pl_y"], lc.pl_weight * lc.pl_every, decay)
                return g_loss + pen, (g_loss, pen, new_mean, w_mean)

            (_, (g_loss, pl_pen, pl_mean, w_mean)), g_grads = \
                jax.value_and_grad(g_objective, has_aux=True)(pg)
            auxs.append(dict(aux, g_loss=g_loss, pl_penalty=pl_pen,
                             w_mean=w_mean))
            add = lambda a, b: jax.tree_util.tree_map(  # noqa: E731
                jnp.add, a, b)
            d_sum = grads if d_sum is None else add(d_sum, grads)
            g_sum = g_grads if g_sum is None else add(g_sum, g_grads)
        mean = {k: sum(a[k] for a in auxs) / A for k in auxs[0]}
        scale = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: x / A, t)
        return mean, scale(d_sum), scale(g_sum), pl_mean

    return jax.jit(run)(w["pg"], w["pd"], new_d, w["micro"], w["real"],
                        jnp.float32(w["pl_mean"]))


@pytest.fixture(scope="module", params=[(True, True), (False, False)],
                ids=["r1_pl", "neither"])
def stepped(world, request):
    r1, pl = request.param
    st = _port_state(world)
    step = tsteps.build_train_step(world["cfg"], world["phase"],
                                   penalty_override=r1, pl_override=pl)
    st, metrics = step(st, torch.from_numpy(world["real"]),
                       [_port_draws(m) for m in world["micro"]])
    want, d_grads, g_grads, new_mean = _jax_accum_step(
        world, r1, pl, to_flax(st.d))
    return dict(st=st, metrics=metrics, want=want, d_grads=d_grads,
                g_grads=g_grads, new_mean=new_mean, r1=r1, pl=pl)


def test_accum_metrics_pl_mean_and_w_avg(stepped, world):
    m, want, st = stepped["metrics"], stepped["want"], stepped["st"]
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score",
              "pl_penalty"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (float(m["penalty"]) > 0) == stepped["r1"]
    assert (float(m["pl_penalty"]) > 0) == stepped["pl"]
    np.testing.assert_allclose(float(st.pl_mean), float(stepped["new_mean"]),
                               rtol=1e-5)
    assert (float(st.pl_mean) != np.float32(world["pl_mean"])) == \
        stepped["pl"]
    wb = np.float32(world["jcfg"].model.w_avg_beta)
    np.testing.assert_allclose(
        st.w_avg.numpy(),
        world["w_avg"] * wb + np.asarray(want["w_mean"]) * (1 - wb),
        rtol=1e-5, atol=1e-6)
    assert (st.step, st.shown_imgs) == (1, A * B)


def test_accum_d_gradients(stepped):
    assert_grads(stepped["st"].d, stepped["d_grads"], "D")


def test_accum_g_gradients(stepped):
    assert_grads(stepped["st"].g, stepped["g_grads"], "G")


def test_pl_decay_is_chained_per_microbatch(world):
    """Two microbatches with the decay 1 - (1 - d)^(1/2) each move
    ``pl_mean`` as one step of decay d would with both means equal."""
    d = world["cfg"].loss.pl_decay
    dm = 1.0 - (1.0 - d) ** 0.5
    m0, x = 0.3, 1.7
    chained = m0 + dm * (x - m0)
    chained = chained + dm * (x - chained)
    assert chained == pytest.approx(m0 + d * (x - m0), rel=1e-12)


FAMILIES = {
    "stylegan-256": {"model.fmap_base": 64, "model.fmap_max": 8},
    "stylegan-1024": {"model.fmap_base": 64, "model.fmap_max": 8},
    "stylegan2-256": {"model.fmap_base": 64, "model.fmap_max": 8,
                      "loss.pl_every": 1},
    "progan-128": {"model.fmap_base": 64, "model.fmap_max": 8},
    "progan-64": {"model.fmap_base": 64, "model.fmap_max": 8},
    "resnetgan-cifar10": {"model.base_channels": 8,
                          "loss.d_steps_per_g": 2},
}


@pytest.mark.parametrize("preset", list(FAMILIES))
def test_every_family_trains_with_accumulation(preset):
    over = dict(FAMILIES[preset], **{
        "model.resolution": 16, "model.latent_dim": 8,
        "run.compute_dtype": "float32", "schedule.progressive": False,
        "schedule.batch_schedule": {16: 2}, "optim.grad_accum": 2})
    if preset != "resnetgan-cifar10":
        over["model.mapping_layers"] = 1
    cfg = get_config(preset, **over)
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    st = create_train_state(cfg, seed=0, device="cpu")
    stepper = tsteps.make_lazy_stepper(cfg, phase)
    rs = np.random.RandomState(0)
    g0 = {k: v.clone() for k, v in st.g.state_dict().items()}
    for i in range(2):
        real = torch.from_numpy(rs.randint(0, 256, (4, 16, 16, 3))
                                .astype(np.uint8))
        st, m = stepper(st, real)
        assert all(np.isfinite(float(v)) for v in m.values()), (i, m)
        moved = any(not torch.equal(v, g0[k])
                    for k, v in st.g.state_dict().items())
        # n-critic: G changes on the second step only
        assert moved == (i == 1 or cfg.loss.d_steps_per_g == 1), i
    assert (st.step, st.shown_imgs) == (2, 8)


def test_accumulation_refuses_what_it_cannot_split(world):
    step = tsteps.build_train_step(world["cfg"], world["phase"])
    st = _port_state(world)
    real = torch.from_numpy(world["real"])
    with pytest.raises(ValueError, match="equal microbatches"):
        step(st, real[:7])
    with pytest.raises(ValueError, match="2 StepDraws"):
        step(st, real, [_port_draws(world["micro"][0])])
    bad = get_config("stylegan2-256", **dict(SMALL,
                                             **{"loss.fused_g_step": True}))
    with pytest.raises(ValueError, match="sequential recipe"):
        tsteps.build_train_step(bad, world["phase"])

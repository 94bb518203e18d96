"""The port's ResNet-GAN (``models/resnetgan.py``) and n-critic training vs
the JAX package at a small config (32x32, base_channels 8, latent 16,
float32, JAX matmuls at ``highest``).

* G and D: one perturbed flax tree each, converted with ``from_flax``:
  images and scores within 1e-5, the input gradient of D and the
  parameter gradients of both within 1e-4 of each leaf's scale;
* the residual blocks with a 1x1 skip conv (input and output widths
  differ: ``up{i}.skip`` / ``down{i}.skip``, which the preset's one width
  never builds), held against the JAX blocks alone;
* ``loss.d_steps_per_g=2`` over two steps, leaf by leaf against a harness
  of JAX pieces (``test_torch_progan_g._jax_step``): step 0 updates D only
  (``g_loss`` 0, G, G-EMA and G's Adam untouched), step 1 updates D and G
  against the updated D, G's Adam count then 1, as optax's; the state
  in the JAX layout loads back with D's count as the step's origin;
* ``build_models`` for the three presets of this family and ProGAN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models import resnetgan as jax_resnet
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax, load_jax_train_state
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.models import resnetgan
from ganlab_tpu_torch.models.progan import ProDiscriminator, ProGenerator
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_progan_g import _jax_step, _nchw, _nhwc, assert_grads
from tests.test_torch_train_step import perturb, to_flax

torch.set_num_threads(1)

SMALL = {"model.base_channels": 8, "model.latent_dim": 16,
         "run.compute_dtype": "float32",
         "schedule.batch_schedule": {32: 4}}
B, REL = 4, 1e-4


def _tree(module, seed, *args):
    return perturb(jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(seed), *args)), seed + 1)


@pytest.fixture(scope="module")
def nets():
    jcfg = jax_get_config("resnetgan-cifar10", **SMALL)
    jg, jd = jax_build_models(jcfg.model)
    pg = _tree(jg, 0, jnp.zeros((1, 16)))
    pd = _tree(jd, 2, jnp.zeros((2, 32, 32, 3)))
    g, d = build_models(get_config("resnetgan-cifar10", **SMALL).model)
    g.load_state_dict(from_flax(pg))
    d.load_state_dict(from_flax(pd))
    return jg, jd, pg, pd, g, d


def _assert_param_grads(module, want_tree):
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    for name, p in module.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=REL * max(float(np.abs(ref).max()), 1e-12), err_msg=name)


def test_generator_matches_jax(nets):
    jg, _, pg, _, g, _ = nets
    assert isinstance(g, resnetgan.ResNetGenerator)
    assert set(from_flax(pg)) == set(g.state_dict())
    assert {"dense.w", "up0.conv0.w", "up2.conv1.b", "torgb.w"} <= \
        set(g.state_dict())
    rs = np.random.RandomState(3)
    z = rs.randn(3, 16).astype(np.float32)
    ct = rs.randn(3, 32, 32, 3).astype(np.float32)
    want = jg.apply(pg, jnp.asarray(z))
    got = g(torch.from_numpy(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    (got * _nchw(ct)).sum().backward()
    _assert_param_grads(g, jax.grad(
        lambda p: jnp.sum(jg.apply(p, jnp.asarray(z)) * ct))(pg))


def test_discriminator_matches_jax(nets):
    _, jd, _, pd, _, d = nets
    assert isinstance(d, resnetgan.ResNetDiscriminator)
    assert set(from_flax(pd)) == set(d.state_dict())
    assert {"fromrgb.w", "down2.conv1.w", "final.conv0.w", "final.conv1.b",
            "score.w"} <= set(d.state_dict())
    img = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
    want = jd.apply(pd, jnp.asarray(img))
    want_x = jax.grad(lambda x: jnp.sum(jd.apply(pd, x)))(jnp.asarray(img))
    x = _nchw(img).requires_grad_(True)
    got = d(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.sum().backward()
    scale = float(np.abs(want_x).max())
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(want_x), rtol=0,
                               atol=REL * scale)
    _assert_param_grads(d, jax.grad(
        lambda p: jnp.sum(jd.apply(p, jnp.asarray(img))))(pd))


@pytest.mark.parametrize("kind", ["up", "down", "down_nodown"])
def test_blocks_with_a_skip_conv(kind):
    """Widths 6 -> 10: the 1x1 skip conv (no bias, gain 1) exists and
    converts (HWIO -> OIHW) like every conv."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, 8, 6).astype(np.float32)
    if kind == "up":
        jb, tb = jax_resnet.ResUpBlock(10), resnetgan.ResUpBlock(6, 10)
    else:
        down = kind == "down"
        jb = jax_resnet.ResDownBlock(10, downsample=down)
        tb = resnetgan.ResDownBlock(6, 10, downsample=down)
    params = _tree(jb, 6, jnp.asarray(x))
    assert "skip" in params["params"] and "b" not in params["params"]["skip"]
    tb.load_state_dict(from_flax(params))
    assert tuple(tb.skip.w.shape) == (10, 6, 1, 1) and tb.skip.b is None
    np.testing.assert_allclose(_nhwc(tb(_nchw(x))),
                               np.asarray(jb.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_n_critic_two_steps_match_jax():
    over = dict(SMALL, **{"loss.d_steps_per_g": 2})
    jcfg = jax_get_config("resnetgan-cifar10", **over)
    cfg = get_config("resnetgan-cifar10", **over)
    assert (cfg.loss.penalty, cfg.optim.beta2, cfg.optim.ema_beta) == \
        ("wgan-gp", 0.9, 0.999)
    jg, jd = jax_build_models(jcfg.model)
    pg = _tree(jg, 0, jnp.zeros((1, 16)))
    pd = _tree(jd, 2, jnp.zeros((2, 32, 32, 3)))
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st = create_train_state(cfg, seed=0, device="cpu")
    st.g.load_state_dict(from_flax(pg))
    st.d.load_state_dict(from_flax(pd))
    st.g_ema.load_state_dict(from_flax(perturb(pg, 9, 0.1)))
    step = tsteps.build_train_step(cfg, phase)
    rs = np.random.RandomState(7)
    for i in range(2):
        real = rs.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
        flip = rs.rand(B) < 0.5
        z_d, z_g = (rs.randn(B, 16).astype(np.float32) for _ in range(2))
        gp_key = jax.random.PRNGKey(10 + i)
        gp_eps = np.array(jax.random.uniform(gp_key, (B, 1, 1, 1)))
        d_before, g_before = to_flax(st.d), to_flax(st.g)
        ema_before = to_flax(st.g_ema)
        draws = tsteps.StepDraws(torch.from_numpy(flip),
                                 tsteps.GenDraws(torch.from_numpy(z_d)),
                                 tsteps.GenDraws(torch.from_numpy(z_g)),
                                 torch.from_numpy(gp_eps))
        st, m = step(st, torch.from_numpy(real), draws)
        want, d_grads, g_grads = _jax_step(
            jcfg, 5, None, g_before, d_before, to_flax(st.d), real, flip,
            jnp.asarray(z_d), jnp.asarray(z_g), gp_key)
        for k in ("d_loss", "penalty", "real_score", "fake_score"):
            np.testing.assert_allclose(float(m[k]), float(want[k]),
                                       rtol=REL, atol=1e-6, err_msg=k)
        assert_grads(st.d, d_grads, f"D step {i}")
        g_sd = from_flax(to_flax(st.g))
        if i == 0:                  # a critic-only step
            assert float(m["g_loss"]) == 0.0 and not st.opt_g.state
            for name, t in from_flax(to_flax(st.g_ema)).items():
                assert torch.equal(t, from_flax(ema_before)[name]), name
            for name, t in g_sd.items():
                assert torch.equal(t, from_flax(g_before)[name]), name
        else:                       # D, then G against the updated D
            np.testing.assert_allclose(float(m["g_loss"]),
                                       float(want["g_loss"]), rtol=REL)
            assert_grads(st.g, g_grads, "G step 1")
            assert {float(s["step"]) for s in st.opt_g.state.values()} \
                == {1.0}
            want_ema = from_flax(jax.tree_util.tree_map(
                np.asarray, jax_steps._ema_update(
                    ema_before, to_flax(st.g), jcfg.optim.ema_beta_for(B))))
            for name, t in st.g_ema.state_dict().items():
                ref = want_ema[name].numpy()
                np.testing.assert_allclose(
                    t.numpy(), ref, rtol=0,
                    atol=1e-6 * float(np.abs(ref).max()), err_msg=name)
    assert {float(s["step"]) for s in st.opt_d.state.values()} == {2.0}
    assert (st.step, st.shown_imgs) == (2, 2 * B) and not st.w_avg.any()

    # the same state in the JAX package's layout (optax: one count a tree,
    # G's counting its updates only) loads back with D's count as the
    # origin of the step counter
    def moments(opt, module, key):
        named = dict(module.named_parameters())
        tree = {n: opt.state[p][key] for n, p in named.items()}
        return {"params": _nest(tree)}

    arrays = {"params_g": to_flax(st.g), "params_d": to_flax(st.d),
              "params_ema": to_flax(st.g_ema), "w_avg": st.w_avg.numpy(),
              "step": 2, "shown_imgs": 2 * B}
    for net, count in (("g", 1), ("d", 2)):
        opt, module = getattr(st, f"opt_{net}"), getattr(st, net)
        arrays[f"opt_{net}"] = {"count": count,
                                "mu": moments(opt, module, "exp_avg"),
                                "nu": moments(opt, module, "exp_avg_sq")}
    st2 = load_jax_train_state(create_train_state(cfg, seed=5, device="cpu"),
                               arrays, cfg)
    assert (st2.step, st2.opt_step0) == (2, 0)
    assert {float(s["step"]) for s in st2.opt_g.state.values()} == {1.0}
    assert {float(s["step"]) for s in st2.opt_d.state.values()} == {2.0}


def _nest(flat: dict) -> dict:
    """{"a.b.w": t} -> {"a": {"b": {"w": array}}}, 4-d weights to HWIO."""
    tree: dict = {}
    for name, t in flat.items():
        a = t.detach().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def test_build_models_families():
    for preset, g_cls, d_cls in (
            ("resnetgan-cifar10", resnetgan.ResNetGenerator,
             resnetgan.ResNetDiscriminator),
            ("progan-64", ProGenerator, ProDiscriminator),
            ("progan-128", ProGenerator, ProDiscriminator)):
        cfg = get_config(preset, **{"model.fmap_base": 64,
                                    "model.base_channels": 8})
        g, d = build_models(cfg.model)
        assert isinstance(g, g_cls) and isinstance(d, d_cls), preset
        if d_cls is ProDiscriminator:      # ProGAN's D pools, no blur
            assert not d.block8.blur
    # StyleGAN2 (ROADMAP.md A.5): its G with the residual blur + down D
    g, d = build_models(get_config("stylegan2-256", **{
        "model.fmap_base": 64}).model)
    assert isinstance(d, ProDiscriminator) and hasattr(g, "map_latents")
    assert d.block8.blur and d.block8.resnet

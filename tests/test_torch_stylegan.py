"""The port's StyleGAN generator vs the JAX package at a small config.

One JAX ``StyleGenerator.init_all`` tree, with every leaf perturbed by
seeded numpy noise (at init the noise scales and biases are 0, so an
unperturbed tree would hide those terms), is converted with
``from_flax`` and both generators get the same latents, ws and explicit
noise maps. Tolerance 1e-4 in float32 (same math, other summation order,
through ~10 normalized layers); in bf16 the port may stray from the
float32 image at most twice as far as the JAX package's bf16 image does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models
from ganlab_tpu.train.steps import build_sample_fn as jax_build_sample_fn
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_generator
from ganlab_tpu_torch.models.stylegan import (
    mix_styles,
    noise_shapes,
    num_style_layers,
    truncate_ws,
)
from ganlab_tpu_torch.sample import build_sample_fn

SMALL = {"model.resolution": 32, "model.fmap_base": 256,
         "model.fmap_max": 32, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}
N = 3


def perturb(tree, seed=0, zero_noise=False):
    rs = np.random.RandomState(seed)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        if zero_noise and "noise" in jax.tree_util.keystr(path):
            return np.zeros_like(a)
        return (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("stylegan-256", **SMALL)
    jg, _ = build_models(jcfg.model)
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(0))))
    tg = build_generator(get_config("stylegan-256", **SMALL).model)
    tg.load_state_dict(from_flax(params))
    return jcfg, jg, params, tg.eval().requires_grad_(False)


def noises_for(lg, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(N, h, w, 1).astype(np.float32)
            for h, w in noise_shapes(lg)]


def test_from_flax_covers_every_parameter(pair):
    _, _, params, tg = pair
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(tg.state_dict()) == len(from_flax(params))
    assert "synthesis.torgb32.w" in tg.state_dict()


def test_map_latents(pair):
    _, jg, params, tg = pair
    z = np.random.RandomState(1).randn(N, 16).astype(np.float32)
    want = jg.apply(params, jnp.asarray(z), method="map_latents")
    got = tg.map_latents(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lg,alpha", [(5, 1.0), (4, 0.4)])
def test_synthesize_explicit_noise(pair, lg, alpha):
    _, jg, params, tg = pair
    ws = np.random.RandomState(2).randn(
        N, num_style_layers(lg), 16).astype(np.float32)
    nz = noises_for(lg, 3)
    want = jg.apply(params, jnp.asarray(ws), lg, alpha,
                    [jnp.asarray(a) for a in nz], method="synthesize")
    got = tg.synthesize(torch.from_numpy(ws), lg, alpha,
                        [torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                         for a in nz])
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_synthesize_bf16(pair):
    """bf16 rounds at other places in the two frameworks, so the port's
    bf16 image is held to the float32 reference no worse than twice the
    JAX package's own bf16 image is."""
    _, jg, params, tg = pair
    ws = np.random.RandomState(4).randn(N, 8, 16).astype(np.float32)
    nz = noises_for(5, 5)

    def jax_run(dt):
        out = jg.apply(params, jnp.asarray(ws, dt), 5, 1.0,
                       [jnp.asarray(a, dt) for a in nz],
                       method="synthesize")
        return np.asarray(out.astype(jnp.float32))

    want, jax_bf16 = jax_run(jnp.float32), jax_run(jnp.bfloat16)
    got = tg.synthesize(torch.from_numpy(ws).bfloat16(), 5, 1.0,
                        [torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                         .bfloat16() for a in nz])
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    for stat in (np.max, np.mean):
        err_port = float(stat(np.abs(got - want)))
        err_jax = float(stat(np.abs(jax_bf16 - want)))
        assert err_port <= 2 * err_jax, (stat.__name__, err_port, err_jax)


@pytest.mark.parametrize("cutoff", [8, 4])
def test_sample_fn_truncated(cutoff):
    over = dict(SMALL, **{"model.truncation_cutoff": cutoff})
    jcfg = jax_get_config("stylegan-256", **over)
    jg, _ = build_models(jcfg.model)
    # zero noise scales: the two RNG streams then do not matter
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(0))), seed=6,
        zero_noise=True)
    rs = np.random.RandomState(7)
    z = rs.randn(N, 16).astype(np.float32)
    w_avg = rs.randn(16).astype(np.float32)
    want = jax_build_sample_fn(jcfg, 5)(
        params, jnp.asarray(w_avg), jnp.asarray(z), jax.random.PRNGKey(1),
        0.7, 1.0)
    cfg = get_config("stylegan-256", **over)
    tg = build_generator(cfg.model)
    tg.load_state_dict(from_flax(params))
    with torch.inference_mode():
        got = build_sample_fn(cfg, 5)(tg, torch.from_numpy(w_avg),
                                      torch.from_numpy(z), None, 0.7, 1.0)
    assert got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_generator_call_with_mixing():
    """StyleGenerator.__call__ with z2 / crossover (noise scales 0)."""
    jcfg = jax_get_config("stylegan-256", **SMALL)
    jg, _ = build_models(jcfg.model)
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(0))), seed=9,
        zero_noise=True)
    rs = np.random.RandomState(10)
    z1, z2 = (rs.randn(N, 16).astype(np.float32) for _ in range(2))
    cross = np.array([0, 3, 8], np.int32)
    want = jg.apply(params, jnp.asarray(z1), 5, 1.0, jnp.asarray(z2),
                    jnp.asarray(cross), rngs={"noise": jax.random.PRNGKey(2)})
    tg = build_generator(get_config("stylegan-256", **SMALL).model)
    tg.load_state_dict(from_flax(params))
    with torch.inference_mode():
        got = tg(torch.from_numpy(z1), 5, 1.0, torch.from_numpy(z2),
                 torch.from_numpy(cross))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_truncate_and_mix_styles():
    from ganlab_tpu.models.stylegan import mix_styles as jmix
    from ganlab_tpu.models.stylegan import truncate_ws as jtrunc

    rs = np.random.RandomState(8)
    ws = rs.randn(2, 6, 4).astype(np.float32)
    w_avg = rs.randn(4).astype(np.float32)
    np.testing.assert_allclose(
        truncate_ws(torch.from_numpy(ws), torch.from_numpy(w_avg), 0.5,
                    3).numpy(),
        np.asarray(jtrunc(jnp.asarray(ws), jnp.asarray(w_avg), 0.5, 3)),
        rtol=1e-6, atol=1e-6)
    w1, w2 = rs.randn(2, 4).astype(np.float32), rs.randn(2, 4).astype(
        np.float32)
    cross = np.array([1, 4], np.int32)
    np.testing.assert_array_equal(
        mix_styles(torch.from_numpy(w1), torch.from_numpy(w2),
                   torch.from_numpy(cross), 6).numpy(),
        np.asarray(jmix(jnp.asarray(w1), jnp.asarray(w2),
                        jnp.asarray(cross), 6)))


def test_tpu_only_knobs_are_rejected():
    """remat, fused_up_conv and fold_width are ported
    (tests/test_torch_remat.py, tests/test_torch_up2conv.py,
    tests/test_torch_folded.py): under fold_width every block of this
    narrow G folds, and from the same noise its images are the unfolded
    G's."""
    for knob in ("model.remat", "model.fused_up_conv"):
        build_generator(get_config("stylegan-256",
                                   **dict(SMALL, **{knob: True})).model)
    torch.manual_seed(0)
    g = build_generator(get_config("stylegan-256", **dict(
        SMALL, **{"model.fold_width": True})).model)
    torch.manual_seed(0)
    ref = build_generator(get_config("stylegan-256", **SMALL).model)
    assert all(getattr(g.synthesis, f"block{2 ** lg}").fold
               for lg in (3, 4, 5))
    with torch.no_grad():
        for net in (g, ref):                 # live noise scales and biases
            for k, v in net.state_dict().items():
                if k.endswith(("noise.scale", ".bias")):
                    v += 0.3
    z = torch.from_numpy(np.random.RandomState(5).randn(N, 16).astype(
        np.float32))
    with torch.no_grad():
        got = g(z, generator=torch.Generator().manual_seed(1))
        want = ref(z, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)

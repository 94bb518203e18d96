"""The port's ProGAN discriminator vs the JAX package at a small config.

One JAX ``ProDiscriminator(blur_resample=True).init_all`` tree, every leaf
perturbed by seeded numpy noise (biases start at 0), is converted with
``from_flax``; both discriminators score the same images and give the
gradient of the summed score with respect to them. Tolerance 1e-4 in
float32 under ``highest`` matmul precision (same math, other summation
order, through ~8 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.models.progan import ProDiscriminator

SMALL = {"model.resolution": 32, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}
N = 4


def perturb(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.3 * rs.randn(*np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("stylegan-256", **SMALL)
    _, jd = jax_build_models(jcfg.model)
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jd.init_all(jax.random.PRNGKey(0))), seed=1)
    _, td = build_models(get_config("stylegan-256", **SMALL).model)
    td.load_state_dict(from_flax(params))
    return jd, params, td


def test_from_flax_covers_every_d_parameter(pair):
    _, params, td = pair
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(td.state_dict()) == len(from_flax(params))
    for name in ("fromrgb32.w", "block32.conv0.w", "block8.conv1.b",
                 "block4_out.conv.w", "block4_out.dense.w",
                 "block4_out.score.b"):
        assert name in td.state_dict(), name


@pytest.mark.parametrize("lg,alpha", [(5, 1.0), (5, 0.4), (4, 1.0)])
def test_d_forward_and_input_grad(pair, lg, alpha):
    jd, params, td = pair
    img = np.random.RandomState(2).randn(N, 2 ** lg, 2 ** lg, 3) \
        .astype(np.float32)

    def score_sum(x):
        return jnp.sum(jd.apply(params, x, lg, alpha))

    want = jd.apply(params, jnp.asarray(img), lg, alpha)
    want_g = jax.grad(score_sum)(jnp.asarray(img))
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = td(x, lg, alpha)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    scale = float(np.abs(want_g).max())
    np.testing.assert_allclose(got_g.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_g), rtol=0,
                               atol=1e-4 * scale)


def test_unported_d_knobs_are_rejected():
    """model.remat is ported (tests/test_torch_remat.py)."""
    assert ProDiscriminator(get_config(
        "stylegan-256", **dict(SMALL, **{"model.remat": True})).model).remat
    for knob in ("model.fold_width", "model.d_resnet"):
        with pytest.raises(NotImplementedError):
            ProDiscriminator(get_config(
                "stylegan-256", **dict(SMALL, **{knob: True})).model)


def test_build_models_stylegan_only():
    g, d = build_models(get_config("stylegan-256", **SMALL).model)
    assert isinstance(d, ProDiscriminator) and hasattr(g, "map_latents")
    with pytest.raises(NotImplementedError):
        build_models(get_config("progan-64").model)

"""The port's losses and penalties vs ``ganlab_tpu/ops/losses.py``.

Scores and images are seeded numpy arrays given to both packages. The
penalties use a small nonlinear critic written twice (JAX and torch) with
the same weights; WGAN-GP's interpolation weights are drawn by JAX and
injected. Values agree within 1e-5 relative in float32; the penalties'
gradients with respect to the critic weights (the double backward)
within 1e-5 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.ops import losses as JL
from ganlab_tpu_torch.ops import losses as TL

RS = np.random.RandomState(0)
REAL = RS.randn(8).astype(np.float32)
FAKE = RS.randn(8).astype(np.float32)
W = (0.5 * RS.randn(3 * 4 * 4, 6)).astype(np.float32)
V = RS.randn(6).astype(np.float32)
IMG_R = RS.randn(5, 4, 4, 3).astype(np.float32)     # NHWC
IMG_F = RS.randn(5, 4, 4, 3).astype(np.float32)


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("name", ["wgan", "wgan-gp", "nonsaturating",
                                  "minimax"])
def test_losses(name):
    r, f = torch.from_numpy(REAL), torch.from_numpy(FAKE)
    close(TL.D_LOSSES[name](r, f),
          JL.D_LOSSES[name](jnp.asarray(REAL), jnp.asarray(FAKE)))
    close(TL.G_LOSSES[name](f), JL.G_LOSSES[name](jnp.asarray(FAKE)))


def test_drift_penalty():
    close(TL.drift_penalty(torch.from_numpy(REAL), 1e-3),
          JL.drift_penalty(jnp.asarray(REAL), 1e-3))


def jax_critic(w, v):
    def critic(x):                                   # NHWC
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ w)
        h = h * jnp.mean(h * h)                      # cross-example term
        return h @ v
    return critic


def torch_critic(w, v):
    def critic(x):                                   # NCHW
        h = torch.tanh(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ w)
        h = h * (h * h).mean()
        return h @ v
    return critic


def nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("penalty", ["r1", "wgan-gp"])
def test_penalties_and_their_weight_grads(penalty):
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.uniform(key, (5, 1, 1, 1)))

    def jax_pen(w, v):
        c = jax_critic(w, v)
        if penalty == "r1":
            return JL.r1_penalty(c, jnp.asarray(IMG_R), 10.0)
        return JL.wgan_gp(c, jnp.asarray(IMG_R), jnp.asarray(IMG_F), key,
                          10.0)

    want, want_g = jax.value_and_grad(jax_pen, argnums=(0, 1))(
        jnp.asarray(W), jnp.asarray(V))
    w, v = (torch.from_numpy(a.copy()).requires_grad_() for a in (W, V))
    c = torch_critic(w, v)
    if penalty == "r1":
        got = TL.r1_penalty(c, nchw(IMG_R), 10.0)
    else:
        got = TL.wgan_gp(c, nchw(IMG_R), nchw(IMG_F), None, 10.0,
                         eps=torch.from_numpy(eps.copy()))
    got_g = torch.autograd.grad(got, (w, v))
    close(got, want)
    for a, b in zip(got_g, want_g):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


def test_wgan_gp_draws_from_the_generator():
    c = torch_critic(torch.from_numpy(W), torch.from_numpy(V))
    vals = [TL.wgan_gp(c, nchw(IMG_R), nchw(IMG_F),
                       torch.Generator().manual_seed(s), 10.0).item()
            for s in (0, 0, 1)]
    assert vals[0] == vals[1] != vals[2]

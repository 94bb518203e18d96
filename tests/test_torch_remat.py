"""``model.remat`` in the port vs the JAX package's ``nn.remat`` models.

The JAX package wraps each ``SynthesisBlock`` and each ``DBlock`` in
``nn.remat`` when ``model.remat`` is set (the ``stylegan-1024`` preset
does); the port wraps the same blocks in ``torch.utils.checkpoint``.
Values and gradients must not change:

* a tiny StyleGAN G and ProGAN D with ``remat=True`` on both sides, from
  one perturbed flax tree (``from_flax``), same ws, noise maps and images:
  outputs and every gradient leaf within 1e-5 of the largest magnitude
  (float32, JAX matmuls at ``highest``, other summation orders);
* the port with remat against the port without it: one R1-on training
  step from one state and one set of draws, and a G forward whose noise
  the model draws from a ``torch.Generator``, give bit-equal losses and
  gradients (a recompute that drew the noise anew would not);
* ``gradgradcheck`` in float64 through one checkpointed D block and one
  checkpointed synthesis block (R1 takes the second derivative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.models.progan import DBlock
from ganlab_tpu_torch.models.stylegan import (
    SynthesisBlock,
    noise_shapes,
    num_style_layers,
)
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

SMALL = {"model.resolution": 32, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32",
         "model.remat": True}
N, LG = 3, 5
RTOL = 1e-5                     # of the largest magnitude, per leaf


def perturb(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.3 * rs.randn(*np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config("stylegan-256", **SMALL)
    assert jcfg.model.remat
    jg, jd = jax_build_models(jcfg.model)
    pg = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(0))), seed=1)
    pd = perturb(jax.tree_util.tree_map(
        np.asarray, jd.init_all(jax.random.PRNGKey(1))), seed=2)
    tg, td = build_models(get_config("stylegan-256", **SMALL).model)
    assert tg.synthesis.remat and td.remat
    tg.load_state_dict(from_flax(pg))
    td.load_state_dict(from_flax(pd))
    return jg, jd, pg, pd, tg, td


def _close(got: torch.Tensor, want, nhwc: bool = False):
    want = np.asarray(want)
    got = got.detach().numpy()
    if nhwc:
        got = got.transpose(0, 2, 3, 1)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _grads_close(module, jax_grads):
    want = from_flax(jax.tree_util.tree_map(np.asarray, jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        if g is None:               # a leaf the call does not reach
            assert not want[k].any(), k
        else:
            _close(g, want[k].numpy())


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_remat_generator_matches_jax(pair, alpha):
    jg, _, pg, _, tg, _ = pair
    rs = np.random.RandomState(3)
    ws = rs.randn(N, num_style_layers(LG), 16).astype(np.float32)
    nz = [rs.randn(N, h, w, 1).astype(np.float32)
          for h, w in noise_shapes(LG)]
    ct = rs.randn(N, 2 ** LG, 2 ** LG, 3).astype(np.float32)

    def loss(p, w):
        img = jg.apply(p, w, LG, alpha, [jnp.asarray(a) for a in nz],
                       method="synthesize")
        return jnp.sum(img * ct), img

    (_, want), (gp, gw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(pg, jnp.asarray(ws))
    tg.zero_grad()
    w = torch.from_numpy(ws).requires_grad_()
    img = tg.synthesize(w, LG, alpha, [
        torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in nz])
    (img * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum() \
        .backward()
    _close(img, want, nhwc=True)
    _close(w.grad, gw)
    _grads_close(tg, gp)


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_remat_discriminator_matches_jax(pair, alpha):
    _, jd, _, pd, _, td = pair
    img = np.random.RandomState(4).randn(N, 2 ** LG, 2 ** LG, 3) \
        .astype(np.float32)

    def loss(p, x):
        s = jd.apply(p, x, LG, alpha)
        return jnp.sum(s * jnp.arange(1.0, N + 1)), s

    (_, want), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(pd, jnp.asarray(img))
    td.zero_grad()
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy()).requires_grad_()
    score = td(x, LG, alpha)
    (score * torch.arange(1.0, N + 1)).sum().backward()
    _close(score, want)
    _close(x.grad, gx, nhwc=True)
    _grads_close(td, gp)


def _step_grads(remat: bool, r1: bool):
    cfg = get_config("stylegan-256", **dict(
        SMALL, **{"model.remat": remat, "schedule.progressive": False,
                  "schedule.batch_schedule": {32: 4}}))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=5, device="cpu")
    with torch.no_grad():                   # every term live
        gen = torch.Generator().manual_seed(6)
        for net in (state.g, state.d):
            for k, v in net.state_dict().items():
                if k.endswith(("noise.scale", ".bias", ".b", "const")):
                    v += 0.2 * torch.randn(v.shape, generator=gen)
    draws = tsteps.draw_step(cfg, phase.res_log2, 4,
                             torch.Generator().manual_seed(7), "cpu")
    real = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(8))
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    state, metrics = step(state, real, draws)
    grads = {f"{net}.{k}": p.grad.clone() for net in ("g", "d")
             for k, p in getattr(state, net).named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("r1", [True, False], ids=["r1_on", "r1_off"])
def test_remat_train_step_bit_equal_to_no_remat(r1):
    m_remat, g_remat = _step_grads(True, r1)
    m_plain, g_plain = _step_grads(False, r1)
    assert (m_remat["penalty"] > 0) == r1
    assert m_remat == m_plain
    assert set(g_remat) == set(g_plain) and len(g_plain) > 20
    for k, g in g_plain.items():
        assert torch.equal(g_remat[k], g), k


def test_remat_generator_draws_the_forwards_noise():
    """Noise drawn by the model from a generator: a recompute must see the
    forward's maps, and the generator must advance as without remat."""
    grads, states = {}, {}
    for remat in (True, False):
        torch.manual_seed(0)
        tg, _ = build_models(get_config(
            "stylegan-256", **dict(SMALL, **{"model.remat": remat})).model)
        with torch.no_grad():
            for k, v in tg.state_dict().items():
                if k.endswith("noise.scale"):
                    v.fill_(0.7)
        gen = torch.Generator().manual_seed(9)
        z = torch.randn(N, 16, generator=torch.Generator().manual_seed(1))
        img = tg(z, LG, 1.0, generator=gen)
        img.square().sum().backward()
        grads[remat] = {k: p.grad for k, p in tg.named_parameters()
                        if p.grad is not None}
        states[remat] = gen.get_state()
    assert torch.equal(states[True], states[False])
    assert set(grads[True]) == set(grads[False])
    for k, g in grads[False].items():
        assert torch.equal(grads[True][k], g), k


def test_gradgradcheck_through_checkpointed_blocks():
    torch.manual_seed(0)
    dblock = DBlock(2, 2, 3, blur=True).double()
    x = torch.randn(2, 2, 8, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(
        lambda t: checkpoint(dblock, t, use_reentrant=False), (x,))

    sblock = SynthesisBlock(2, 2, 4).double()
    with torch.no_grad():
        for p in sblock.parameters():
            p.add_(0.3 * torch.randn_like(p))
    xs = torch.randn(2, 2, 4, 4, dtype=torch.float64, requires_grad=True)
    wa = torch.randn(2, 4, dtype=torch.float64, requires_grad=True)
    wb = torch.randn(2, 4, dtype=torch.float64)
    na, nb = (torch.randn(2, 1, 8, 8, dtype=torch.float64) for _ in range(2))
    assert torch.autograd.gradgradcheck(
        lambda t, a: checkpoint(sblock, t, a, wb, na, nb,
                                use_reentrant=False), (xs, wa))

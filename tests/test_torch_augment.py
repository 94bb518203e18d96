"""The port's ADA augmentation (``ganlab_tpu_torch/ops/augment.py``) and its
training-step wiring against the JAX package.

Mirrors ``tests/test_augment.py`` case by case on NCHW images, and adds:

* parity: the JAX ``sample_params`` output (through
  ``convert.aug_params_from_arrays``) fed to both ``apply_augment``s, each
  category alone and ``bcgfnu``, at 8x8 (the filter's reflect padding
  reflects more than once there), 16x16 and 32x32, float32: values within
  1e-5 of the image scale, the VJP with respect to x within 1e-5 of its
  scale;
* the port's own draws: the categories respected, each gate firing at rate
  p over a batch of 4096 (4 sigma), the generator's stream the same for
  every p, and p = 0 the identity bit for bit;
* the gathers' backward the same bits on every call;
* one R1-on and one R1-off training step of a small StyleGAN with
  ``aug.mode=ada`` and all six categories, against a harness assembled from
  the JAX pieces on the same injected draws: losses, scores, every gradient
  leaf (1e-4 of its scale, as ``tests/test_torch_train_step.py``), ``aug_rt``
  and the updated ``ada_p``;
* p rising and clipping at the documented rate, ``fixed`` keeping no state,
  ``ada_p`` in checkpoints (round trip, migration both ways) and in
  ``load_jax_train_state``, bitwise resume with ADA, ``cli train --set
  aug.mode=ada`` logging ``aug_p`` / ``aug_rt``.

The JAX side runs at ``highest`` matmul precision (``tests/conftest.py``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.ops import augment as JA
from ganlab_tpu.ops import losses as JL
from ganlab_tpu.train import steps as jax_steps
from ganlab_tpu.train.state import create_train_state as jax_create_state
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import (
    aug_params_from_arrays,
    load_jax_train_state,
)
from ganlab_tpu_torch.ops import augment as TA
from ganlab_tpu_torch.ops.augment import (
    AugParams,
    apply_augment,
    sample_params,
)
from ganlab_tpu_torch.train import (
    CheckpointManager,
    build_phases,
    create_train_state,
    make_lazy_stepper,
    state_tensors,
)
from ganlab_tpu_torch.train import steps as tsteps
from tests.test_torch_train_step import (
    SMALL,
    assert_grads,
    make_world,
    port_state,
    to_flax,
    to_port_draws,
)

torch.set_num_threads(1)

TOL = 1e-5
CATEGORIES = ["b", "c", "g", "f", "n", "u", "bcgfnu"]
FIELDS = [f.name for f in dataclasses.fields(AugParams)]


def _imgs(b=4, res=16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (b, 3, res, res))
                            .astype(np.float32))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def augment(x, p, gen, categories="bc"):
    """Transforms drawn from ``gen`` at strength ``p``, applied to ``x``."""
    return apply_augment(x, sample_params(gen, x.shape[0], x.shape[2], p,
                                          categories, channels=x.shape[1]))


def _identity(b, **over):
    p = AugParams(flip=torch.zeros(b, dtype=torch.bool),
                  rot_k=torch.zeros(b, dtype=torch.int64),
                  trans=torch.zeros(b, 2, dtype=torch.int64),
                  color_mat=torch.eye(3).expand(b, 3, 3).clone(),
                  color_bias=torch.zeros(b, 3))
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _geom(b, rows):
    return torch.tensor(rows, dtype=torch.float32).expand(b, 2, 3).clone()


_EYE23 = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("res", [8, 16, 32])
@pytest.mark.parametrize("cats", CATEGORIES)
def test_apply_augment_matches_jax(cats, res):
    """The same drawn transforms through both packages, values and VJP."""
    x = np.random.default_rng(res).uniform(
        -1, 1, (6, res, res, 3)).astype(np.float32)
    cot = np.random.default_rng(res + 1).normal(
        size=x.shape).astype(np.float32)
    jp = JA.sample_params(jax.random.PRNGKey(3), 6, res, 0.7, cats)
    y_j, vjp = jax.vjp(lambda t: JA.apply_augment(t, jp), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(cot))
    params = aug_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, jp._asdict()))
    xt = _nchw(x).requires_grad_(True)
    y = apply_augment(xt, params)
    (y * _nchw(cot)).sum().backward()
    for got, want, what in ((_nhwc(y), np.asarray(y_j), "value"),
                            (_nhwc(xt.grad), np.asarray(g_j), "vjp")):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                   err_msg=f"{cats} {res} {what}")


def test_aug_params_from_arrays_layouts():
    jp = JA.sample_params(jax.random.PRNGKey(0), 3, 8, 1.0, "bcgfnu")
    p = aug_params_from_arrays(jax.tree_util.tree_map(np.asarray,
                                                      jp._asdict()))
    assert p.rot_k.dtype == p.trans.dtype == torch.int64
    assert p.flip.dtype == p.filt_active.dtype == torch.bool
    assert p.noise.shape == (3, 3, 8, 8) and p.filt.shape == (3, 43)
    np.testing.assert_array_equal(_nhwc(p.noise), np.asarray(jp.noise))
    none = aug_params_from_arrays(jax.tree_util.tree_map(
        np.asarray, JA.sample_params(jax.random.PRNGKey(0), 3, 8, 1.0,
                                     "bc")._asdict()))
    assert none.geom is None and none.noise is None and none.cutout is None


def test_constants_and_filter_bank_match_jax():
    np.testing.assert_array_equal(TA._HZ_FBANK, JA._HZ_FBANK)
    for name in ("BRIGHTNESS_STD", "CONTRAST_STD", "SATURATION_STD",
                 "MAX_TRANSLATE", "SCALE_STD_LOG2", "ANISO_STD_LOG2",
                 "FRAC_TRANSLATE_STD", "IMGFILTER_STD", "NOISE_STD",
                 "CUTOUT_SIZE", "FILTER_TAPS"):
        assert getattr(TA, name) == getattr(JA, name), name


def test_reflect_pad_index_is_numpy_reflect():
    """The filter's padding reflects again where the pad exceeds the
    image (43 taps: every resolution below 22), as np.pad does."""
    for n in (4, 8, 16, 32):
        want = np.pad(np.arange(n), (21, 21), mode="reflect")
        got = TA._reflect_pad_index(n, 21, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


# -- the port's own draws -----------------------------------------------------

@pytest.mark.parametrize("cats", ["bc", "bcgfnu"])
def test_p_zero_is_identity_bitwise(cats):
    for res in (8, 16):
        x = _imgs(res=res)
        assert torch.equal(augment(x, 0.0, _gen(1), cats), x)
        assert torch.equal(augment(x.bfloat16(), 0.0, _gen(1), cats),
                           x.bfloat16())


def test_deterministic_per_generator_seed():
    x = _imgs()
    assert torch.equal(augment(x, 0.8, _gen(7)), augment(x, 0.8, _gen(7)))
    assert not torch.allclose(augment(x, 0.8, _gen(7)),
                              augment(x, 0.8, _gen(8)))


def test_stream_does_not_depend_on_p():
    """Every value and gate is drawn whatever p: the generator ends in the
    same state, and where a gate fires the value is p = 1's."""
    states, params = [], []
    for p in (0.0, 0.3, 1.0, torch.tensor(0.3)):
        g = _gen(5)
        params.append(TA.sample_params(g, 64, 16, p, "bcgfnu"))
        states.append(g.get_state())
    assert all(torch.equal(states[0], s) for s in states[1:])
    at, full = params[1], params[2]
    fired = at.noise.flatten(1).abs().sum(1) > 0
    assert 0 < int(fired.sum()) < 64
    assert torch.equal(at.noise[fired], full.noise[fired])
    for f in FIELDS:
        assert torch.equal(getattr(at, f), getattr(params[3], f)), f


def test_gates_fire_at_rate_p():
    n, p = 4096, 0.3
    tol = 4 * np.sqrt(p * (1 - p) / n)
    at = TA.sample_params(_gen(2), n, 16, p, "bcgfnu")
    full = TA.sample_params(_gen(2), n, 16, 1.0, "bcgfnu")

    def rate(fired_at, fired_full):
        return float((fired_at & fired_full).float().sum()
                     / fired_full.float().sum())

    assert abs(float(at.flip.float().mean()) - p) < tol
    assert abs(rate(at.rot_k != 0, full.rot_k != 0) - p) < 2 * tol
    assert abs(rate(at.trans.abs().sum(1) > 0,
                    full.trans.abs().sum(1) > 0) - p) < 2 * tol
    assert abs(rate(at.noise.flatten(1).abs().sum(1) > 0,
                    full.noise.flatten(1).abs().sum(1) > 0) - p) < tol
    assert abs(float((at.cutout[:, 2] > 0).float().mean()) - p) < tol
    assert abs(float(at.filt_active.float().mean())
               - (1 - (1 - p) ** 4)) < tol
    # color: five gates; geom: four; identity where none fired
    eye = torch.eye(3)
    ident_c = ((at.color_mat - eye).abs().sum((1, 2)) == 0) \
        & (at.color_bias.abs().sum(1) == 0)
    assert abs(float(ident_c.float().mean()) - (1 - p) ** 5) < tol
    eye23 = torch.tensor(_EYE23)
    ident_g = (at.geom - eye23).abs().sum((1, 2)) == 0
    assert abs(float(ident_g.float().mean()) - (1 - p) ** 4) < tol


def test_sampled_params_respect_categories():
    pb = TA.sample_params(_gen(0), 64, 16, 1.0, "b")
    assert pb.flip.any()
    assert torch.equal(pb.color_mat, torch.eye(3).expand(64, 3, 3))
    assert pb.geom is None and pb.filt is None and pb.noise is None \
        and pb.cutout is None
    pc = TA.sample_params(_gen(0), 64, 16, 1.0, "c")
    assert not pc.flip.any() and not pc.trans.any() and not pc.rot_k.any()
    assert ((pc.color_mat - torch.eye(3)).abs().sum((1, 2)) > 1e-3).any()
    pg = TA.sample_params(_gen(0), 64, 16, 1.0, "g")
    assert ((pg.geom - torch.tensor(_EYE23)).abs().sum((1, 2)) > 1e-3).any()
    assert not pg.flip.any()
    assert torch.equal(pg.color_mat, torch.eye(3).expand(64, 3, 3))
    pf = TA.sample_params(_gen(0), 64, 16, 1.0, "fnu")
    assert pf.filt_active.any() and pf.noise.abs().sum() > 0
    assert (pf.cutout[:, 2] > 0).any() and not pf.flip.any()
    assert pf.noise.shape == (64, 3, 16, 16)
    p0 = TA.sample_params(_gen(0), 8, 16, 0.0, "gfnu")
    assert torch.equal(p0.geom, torch.tensor(_EYE23).expand(8, 2, 3))
    assert not p0.filt_active.any() and not p0.noise.any()
    assert not p0.cutout[:, 2].any()


def test_later_categories_leave_bc_draws_unchanged():
    a = TA.sample_params(_gen(3), 16, 16, 0.7, "bc")
    b = TA.sample_params(_gen(3), 16, 16, 0.7, "bcgfnu")
    for fld in ("flip", "rot_k", "trans", "color_mat", "color_bias"):
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld


def test_sample_params_follows_a_device_tensor_p():
    """p as a 0-d tensor (the state's ``ada_p``) gates like the float."""
    a = TA.sample_params(_gen(4), 32, 16, 0.45, "bcgfnu")
    b = TA.sample_params(_gen(4), 32, 16, torch.tensor(0.45), "bcgfnu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- the transforms against hand-built params (tests/test_augment.py) ---------

def test_xflip_exact():
    x = _imgs()
    out = apply_augment(x, _identity(4, flip=torch.ones(4, dtype=torch.bool)))
    assert torch.equal(out, x.flip(3))


def test_rot180_exact():
    x = _imgs()
    out = apply_augment(x, _identity(4, rot_k=torch.full((4,), 2)))
    assert torch.equal(out, x.flip(2, 3))


def test_rot90_is_quarter_turn_bijection():
    x = _imgs()
    for k in (1, 3):
        y = apply_augment(x, _identity(4, rot_k=torch.full((4,), k)))
        assert torch.equal(y.flatten().sort().values,
                           x.flatten().sort().values)
        assert not torch.allclose(y, x)
    # out[y, x] = in[res - 1 - x, y] at k = 1
    y = apply_augment(x, _identity(4, rot_k=torch.ones(4, dtype=torch.int64)))
    assert torch.equal(y[0, 0, 2, 5], x[0, 0, 15 - 5, 2])


def test_translation_reflect_pads():
    x = _imgs(b=1, res=8)
    y = apply_augment(x, _identity(1, trans=torch.tensor([[2, 0]])))[0]
    assert torch.equal(y[:, 2:], x[0, :, :-2])
    assert torch.equal(y[:, 0], x[0, :, 1])          # reflected
    assert torch.equal(y[:, 1], x[0, :, 0])


def test_luma_flip_is_involution_and_preserves_gray():
    x = _imgs()
    v = np.ones(3) / np.sqrt(3)
    lf = torch.tensor(np.eye(3) - 2 * np.outer(v, v), dtype=torch.float32)
    p = _identity(4, color_mat=lf.expand(4, 3, 3).clone())
    torch.testing.assert_close(apply_augment(apply_augment(x, p), p), x,
                               rtol=0, atol=1e-5)
    gray = torch.full((1, 3, 4, 4), 0.3)
    torch.testing.assert_close(
        apply_augment(gray, _identity(1, color_mat=lf[None].clone())), -gray,
        rtol=0, atol=1e-5)


def test_values_bounded_blit():
    y = augment(_imgs(), 1.0, _gen(5), "b")
    assert y.min() >= -1.0 - 1e-6 and y.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("cats", ["bc", "g", "fnu", "bcgfnu"])
def test_gradients_flow(cats):
    x = _imgs().requires_grad_(True)
    augment(x, 0.9, _gen(3), cats).square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_backward_is_the_same_bits_every_call():
    """The gathers' backward (blit translation, the resampling taps, the
    filter's padding) sums in a fixed order."""
    params = TA.sample_params(_gen(9), 8, 32, 0.9, "bcgfnu")
    x = _imgs(b=8, res=32)
    cot = torch.randn(x.shape, generator=_gen(10))
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        (apply_augment(xx, params) * cot).sum().backward()
        grads.append(xx.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dim,index_shape", [
    (2, (4, 1, 8, 1)), (3, (4, 1, 1, 8)), (3, (4, 1, 8, 8)),
    (2, (1, 1, 50, 1))], ids=["rows", "cols", "taps", "pad"])
def test_index_put_sum_is_scatter_add(dim, index_shape):
    """The card's backward sum (sorted ``index_put_``, the broadcast dims
    riding as slices), run here on the CPU, against ``scatter_add``."""
    gen = _gen(11)
    shape = (4, 3, 8, 8)
    idx = torch.randint(0, 8, index_shape, generator=gen)
    out_shape = list(shape)
    out_shape[dim] = index_shape[dim]
    src = torch.randn(out_shape, generator=gen, dtype=torch.float64)
    got = TA._index_put_sum(shape, dim, idx, src)
    want = torch.zeros(shape, dtype=torch.float64).scatter_add(
        dim, idx.expand(out_shape), src)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_take_scatter_sum_matches_gather_backward():
    """``_take``'s deterministic backward is gather's: a sum over the
    outputs that read each source position (duplicates included)."""
    x = torch.randn(2, 3, 8, 5, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([0, 0, 1, 7, 7, 7, 3, 2, 2, 5])[None, None, :, None]
    assert torch.autograd.gradcheck(lambda t: TA._take(t, idx, 2), (x,))
    assert torch.autograd.gradgradcheck(lambda t: TA._take(t, idx, 2), (x,))


class TestGeometric:
    def test_identity_affine_exact(self):
        x = _imgs()
        assert torch.equal(apply_augment(x, _identity(4, geom=_geom(
            4, _EYE23))), x)

    def test_quarter_turn_affine_matches_blit_rot90(self):
        x = _imgs()
        a = apply_augment(x, _identity(4, geom=_geom(
            4, [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])))
        b = apply_augment(x, _identity(4, rot_k=torch.ones(4,
                                                           dtype=torch.int64)))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)

    def test_integer_translation_affine_matches_blit(self):
        x = _imgs()
        a = apply_augment(x, _identity(4, geom=_geom(
            4, [[1.0, 0.0, -2.0], [0.0, 1.0, -3.0]])))
        b = apply_augment(x, _identity(4, trans=torch.tensor(
            [2, 3]).expand(4, 2).clone()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)

    def test_bilinear_on_linear_ramp_matches_affine(self):
        b, res, s = 2, 16, 1.3
        ramp = torch.arange(res, dtype=torch.float32)[None, None, :, None] \
            .expand(b, 3, res, res).clone()
        out = apply_augment(ramp, _identity(b, geom=_geom(
            b, [[1.0 / s, 0.0, 0.0], [0.0, 1.0 / s, 0.0]]))).numpy()
        c0 = (res - 1) / 2.0
        fy = (np.arange(res) - c0) / s + c0
        inside = (fy >= 0) & (fy <= res - 1)
        want = np.broadcast_to(fy[None, None, :, None], out.shape)
        np.testing.assert_allclose(out[:, :, inside], want[:, :, inside],
                                   atol=1e-4)

    def test_rotated_linear_ramp_exact(self):
        b, res = 2, 16
        c0 = (res - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(res) - c0, np.arange(res) - c0,
                             indexing="ij")
        ramp = torch.tensor(np.broadcast_to(
            (0.25 * yy + 0.1 * xx)[None, None], (b, 3, res, res)),
            dtype=torch.float32)
        for theta in (0.4, 1.2, 2.0, -2.8):       # all four quadrants
            c, s = np.cos(theta), np.sin(theta)
            out = apply_augment(ramp, _identity(b, geom=_geom(
                b, [[c, s, 0.0], [-s, c, 0.0]])))[0, 0].numpy()
            fy, fx = c * yy + s * xx, -s * yy + c * xx
            inside = (np.abs(fy) <= c0 - 1) & (np.abs(fx) <= c0 - 1) \
                & (np.abs(yy) <= c0 - 1) & (np.abs(xx) <= c0 - 1)
            np.testing.assert_allclose(out[inside],
                                       (0.25 * fy + 0.1 * fx)[inside],
                                       atol=1e-4, err_msg=str(theta))

    def test_rotation_near_direct_bilinear_on_smooth_blob(self):
        res, sig, theta = 32, 4.0, 0.6
        c0 = (res - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(res) - c0, np.arange(res) - c0,
                             indexing="ij")
        blob = np.exp(-(yy ** 2 + xx ** 2) / (2 * sig ** 2)).astype(np.float32)
        x = torch.from_numpy(blob)[None, None].expand(1, 3, res, res).clone()
        c, s = np.cos(theta), np.sin(theta)
        out = apply_augment(x, _identity(1, geom=_geom(
            1, [[c, s, 0.0], [-s, c, 0.0]])))[0, 0].numpy()
        fy, fx = c * yy + s * xx + c0, -s * yy + c * xx + c0
        y0, x0 = np.floor(fy).astype(int), np.floor(fx).astype(int)
        wy, wx = fy - y0, fx - x0

        def refl(i):
            t = np.mod(i, 2 * res)
            return np.where(t >= res, 2 * res - 1 - t, t)

        oracle = (blob[refl(y0), refl(x0)] * (1 - wy) * (1 - wx)
                  + blob[refl(y0), refl(x0 + 1)] * (1 - wy) * wx
                  + blob[refl(y0 + 1), refl(x0)] * wy * (1 - wx)
                  + blob[refl(y0 + 1), refl(x0 + 1)] * wy * wx)
        assert np.max(np.abs(out - oracle)) < 0.02


class TestFilterNoiseCutout:
    def test_filter_bank_rows_sum_to_delta_and_are_palindromes(self):
        taps = TA.FILTER_TAPS
        delta = np.zeros(taps)
        delta[taps // 2] = 1.0
        np.testing.assert_allclose(TA._HZ_FBANK.sum(0), delta, atol=1e-12)
        np.testing.assert_allclose(TA._HZ_FBANK, TA._HZ_FBANK[:, ::-1],
                                   atol=1e-12)

    def test_filter_gain_normalization_is_expected_power(self):
        ep = np.array([10.0, 1.0, 1.0, 1.0]) / 13.0
        t = np.array([[1.0, 1.0, 1.0, 1.0], [4.0, 1.0, 1.0, 1.0],
                      [1.0, 1.0, 1.0, 0.25]])
        want = t / np.sqrt((ep * t ** 2).sum(axis=1, keepdims=True))
        got = TA._normalize_filter_gain(torch.tensor(t, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(got[0].numpy(), np.ones(4), rtol=1e-6)

    @pytest.mark.parametrize("res", [8, 16])
    def test_filter_matches_numpy_separable_oracle(self, res):
        """Sample 0 fires no band (untouched bit for bit), sample 1 has
        band 3 doubled; at 8x8 the 21-tap reflection wraps more than
        once."""
        x = _imgs(b=2, res=res, seed=2)
        ep = np.array([10.0, 1.0, 1.0, 1.0]) / 13.0
        t = np.ones((2, 4))
        t[1, 3] = 2.0
        t = t / np.sqrt((ep * t ** 2).sum(axis=1, keepdims=True))
        filt = torch.tensor(t @ TA._HZ_FBANK, dtype=torch.float32)
        out = apply_augment(x, _identity(2, filt=filt,
                                         filt_active=torch.tensor(
                                             [False, True])))
        assert torch.equal(out[0], x[0])

        def sep(im, w):                 # (C, H, W) float64
            pad = len(w) // 2
            im = np.pad(im, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
            o = sum(w[k] * im[:, k:k + res] for k in range(len(w)))
            im = np.pad(o, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
            return sum(w[k] * im[:, :, k:k + res] for k in range(len(w)))

        want = sep(x[1].double().numpy(), filt[1].double().numpy())
        np.testing.assert_allclose(out[1].numpy(), want, atol=1e-5)

    def test_noise_is_exact_add(self):
        x = _imgs(b=2)
        field = torch.randn(2, 3, 16, 16, generator=_gen(3)) * 0.1
        assert torch.equal(apply_augment(x, _identity(2, noise=field)),
                           x + field)

    def test_cutout_mask_oracle(self):
        x = _imgs(b=2, seed=4)
        out = apply_augment(x, _identity(2, cutout=torch.tensor(
            [[0.5, 0.5, 0.5], [0.5, 0.5, 0.0]])))
        assert torch.equal(out[1], x[1])
        coord = (np.arange(16) + 0.5) / 16
        keep = (np.abs(coord - 0.5)[:, None] >= 0.25) \
            | (np.abs(coord - 0.5)[None, :] >= 0.25)
        assert torch.equal(out[0], x[0] * torch.from_numpy(keep).float())
        assert float((out[0] == 0).float().mean()) == 0.25


# -- the training step --------------------------------------------------------

ADA = {"aug.mode": "ada", "aug.categories": "bcgfnu", "aug.p_init": 0.5,
       "aug.kimg": 0.5, "aug.target": 0.6}
B, LG = 4, 4


@pytest.fixture(scope="module")
def ada_world():
    w = make_world()
    w["cfg"] = get_config("stylegan-256", **dict(SMALL, **ADA))
    w["jcfg"] = jax_get_config("stylegan-256", **dict(SMALL, **ADA))
    w["jaug"] = [JA.sample_params(jax.random.PRNGKey(20 + i), B, 16, 0.5,
                                  "bcgfnu") for i in range(3)]
    return w


def _port_draws(w):
    dr = to_port_draws(w["flip"], w["dd"], w["dg"])
    dr.aug = tuple(aug_params_from_arrays(jax.tree_util.tree_map(
        np.asarray, p._asdict())) for p in w["jaug"])
    return dr


def _jax_ada_harness(w, penalty_on: bool, port_new_d: dict):
    """The JAX package's sequential step with augmentation (``steps.py``
    :344-435) on injected params: D on the augmented reals and fakes, R1
    on the augmented reals, rt, and G through its augmented fakes against
    the port's updated D."""
    from ganlab_tpu.models.stylegan import mix_styles as jax_mix_styles

    jg, jd, jcfg = w["jg"], w["jd"], w["jcfg"]
    nl = 2 * (LG - 1)
    real = jax_steps._preprocess(jnp.asarray(w["real"]), False, None,
                                 jnp.float32)
    real = jnp.where(jnp.asarray(w["flip"])[:, None, None, None],
                     real[:, :, ::-1, :], real)
    a_real, a_fake_d, a_fake_g = w["jaug"]

    def gen_fwd(params_g, d):
        ww = jg.apply(params_g, jnp.concatenate([d["z1"], d["z2"]]),
                      method="map_latents")
        ws = jax_mix_styles(ww[:B], ww[B:], jnp.where(d["use_mix"],
                                                      d["cross"], nl), nl)
        return jg.apply(params_g, ws, LG, 1.0, list(d["noises"]),
                        method="synthesize")

    def d_apply(params_d, x):
        return jd.apply(params_d, x, LG, 1.0).astype(jnp.float32)

    gamma = jcfg.loss.penalty_weight * jcfg.loss.penalty_every

    def run(pg, pd, new_d, dd, dg):
        real_a = JA.apply_augment(real, a_real)
        fake_a = JA.apply_augment(gen_fwd(pg, dd), a_fake_d)

        def d_objective(params_d):
            real_s = d_apply(params_d, real_a)
            fake_s = d_apply(params_d, fake_a)
            loss = JL.d_loss_nonsaturating(real_s, fake_s)
            pen = (JL.r1_penalty(lambda x: d_apply(params_d, x), real_a,
                                 gamma) if penalty_on else jnp.float32(0.0))
            return loss + pen, {"d_loss": loss, "penalty": pen,
                                "real_score": jnp.mean(real_s),
                                "fake_score": jnp.mean(fake_s),
                                "rt": jnp.mean(jnp.sign(real_s))}

        (_, aux), d_grads = jax.value_and_grad(d_objective, has_aux=True)(pd)

        def g_objective(params_g):
            fake = JA.apply_augment(gen_fwd(params_g, dg), a_fake_g)
            return JL.g_loss_nonsaturating(d_apply(new_d, fake))

        g_loss, g_grads = jax.value_and_grad(g_objective)(pg)
        return dict(aux, g_loss=g_loss), d_grads, g_grads

    return jax.jit(run)(w["pg"], w["pd"], port_new_d, w["dd"], w["dg"])


@pytest.fixture(scope="module", params=[True, False], ids=["r1_on", "r1_off"])
def ada_stepped(ada_world, request):
    w = ada_world
    st = port_state(w)
    p0 = float(st.ada_p)
    step = tsteps.build_train_step(w["cfg"], w["phase"],
                                   penalty_override=request.param)
    st, metrics = step(st, torch.from_numpy(w["real"]), _port_draws(w))
    want, d_grads, g_grads = _jax_ada_harness(w, request.param,
                                              to_flax(st.d))
    return dict(st=st, metrics=metrics, want=want, d_grads=d_grads,
                g_grads=g_grads, p0=p0, penalty_on=request.param)


def test_ada_step_losses_scores_and_rt(ada_stepped):
    m, want = ada_stepped["metrics"], ada_stepped["want"]
    for k in ("d_loss", "g_loss", "penalty", "real_score", "fake_score"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (float(m["penalty"]) > 0) == ada_stepped["penalty_on"]
    assert float(m["aug_rt"]) == float(want["rt"])


def test_ada_step_updates_p_by_the_jax_rule(ada_stepped, ada_world):
    ac = ada_world["jcfg"].aug
    rt = jnp.float32(ada_stepped["want"]["rt"])
    want = jnp.clip(jnp.float32(ada_stepped["p0"]) + jnp.sign(
        rt - jnp.float32(ac.target)) * (jnp.float32(B) / jnp.float32(
            ac.kimg * 1000.0)), 0.0, jnp.float32(ac.p_max))
    st = ada_stepped["st"]
    assert float(st.ada_p) == float(want) != ada_stepped["p0"]
    assert float(ada_stepped["metrics"]["aug_p"]) == float(st.ada_p)
    assert st.ada_p.dtype == torch.float32 and st.ada_p.dim() == 0


def test_ada_step_d_gradients(ada_stepped):
    assert_grads(ada_stepped["st"].d, ada_stepped["d_grads"], "D")


def test_ada_step_g_gradients(ada_stepped):
    assert_grads(ada_stepped["st"].g, ada_stepped["g_grads"], "G")


def _ada_cfg(**over):
    """tests/test_augment.py's ``_ada_cfg``: 16x16, fmap_base 128, batch 4,
    target -2 (rt is always above it, so p rises every step)."""
    return get_config("stylegan-256", **dict({
        "model.resolution": 16, "model.fmap_base": 128,
        "model.fmap_max": 16, "model.latent_dim": 16,
        "model.mapping_layers": 2, "schedule.progressive": False,
        "schedule.start_res": 16, "schedule.batch_schedule": {16: 4},
        "aug.mode": "ada", "aug.kimg": 0.5, "aug.target": -2.0,
        "loss.penalty_every": 4, "run.compute_dtype": "float32"}, **over))


def _batch(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 255, (4, 16, 16, 3), dtype=np.uint8))


def test_p_rises_at_documented_rate():
    cfg = _ada_cfg()
    st = create_train_state(cfg, seed=0, device="cpu")
    assert st.ada_p is not None and float(st.ada_p) == 0.0
    stepper = make_lazy_stepper(cfg, build_phases(cfg.schedule,
                                                  cfg.model)[0])
    for _ in range(6):                      # R1 on the first, then off
        st, m = stepper(st, _batch())
    assert abs(float(st.ada_p) - 6 * 4 / 500.0) < 1e-5
    assert float(m["aug_p"]) == float(st.ada_p)
    assert -1.0 <= float(m["aug_rt"]) <= 1.0
    assert set(m) == {"d_loss", "g_loss", "penalty", "real_score",
                      "fake_score", "alpha", "aug_p", "aug_rt"}


def test_p_clips_at_zero_and_pmax():
    phase = build_phases(_ada_cfg().schedule, _ada_cfg().model)[0]
    cfg = _ada_cfg(**{"aug.target": 2.0})         # rt < target always
    st = create_train_state(cfg, seed=0, device="cpu")
    st, _ = tsteps.build_train_step(cfg, phase, penalty_override=False)(
        st, _batch())
    assert float(st.ada_p) == 0.0
    cfg2 = _ada_cfg(**{"aug.p_init": 0.8})        # p_max 0.8 by default
    st2 = create_train_state(cfg2, seed=0, device="cpu")
    st2, _ = tsteps.build_train_step(cfg2, phase, penalty_override=False)(
        st2, _batch())
    assert float(st2.ada_p) == float(np.float32(0.8))


def test_fixed_mode_has_no_state_leaf():
    cfg = _ada_cfg(**{"aug.mode": "fixed", "aug.p_init": 0.3,
                      "aug.categories": "bcgfnu"})
    st = create_train_state(cfg, seed=0, device="cpu")
    assert st.ada_p is None and "ada_p" not in state_tensors(st)
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st, m = tsteps.build_train_step(cfg, phase, penalty_override=True)(
        st, _batch())
    assert st.ada_p is None and "aug_p" not in m and "aug_rt" not in m
    assert all(np.isfinite(float(v)) for v in m.values())


def test_aug_draws_come_last():
    """With augmentation on, the draws before it are aug-off's, bit for
    bit, and the three AugParams follow."""
    off = _ada_cfg(**{"aug.mode": "off"})
    on = _ada_cfg(**{"aug.categories": "bcgfnu"})
    a = tsteps.draw_step(off, 4, 4, _gen(0), "cpu")
    b = tsteps.draw_step(on, 4, 4, _gen(0), "cpu")
    assert a.aug is None and len(b.aug) == 3
    assert torch.equal(a.flip, b.flip) and torch.equal(a.gp_eps, b.gp_eps)
    assert torch.equal(a.g.z1, b.g.z1)
    assert all(torch.equal(x, y) for x, y in zip(a.g.noises, b.g.noises))


def test_injected_draws_without_aug_raise(ada_world):
    st = port_state(ada_world)
    step = tsteps.build_train_step(ada_world["cfg"], ada_world["phase"],
                                   penalty_override=False)
    with pytest.raises(ValueError, match="StepDraws.aug"):
        step(st, torch.from_numpy(ada_world["real"]),
             to_port_draws(ada_world["flip"], ada_world["dd"],
                           ada_world["dg"]))


def test_train_step_runs_with_geom_and_full_pipeline_bf16():
    cfg = _ada_cfg(**{"aug.categories": "bcgfnu",
                      "run.compute_dtype": "bfloat16"})
    st = create_train_state(cfg, seed=0, device="cpu")
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st, m = tsteps.build_train_step(cfg, phase, penalty_override=True)(
        st, _batch())
    assert all(np.isfinite(float(v)) for v in m.values())


# -- checkpoints and the JAX state --------------------------------------------

def test_ada_p_checkpoint_roundtrip_and_migration(tmp_path):
    cfg = _ada_cfg(**{"aug.p_init": 0.25})
    st = create_train_state(cfg, seed=0, device="cpu")
    st.ada_p.fill_(0.375)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, st)
    back = mgr.restore(create_train_state(cfg, seed=1, device="cpu"))
    assert float(back.ada_p) == 0.375
    # an ADA checkpoint into a configuration without ADA: dropped
    off = _ada_cfg(**{"aug.mode": "off"})
    back_off = mgr.restore(create_train_state(off, seed=1, device="cpu"))
    assert back_off.ada_p is None and "ada_p" not in state_tensors(back_off)
    # a checkpoint without ada_p into an ADA configuration: p_init
    mgr2 = CheckpointManager(str(tmp_path / "ck2"))
    mgr2.save(1, create_train_state(off, seed=0, device="cpu"))
    back_on = mgr2.restore(create_train_state(cfg, seed=2, device="cpu"))
    assert float(back_on.ada_p) == float(np.float32(0.25))
    assert "ada_p" not in torch.load(mgr2.path(1), weights_only=True)


def test_bitwise_resume_with_ada(tmp_path):
    """Six steps in one go against three, a checkpoint, a fresh state and
    three more: ada_p and every other leaf the same bits."""
    cfg = _ada_cfg(**{"aug.categories": "bcgfnu", "aug.target": 0.6,
                      "aug.p_init": 0.4})
    phase = build_phases(cfg.schedule, cfg.model)[0]

    def run(st, first, n):
        stepper = make_lazy_stepper(cfg, phase, initial_step=st.step)
        for i in range(first, first + n):
            st, m = stepper(st, _batch(i))
        return st

    whole = run(create_train_state(cfg, seed=0, device="cpu"), 0, 6)
    part = run(create_train_state(cfg, seed=0, device="cpu"), 0, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(part.step, part)
    resumed = run(mgr.restore(create_train_state(cfg, seed=5, device="cpu")),
                  3, 3)
    a, b = state_tensors(whole), state_tensors(resumed)
    assert a.keys() == b.keys() and "ada_p" in a
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert float(whole.ada_p) != float(np.float32(0.4))


def test_load_jax_train_state_carries_ada_p():
    over = {"model.resolution": 16, "model.fmap_base": 128,
            "model.fmap_max": 16, "model.latent_dim": 16,
            "model.mapping_layers": 2, "aug.mode": "ada",
            "aug.p_init": 0.125}
    js = jax_create_state(jax_get_config("stylegan-256", **over),
                          jax.random.PRNGKey(0))
    js = js.replace(ada_p=jnp.float32(0.4375))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def adam(opt):
        return {"count": int(opt[0].count), "mu": np_(opt[0].mu),
                "nu": np_(opt[0].nu)}

    arrays = {"params_g": np_(js.params_g), "params_d": np_(js.params_d),
              "params_ema": np_(js.params_ema), "opt_g": adam(js.opt_g),
              "opt_d": adam(js.opt_d), "w_avg": np.asarray(js.w_avg),
              "step": 0, "shown_imgs": 0, "ada_p": np.asarray(js.ada_p)}
    cfg = get_config("stylegan-256", **over)
    st = create_train_state(cfg, seed=0, device="cpu")
    assert float(st.ada_p) == 0.125
    assert float(load_jax_train_state(st, arrays, cfg).ada_p) == 0.4375
    del arrays["ada_p"]
    st = create_train_state(cfg, seed=0, device="cpu")
    assert float(load_jax_train_state(st, arrays, cfg).ada_p) == 0.125


# -- the command line ---------------------------------------------------------

def test_cli_train_with_ada_logs_aug_metrics(tmp_path):
    """``cli train --set aug.mode=ada`` through a progressive 8x8 -> 16x16
    schedule (the filter's reflection beyond the image at both): the
    log's rows carry aug_p and aug_rt, and aug_p moves by the rate."""
    sets = {"model.resolution": 16, "model.fmap_base": 64,
            "model.fmap_max": 8, "model.latent_dim": 8,
            "model.mapping_layers": 1, "run.compute_dtype": "float32",
            "schedule.start_res": 8, "schedule.fade_kimg": 0.004,
            "schedule.stabilize_kimg": 0.004,
            "schedule.batch_schedule": {8: 2, 16: 2},
            "data.dataset": "synthetic", "run.log_every": 1,
            "run.sample_every": 0, "run.num_sample_images": 4,
            "aug.mode": "ada", "aug.categories": "bcgfnu",
            "aug.kimg": 0.1, "aug.target": -2.0,
            # a row every step (chunked stepping logs once a chunk)
            "run.chunk_steps": False}
    args = ["train", "--preset", "stylegan-256", "--device", "cpu",
            "--workdir", str(tmp_path), "--max-steps", "5"]
    for k, v in sets.items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    rows = [json.loads(line) for line in
            (tmp_path / "train.jsonl").read_text().splitlines()]
    assert len(rows) == 5 and {r["res"] for r in rows} == {8, 16}
    ps = [r["aug_p"] for r in rows]
    np.testing.assert_allclose(ps, [0.02 * (i + 1) for i in range(5)],
                               rtol=1e-5)
    assert all(-1.0 <= r["aug_rt"] <= 1.0 for r in rows)
    saved = torch.load(sorted((tmp_path / "checkpoints").iterdir())[-1],
                       weights_only=True)
    assert float(saved["ada_p"]) == pytest.approx(ps[-1])

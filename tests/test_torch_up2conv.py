"""``model.fused_up_conv``: the composed upsample + conv of the port against
the JAX package, and through everything that builds its generators.

On the CPU (JAX under ``highest`` matmul precision, from conftest), inputs
from numpy seeds:

* ``up2_conv2d`` against the JAX ``up2_conv2d`` for the blur and nearest
  taps, dilated and polyphase, on an odd and an even H != W: forward
  within 2e-5, gradients of ``sum(tanh(y))`` within 3e-5 (the JAX
  package's own tolerances against its two-op form); ``compose_up2_kernel``;
  the hybrid forward and backward against JAX's ``up2_conv2d_hybrid``; the
  hybrid Function in float64 (``gradcheck``, ``gradgradcheck``, a second
  backward over a retained graph, ``torch.utils.checkpoint``), its
  gradients the two-op form's bit for bit; ``equalized_conv2d_up2``.
* Both generators on converted parameters under each form against the JAX
  generator with the same ``fused_up_conv`` and against the port's two-op
  generator, at a fade (alpha 0.4) and at full resolution, within 2e-4;
  the parameter tree the same under every form; ProGAN under ``'hybrid'``
  raises the JAX package's ``ValueError``; bf16 no further from the
  float32 two-op image than twice the bf16 two-op image.
* One training step of a small stylegan-256 under each form (R1 on; also
  with remat and under ``loss.fused_g_step``) against the same step under
  the two-op form: losses and every gradient leaf within 1e-4 of the
  leaf's scale; the plain up+blur and blur+down calls of a step under each
  form (as launches on the card) against ``chip_smoke.step_launches``.
* The exported sampler and ``BatchSampler`` under the dilated and the
  polyphase form, the same bits; ``--set model.fused_up_conv=poly``
  through ``cli train``.

The card's tests of the composed forms are in ``test_torch_up2conv_card.py``
(no JAX there).
"""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.export import ExportedSampler, export_sampler
from ganlab_tpu_torch.models import build_generator, build_models
from ganlab_tpu_torch.models.stylegan import noise_shapes, num_style_layers
from ganlab_tpu_torch.ops import (
    compose_up2_kernel,
    equalized_conv2d,
    equalized_conv2d_up2,
    up2_conv2d,
    up2_conv2d_hybrid,
    upsample_blur_2x,
    upsample_nearest_2x,
)
from ganlab_tpu_torch.ops.kernels import resample
from ganlab_tpu_torch.serve import BatchSampler
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps

import jax
import jax.numpy as jnp

from ganlab_tpu import ops as jops
from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.ops import equalized as jeq
from ganlab_tpu.ops.upfirdn import up2_conv2d_hybrid as jax_hybrid
from tests.test_torch_train_step import perturb, to_flax

torch.set_num_threads(1)

BLUR = (1.0, 2.0, 1.0)
FORMS = [True, "poly", "hybrid"]
FORM_IDS = ["dilated", "poly", "hybrid"]
SHAPES = [(2, 7, 5, 4), (2, 6, 4, 3)]          # NHWC: odd and even, H != W
TOL = 2e-5                                     # forward, as the JAX tests
GRAD_TOL = 3e-5                                # gradients, likewise
G_TOL = 2e-4                                   # generators
STEP_REL = 1e-4                                # a step's leaves, of scale


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def _inputs(shape, out_ch=6, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(3, 3, shape[-1], out_ch).astype(np.float32)
    return x, w


def _port_grads(fn, x, w):
    xt = _nchw(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad(torch.tanh(y).sum(), (xt, wt))
    return y, gx, gw


def _jax_grads(fn, x, w):
    """fn(x, w) and the gradients of sum(tanh(fn)), as one jitted program
    (one compile, where eager JAX compiles each op)."""
    @jax.jit
    def run(a, b):
        grads = jax.grad(lambda a, b: jnp.sum(jnp.tanh(fn(a, b))),
                         (0, 1))(a, b)
        return (fn(a, b),) + grads

    return run(jnp.asarray(x), jnp.asarray(w))


def _assert_like_jax(port, want, tol=TOL, grad_tol=GRAD_TOL):
    y, gx, gw = port
    jy, jgx, jgw = want
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_nhwc(gx), np.asarray(jgx), rtol=grad_tol,
                               atol=grad_tol)
    np.testing.assert_allclose(_hwio(gw), np.asarray(jgw), rtol=grad_tol,
                               atol=grad_tol)


# -- the ops --------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["odd", "even"])
@pytest.mark.parametrize("poly", [False, True], ids=["dilated", "poly"])
@pytest.mark.parametrize("taps", [BLUR, None], ids=["blur", "nearest"])
def test_up2_conv2d_matches_jax(shape, poly, taps):
    x, w = _inputs(shape)
    _assert_like_jax(
        _port_grads(lambda a, b: up2_conv2d(a, b, taps, poly), x, w),
        _jax_grads(lambda a, b: jops.up2_conv2d(a, b, taps=taps,
                                                polyphase=poly), x, w))


@pytest.mark.parametrize("taps", [BLUR, None], ids=["blur", "nearest"])
def test_compose_up2_kernel_matches_jax(taps):
    _, w = _inputs((1, 2, 2, 5), out_ch=4, seed=1)
    got = compose_up2_kernel(_oihw(w), taps)
    want = np.asarray(jops.compose_up2_kernel(jnp.asarray(w), taps))
    assert got.shape == (4, 5) + want.shape[:2]
    np.testing.assert_allclose(_hwio(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=["odd", "even"])
def test_hybrid_matches_jax(shape):
    x, w = _inputs(shape, seed=2)
    _assert_like_jax(_port_grads(up2_conv2d_hybrid, x, w),
                     _jax_grads(jax_hybrid, x, w))


def test_hybrid_function_float64():
    """gradcheck / gradgradcheck of the hybrid Function; its gradients the
    two-op form's bit for bit; a second backward over a retained graph
    (``loss.fused_g_step`` runs two over one G graph) and a checkpointed
    call give the same bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 2, 3, 4, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(2, 2, 3, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(up2_conv2d_hybrid, (x, w))
    assert torch.autograd.gradgradcheck(up2_conv2d_hybrid, (x, w))
    ct = torch.randn(1, 2, 6, 8, dtype=torch.float64, generator=g)
    y = up2_conv2d_hybrid(x, w)
    first = torch.autograd.grad(y, (x, w), ct, retain_graph=True)
    second = torch.autograd.grad(y, (x, w), ct)
    two_op = torch.autograd.grad(
        F.conv2d(upsample_blur_2x(x), w, padding=1), (x, w), ct)
    ckpt = torch.autograd.grad(torch.utils.checkpoint.checkpoint(
        up2_conv2d_hybrid, x, w, use_reentrant=False), (x, w), ct)
    for got in (second, two_op, ckpt):
        for a, b in zip(first, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("taps,form", [(BLUR, "dilated"), (BLUR, "poly"),
                                       (BLUR, "hybrid"), (None, "dilated"),
                                       (None, "poly")],
                         ids=["blur-dilated", "blur-poly", "blur-hybrid",
                              "nearest-dilated", "nearest-poly"])
def test_equalized_conv2d_up2_matches_jax(taps, form):
    x, w = _inputs((2, 6, 5, 4), seed=4)
    b = np.random.RandomState(5).randn(6).astype(np.float32)
    got = equalized_conv2d_up2(_nchw(x), _oihw(w), torch.from_numpy(b),
                               taps=taps, form=form, lr_mult=0.5)
    want = jeq.equalized_conv2d_up2(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), taps=taps, form=form,
                                    lr_mult=0.5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL,
                               atol=TOL)
    up = upsample_nearest_2x if taps is None else upsample_blur_2x
    two_op = equalized_conv2d(up(_nchw(x)), _oihw(w), torch.from_numpy(b),
                              lr_mult=0.5)
    torch.testing.assert_close(got, two_op, rtol=TOL, atol=TOL)


def test_hybrid_nearest_raises_as_in_jax():
    x, w = _inputs((1, 4, 4, 2), seed=6)
    with pytest.raises(ValueError, match="hybrid") as got:
        equalized_conv2d_up2(_nchw(x), _oihw(w), taps=None, form="hybrid")
    with pytest.raises(ValueError) as want:
        jeq.equalized_conv2d_up2(jnp.asarray(x), jnp.asarray(w), taps=None,
                                 form="hybrid")
    assert str(got.value) == str(want.value)


# -- the generators -------------------------------------------------------------

SG = {"model.resolution": 32, "model.fmap_base": 256, "model.fmap_max": 32,
      "model.latent_dim": 16, "model.mapping_layers": 2,
      "run.compute_dtype": "float32"}
PG = {"model.resolution": 16, "model.fmap_base": 64, "model.latent_dim": 16,
      "run.compute_dtype": "float32"}
N = 3


def _flax_params(preset, sets, seed):
    """A flax parameter tree of the preset's G, seeded and perturbed by
    numpy noise (at init the noise scales and biases are 0), in the layout
    the JAX G of every form initializes (read by ``jax.eval_shape``, which
    compiles nothing)."""
    torch.manual_seed(seed)
    params = perturb(to_flax(build_generator(get_config(
        preset, **sets).model)), seed=seed)
    for form in [False] + FORMS[:2 if preset == "progan-128" else 3]:
        jg, _ = jax_build_models(jax_get_config(preset, **dict(
            sets, **{"model.fused_up_conv": form})).model)
        shapes = jax.eval_shape(jg.init_all, jax.random.PRNGKey(0))
        assert jax.tree_util.tree_map(np.shape, params) == \
            jax.tree_util.tree_map(np.shape, shapes), form
    return params


@pytest.fixture(scope="module")
def sg_params():
    return _flax_params("stylegan-256", SG, 0)


def _port_g(preset, sets, form, params):
    g = build_generator(get_config(preset, **dict(
        sets, **{"model.fused_up_conv": form})).model)
    g.load_state_dict(from_flax(params))
    return g.eval().requires_grad_(False)


def _sg_inputs(lg, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    ws = rs.randn(N, num_style_layers(lg), 16).astype(dtype)
    nz = [rs.randn(N, h, w, 1).astype(dtype) for h, w in noise_shapes(lg)]
    return ws, nz


def _synthesize(g, ws, nz, lg, alpha, dtype=torch.float32):
    return g.synthesize(torch.from_numpy(ws).to(dtype), lg, alpha,
                        [_nchw(a).to(dtype) for a in nz])


@pytest.mark.parametrize("lg,alpha", [(5, 1.0), (4, 0.4)],
                         ids=["32-stable", "16-fade"])
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_stylegan_generator_matches_jax(sg_params, form, lg, alpha):
    jg, _ = jax_build_models(jax_get_config("stylegan-256", **dict(
        SG, **{"model.fused_up_conv": form})).model)
    ws, nz = _sg_inputs(lg, 2)
    want = jax.jit(lambda p, ws, nz: jg.apply(
        p, ws, lg, alpha, nz, method="synthesize"))(
            sg_params, jnp.asarray(ws), [jnp.asarray(a) for a in nz])
    got = _synthesize(_port_g("stylegan-256", SG, form, sg_params), ws, nz,
                      lg, alpha)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=G_TOL,
                               atol=G_TOL)
    two_op = _synthesize(_port_g("stylegan-256", SG, False, sg_params), ws,
                         nz, lg, alpha)
    torch.testing.assert_close(got, two_op, rtol=G_TOL, atol=G_TOL)


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_stylegan_generator_bf16(sg_params, form):
    """The bf16 image under a form no further from the float32 two-op image
    than twice the bf16 two-op image is (ROADMAP C, precision)."""
    ws, nz = _sg_inputs(5, 4)
    two_op = _port_g("stylegan-256", SG, False, sg_params)
    want = _synthesize(two_op, ws, nz, 5, 1.0)
    bf16_two_op = _synthesize(two_op, ws, nz, 5, 1.0, torch.bfloat16)
    got = _synthesize(_port_g("stylegan-256", SG, form, sg_params), ws, nz,
                      5, 1.0, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for stat in (torch.amax, torch.mean):
        err = float(stat((got.float() - want).abs()))
        ref = float(stat((bf16_two_op.float() - want).abs()))
        assert err <= 2 * ref, (stat.__name__, err, ref)


@pytest.mark.parametrize("family", ["stylegan-256", "progan-128"])
def test_parameter_tree_is_the_same_under_every_form(family):
    """Every form keeps each conv0 weight (O, I, 3, 3): the state dicts
    match the two-op generator's name for name and shape for shape, and a
    seeded build gives the same values."""
    sets = SG if family == "stylegan-256" else PG
    forms = [False, True, "poly"] + (["hybrid"] if family[0] == "s" else [])
    trees = []
    for form in forms:
        torch.manual_seed(0)
        g = build_generator(get_config(family, **dict(
            sets, **{"model.fused_up_conv": form})).model)
        trees.append(g.state_dict())
    for tree in trees[1:]:
        assert list(tree) == list(trees[0])
        for k, v in tree.items():
            assert torch.equal(v, trees[0][k]), k


@pytest.fixture(scope="module")
def pg_params():
    return _flax_params("progan-128", PG, 1)


@pytest.mark.parametrize("lg,alpha", [(4, 1.0), (4, 0.4)],
                         ids=["16-stable", "16-fade"])
@pytest.mark.parametrize("form", FORMS[:2], ids=FORM_IDS[:2])
def test_progan_generator_matches_jax(pg_params, form, lg, alpha):
    """Values and parameter gradients (of a fixed cotangent) against the
    JAX G with the same form, values against the port's two-op G."""
    jg, _ = jax_build_models(jax_get_config("progan-128", **dict(
        PG, **{"model.fused_up_conv": form})).model)
    rs = np.random.RandomState(3)
    z = rs.randn(N, 16).astype(np.float32)
    ct = rs.randn(N, 2 ** lg, 2 ** lg, 3).astype(np.float32)
    ja = 1.0 if alpha == 1.0 else jnp.float32(alpha)

    @jax.jit
    def run(p):
        return jax.value_and_grad(lambda p: jnp.sum(
            jg.apply(p, jnp.asarray(z), lg, ja) * ct), has_aux=False)(p)[1], \
            jg.apply(p, jnp.asarray(z), lg, ja)

    grads, want = run(pg_params)
    want_g = from_flax(jax.tree_util.tree_map(np.asarray, grads))
    g = _port_g("progan-128", PG, form, pg_params).requires_grad_(True)
    got = g(torch.from_numpy(z), lg, alpha)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=G_TOL,
                               atol=G_TOL)
    two_op = _port_g("progan-128", PG, False, pg_params)
    torch.testing.assert_close(got.detach(), two_op(torch.from_numpy(z), lg,
                                                    alpha), rtol=G_TOL,
                               atol=G_TOL)
    (got * _nchw(ct)).sum().backward()
    for name, p in g.named_parameters():
        ref = want_g[name].numpy()
        if p.grad is None:              # a head of another resolution
            assert not ref.any(), name
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=STEP_REL * max(float(np.abs(ref).max()), 1e-12),
            err_msg=name)


def test_progan_hybrid_raises_as_in_jax():
    over = dict(PG, **{"model.fused_up_conv": "hybrid"})
    with pytest.raises(ValueError, match="hybrid") as got:
        build_models(get_config("progan-128", **over).model)
    jg, _ = jax_build_models(jax_get_config("progan-128", **over).model)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(jg.init_all, jax.random.PRNGKey(0))
    assert str(got.value) == str(want.value)
    # under fold_width every block of this G folds and ignores the form
    # (tests/test_torch_folded.py): 'hybrid' then raises in neither
    # package, and each form gives the folded G's images
    folded = dict(PG, **{"model.fold_width": True})
    jg, _ = jax_build_models(jax_get_config("progan-128", **dict(
        folded, **{"model.fused_up_conv": "hybrid"})).model)
    jax.eval_shape(jg.init_all, jax.random.PRNGKey(0))
    z = torch.from_numpy(np.random.RandomState(8).randn(N, 16).astype(
        np.float32))
    imgs = []
    for form in (False, True, "hybrid"):
        torch.manual_seed(0)
        g, _ = build_models(get_config("progan-128", **dict(
            folded, **{"model.fused_up_conv": form})).model)
        with torch.no_grad():
            imgs.append(g(z))
    assert all(torch.equal(imgs[0], img) for img in imgs[1:])


# -- the training step ------------------------------------------------------------

STEP = {"model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "schedule.progressive": False,
        "schedule.batch_schedule": {32: 2}}


def _step(form, sets, r1=True):
    cfg = get_config("stylegan-256", **dict(
        STEP, **sets, **{"model.fused_up_conv": form}))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():       # every term live: at init the 4x4 planes
        for net in (state.g, state.d):      # are constant, AdaIN's
            for k, v in net.state_dict().items():   # gradient rounding
                if k.endswith(("noise.scale", ".bias", ".b", "const")):
                    v += 0.2 * torch.randn(v.shape, generator=gen)
    before = {k: v.clone() for k, v in state.g.state_dict().items()}
    real = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (2, 32, 32, 3)).astype(np.uint8))
    state, metrics = tsteps.build_train_step(cfg, phase,
                                             penalty_override=r1)(state, real)
    grads = {f"{net}.{k}": p.grad.clone()
             for net in ("g", "d")
             for k, p in getattr(state, net).named_parameters()
             if p.grad is not None}
    return before, metrics, grads


@pytest.mark.parametrize("form,sets", [
    (True, {}), (True, {"model.remat": True}),
    (True, {"loss.fused_g_step": True}), ("poly", {}), ("hybrid", {}),
    ("hybrid", {"model.remat": True, "loss.fused_g_step": True})],
    ids=["dilated", "dilated-remat", "dilated-fused_g_step", "poly",
         "hybrid", "hybrid-remat-fused_g_step"])
def test_train_step_matches_two_op(form, sets):
    """One R1-on step from one seed under a form and under the two-op form:
    the same initial parameters, the same draws, losses within 1e-4
    relative and every gradient leaf within 1e-4 of its scale."""
    before, m, grads = _step(form, sets)
    before_ref, m_ref, grads_ref = _step(False, sets)
    for k, v in before.items():
        assert torch.equal(v, before_ref[k]), k
    for k, v in m.items():
        torch.testing.assert_close(v, m_ref[k], rtol=STEP_REL, atol=1e-6)
    assert grads.keys() == grads_ref.keys() and any(
        k.startswith("g.synthesis.block32.conv0") for k in grads)
    for k, v in grads.items():
        ref = grads_ref[k]
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((v - ref).abs().max()) <= STEP_REL * scale, k


PLAIN = {"upsample_blur_2x": "upsample_blur_2x_ref",
         "blur_downsample_2x": "blur_downsample_2x_ref"}


@pytest.fixture
def resample_calls(monkeypatch):
    seen = collections.Counter()
    for name, attr in PLAIN.items():
        def counted(*a, _f=getattr(resample, attr), _n=name, **k):
            seen[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(resample, attr, counted)
    return seen


@pytest.mark.parametrize("recipe", ["sequential", "fused_g_step"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
@pytest.mark.parametrize("form", [False] + FORMS,
                         ids=["two_op"] + FORM_IDS)
def test_step_resample_calls_match_the_derivation(resample_calls, form, r1,
                                                  remat, recipe):
    """The plain up+blur and blur+down calls of one step (the launches of
    the same step on the card) under each form against
    ``chip_smoke.step_launches``: per form, G's forward and backward."""
    cfg = get_config("stylegan-256", **dict(STEP, **{
        "model.fused_up_conv": form, "model.remat": remat,
        **({} if recipe == "sequential" else {f"loss.{recipe}": True})}))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    resample_calls.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = chip_smoke.launch_totals(chip_smoke.step_launches(
        cfg.model, r1, batch=2, recipe=recipe))
    assert dict(resample_calls) == {n: want[n] for n in PLAIN}


@pytest.mark.parametrize("form", FORMS[:2], ids=FORM_IDS[:2])
def test_progan_step_launches_are_the_two_op_ones(form):
    two_op = get_config("progan-128", **PG).model
    fused = get_config("progan-128", **dict(
        PG, **{"model.fused_up_conv": form})).model
    assert chip_smoke.step_launches(fused, True, batch=2) == \
        chip_smoke.step_launches(two_op, True, batch=2)
    with pytest.raises(ValueError, match="hybrid"):
        chip_smoke.progan_g_launches(get_config("progan-128", **dict(
            PG, **{"model.fused_up_conv": "hybrid"})).model)


# -- serving, export, the CLI -------------------------------------------------------

EXPORT = {"model.resolution": 16, "model.fmap_base": 128,
          "model.fmap_max": 16, "model.latent_dim": 16,
          "model.mapping_layers": 2, "run.compute_dtype": "float32"}


@pytest.mark.parametrize("form", FORMS[:2], ids=FORM_IDS[:2])
def test_exported_sampler_matches_batch_sampler(form, tmp_path):
    """Under each form the exported program holds the composed conv (a
    transposed conv; the polyphase form's four convs and interleave) and
    serves ``BatchSampler``'s bits; both equal the two-op sampler's images
    within one level."""
    cfg = get_config("stylegan-256", **dict(
        EXPORT, **{"model.fused_up_conv": form}))
    state = create_train_state(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for k, v in state.g_ema.state_dict().items():
            if k.endswith(("noise.scale", ".bias")):
                v += 0.3
    path = str(tmp_path / "sampler.ganlab.zip")
    export_sampler(cfg, state, path, batch_size=4, platforms=("cpu",))
    program = torch.export.load(_program_file(path, tmp_path))
    called = collections.Counter(str(n.target) for n in program.graph.nodes
                                 if n.op == "call_function")
    transposed = called["aten.conv_transpose2d.input"]
    if form == "poly":                                # 4 a block, 2 blocks
        assert not transposed and called["aten.conv2d.default"] >= 8
    else:
        assert transposed == 2                        # blocks 8 and 16
    assert "ganlab.upsample_blur_2x.default" not in called
    got = ExportedSampler(path, device="cpu").generate(6, seed=3)
    live = BatchSampler(cfg, state=state, batch_size=4, device="cpu")
    assert np.array_equal(got, live.generate(6, seed=3))
    two_op = BatchSampler(get_config("stylegan-256", **EXPORT), state=state,
                          batch_size=4, device="cpu").generate(6, seed=3)
    assert np.abs(got.astype(int) - two_op.astype(int)).max() <= 1


def _program_file(path, tmp_path):
    import zipfile

    with zipfile.ZipFile(path) as z:
        z.extract("sampler_cpu.pt2", tmp_path)
    return str(tmp_path / "sampler_cpu.pt2")


def test_cli_train_with_poly(tmp_path):
    """``--set model.fused_up_conv=poly`` parses to the string and trains:
    two steps of a narrow stylegan-256 through ``cli train``."""
    assert cli._parse_overrides(["model.fused_up_conv=poly"]) == \
        {"model.fused_up_conv": "poly"}
    wd = str(tmp_path / "run")
    args = ["train", "--preset", "stylegan-256", "--device", "cpu",
            "--workdir", wd, "--max-steps", "2"]
    for k, v in dict(EXPORT, **{
            "model.fused_up_conv": "poly", "data.dataset": "synthetic",
            "schedule.progressive": False,
            "schedule.batch_schedule": {16: 2},
            "run.chunk_steps": False, "run.log_every": 1}).items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    import json

    with open(f"{wd}/config.json") as f:
        assert json.load(f)["model"]["fused_up_conv"] == "poly"
    rows = [json.loads(line) for line in open(f"{wd}/train.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["g_loss"]) for r in rows)

"""``model.fold_width``: the width-folded ops and blocks of the port against
the JAX package, and through everything that builds the models.

On the CPU (JAX under ``highest`` matmul precision, from conftest), inputs
from numpy seeds, at the JAX test's sizes (``tests/test_folded.py``:
resolution 32, latent 16, ``fmap_base`` 128, ``fmap_max`` 16, mapping 2,
so every block folds) and in a mixed configuration where only the 16x16
and 32x32 blocks fold (``fmap_max`` 32, ``fold_max_channels`` 16):

* each function of ``ops/folded.py`` against the JAX one, the port's
  folded NCHW tensor being the JAX folded NHWC tensor transposed: values
  within 1e-5 of the scale, gradients of ``sum(tanh(.))`` against
  ``jax.grad`` within 3e-5 of the scale; the folded kernels transposed to
  OIHW; ``noise_folded`` given the field JAX draws from the same key;
* the folded ProGAN and StyleGAN G against the JAX folded G on converted
  parameters (the same tree as the JAX folded G's), at 8x8 with alpha 0.4
  and at 32x32, within 2e-4; a StyleGAN G with live noise against the JAX
  unfolded G given the same explicit noise maps (the JAX folded G takes
  only its own RNG; its own test holds the two equal); the folded D,
  values and parameter gradients within 5e-4;
* fold on against fold off inside the port: one training step's losses
  and gradients (also with remat, ``optim.grad_accum`` 2,
  ``model.fused_up_conv``, each step recipe, ADA and a ProGAN WGAN-GP
  step), the plain kernel calls of a step against
  ``chip_smoke.step_launches``, ``BatchSampler``, the exported sampler,
  the chunked stepper against the lazy one, two ``gloo`` ranks against
  one process accumulating two, ``cli train`` / ``cli sample``; every
  preset builds, steps and serves under fold; StyleGAN2, the residual D
  and ResNet-GAN ignore the option as the JAX package does; the
  projector refuses ``optimize_noise`` under a fold with the JAX
  package's message.

The card's tests of the fold are in ``test_torch_folded_card.py`` (no JAX
there).
"""

import collections
import json

import numpy as np
import pytest
import torch

import chip_smoke
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.export import ExportedSampler, export_sampler
from ganlab_tpu_torch.models import build_generator, build_models
from ganlab_tpu_torch.models.stylegan import noise_shapes
from ganlab_tpu_torch.ops import equalized_conv2d_folded
from ganlab_tpu_torch.ops import folded as fd
from ganlab_tpu_torch.ops.kernels import adain, mbstd, pixelnorm, resample
from ganlab_tpu_torch.serve import BatchSampler
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
from ganlab_tpu_torch.train.steps import make_chunked_stepper
from ganlab_tpu_torch.utils.projector import project

import jax
import jax.numpy as jnp

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.ops import equalized as jeq
from ganlab_tpu.ops import folded as jfd
from tests.test_torch_chunked import (
    SCENARIOS,
    assert_bitwise,
    batches,
    lazy_over,
    tiny_config,
)
from tests.test_torch_train_step import perturb, to_flax

torch.set_num_threads(1)

TOL = 1e-5                                     # an op's values, of scale
GRAD_TOL = 3e-5                                # its gradients, of scale
G_TOL = 2e-4                                   # generators
D_TOL = 5e-4                                   # discriminators
STEP_REL = 1e-4                                # a step's leaves, of scale
REG_REL = 1e-3                                 # R1's own leaves, of scale

MODEL = {"model.resolution": 32, "model.latent_dim": 16,
         "model.fmap_base": 128, "model.fmap_max": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32",
         "model.fold_width": True}
CFGS = {"all": MODEL,                          # every block folds
        "mixed": dict(MODEL, **{"model.fmap_max": 32,   # 16², 32² fold
                                "model.fold_max_channels": 16})}
PRESETS = {"progan": "progan-128", "stylegan": "stylegan-256"}
N = 2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed + sum(shape)).randn(*shape).astype(
        np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _both(port_fn, jax_fn, args, nchw_out=True):
    """Values and the gradients of sum(tanh(.)) of a port op and its JAX
    counterpart on the same numpy inputs; ``args``: (array, is_nhwc)."""
    tens = [(_nchw(a) if nhwc else torch.from_numpy(a)).requires_grad_(True)
            for a, nhwc in args]
    y = port_fn(*tens)
    grads = torch.autograd.grad(torch.tanh(y).sum(), tens)

    @jax.jit
    def run(*xs):
        return (jax_fn(*xs),) + jax.grad(
            lambda *xs: jnp.sum(jnp.tanh(jax_fn(*xs))),
            tuple(range(len(xs))))(*xs)

    want = run(*[jnp.asarray(a) for a, _ in args])
    _close(_nhwc(y) if nchw_out else y.detach().numpy(), want[0], TOL)
    for (a, nhwc), g, jg in zip(args, grads, want[1:]):
        _close(_nhwc(g) if nhwc else g.numpy(), jg, GRAD_TOL)


# -- the ops ----------------------------------------------------------------------

def test_fold_w_is_the_jax_fold_transposed():
    x = _rand(2, 3, 6, 4)
    folded = fd.fold_w(_nchw(x))
    assert folded.shape == (2, 8, 3, 3)
    np.testing.assert_array_equal(_nhwc(folded),
                                  np.asarray(jfd.fold_w(jnp.asarray(x))))
    assert torch.equal(fd.unfold_w(folded), _nchw(x))


@pytest.mark.parametrize("kernel", [1, 3])
def test_folded_kernels_match_jax(kernel):
    """The folded kernel of a logical weight, OIHW, against the JAX HWIO
    one transposed; bit for bit (it only moves values)."""
    w = _rand(kernel, kernel, 4, 6)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if kernel == 1:
        got = fd.fold_conv1x1_kernel(w_oihw)
        want = jfd.fold_conv1x1_kernel(jnp.asarray(w))
    else:
        got = fd.fold_conv_kernel(w_oihw)
        want = jfd.fold_conv_kernel(jnp.asarray(w))
    assert got.shape == (12, 8, kernel, kernel)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(want))


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv2d_folded_matches_jax(kernel):
    x = _rand(2, 6, 8, 8)                              # folded, 2 x 4 ch
    w = _rand(6, 4, kernel, kernel, seed=1)            # OIHW, logical
    _both(fd.conv2d_folded,
          lambda a, b: jfd.conv2d_folded(a, b.transpose(2, 3, 1, 0)),
          [(x, True), (w, False)])


def test_equalized_conv2d_folded_matches_jax():
    x, w, b = _rand(2, 5, 4, 6), _rand(3, 3, 3, 5, seed=2), _rand(5, seed=3)
    _both(lambda a, c, d: equalized_conv2d_folded(
              a, c.permute(3, 2, 0, 1), d, lr_mult=0.5),
          lambda a, c, d: jeq.equalized_conv2d_folded(a, c, d, lr_mult=0.5),
          [(x, True), (w, False), (b, False)])


def test_bias_folded_matches_jax():
    _both(fd.bias_folded, jfd.bias_folded,
          [(_rand(2, 3, 4, 6), True), (_rand(3, seed=4), False)])


def test_pixel_norm_folded_matches_jax():
    _both(fd.pixel_norm_folded, jfd.pixel_norm_folded,
          [(_rand(2, 4, 3, 8), True)])


def test_adain_folded_matches_jax():
    _both(fd.adain_folded, jfd.adain_folded,
          [(_rand(2, 4, 3, 8), True), (_rand(2, 4, seed=5), False),
           (_rand(2, 4, seed=6), False)])


def test_noise_folded_matches_jax():
    """Given the logical field the JAX op draws from its key, the port's
    ``noise_folded`` adds it as the JAX op does."""
    x, scale = _rand(2, 3, 4, 6), _rand(3, seed=7)
    key = jax.random.PRNGKey(8)
    field = _nchw(np.array(jax.random.normal(key, (2, 3, 8, 1),
                                             jnp.float32)))
    _both(lambda a, s: fd.noise_folded(a, s, field),
          lambda a, s: jfd.noise_folded(a, s, key),
          [(x, True), (scale, False)])


@pytest.mark.parametrize("blur", [True, False], ids=["blur", "nearest"])
def test_upsample_folded_matches_jax(blur):
    _both(lambda a: fd.upsample_blur_2x_folded(a, blur),
          lambda a: jfd.upsample_blur_2x_folded(a, blur),
          [(_rand(2, 5, 6, 3), True)])


@pytest.mark.parametrize("blur", [True, False], ids=["blur", "nearest"])
def test_downsample_folded_matches_jax(blur):
    _both(lambda a: fd.blur_downsample_2x_folded(a, blur),
          lambda a: jfd.blur_downsample_2x_folded(a, blur),
          [(_rand(2, 8, 5, 6), True)])


# -- the models -------------------------------------------------------------------

def _jax_models(model, cfg_id, fold=True):
    return jax_build_models(jax_get_config(PRESETS[model], **dict(
        CFGS[cfg_id], **{"model.fold_width": fold})).model)


def _port_models(model, cfg_id, params_g=None, params_d=None, fold=True):
    g, d = build_models(get_config(PRESETS[model], **dict(
        CFGS[cfg_id], **{"model.fold_width": fold})).model)
    if params_g is not None:
        g.load_state_dict(from_flax(params_g))
    if params_d is not None:
        d.load_state_dict(from_flax(params_d))
    return g, d


@pytest.fixture(scope="module")
def flax_params():
    """model, cfg id -> (G tree, D tree): the port's seeded models made
    into flax trees and perturbed by numpy noise, each the tree of the JAX
    folded model (``jax.eval_shape`` of its ``init_all``); with
    ``zero_noise`` the StyleGAN noise scales zeroed (the JAX folded G draws
    its noise from its own RNG)."""
    out = {}
    for model in PRESETS:
        for cfg_id in CFGS:
            torch.manual_seed(0)
            g, d = _port_models(model, cfg_id)
            trees = [perturb(to_flax(m), seed=i) for i, m in enumerate((g, d))]
            for tree, jm in zip(trees, _jax_models(model, cfg_id)):
                shapes = jax.eval_shape(jm.init_all, jax.random.PRNGKey(0))
                assert jax.tree_util.tree_map(np.shape, tree) == \
                    jax.tree_util.tree_map(np.shape, shapes)
            out[model, cfg_id] = trees
    return out


def _zero_noise_scales(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if any(
            getattr(k, "key", None) == "noise" for k in path) else a, tree)


@pytest.mark.parametrize("lg,alpha", [(3, 0.4), (5, 1.0)],
                         ids=["8-fade", "32-stable"])
@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("model", list(PRESETS))
def test_folded_generator_matches_jax(flax_params, model, cfg_id, lg, alpha):
    """The port's folded G against the JAX folded G on one tree (its noise
    scales zeroed for StyleGAN), and against the port's unfolded G."""
    params = flax_params[model, cfg_id][0]
    if model == "stylegan":
        params = _zero_noise_scales(params)
    jg, _ = _jax_models(model, cfg_id)
    z = _rand(N, 16, seed=9)
    ja = 1.0 if alpha == 1.0 else jnp.float32(alpha)
    want = jax.jit(lambda p, z: jg.apply(
        p, z, res_log2=lg, alpha=ja, rngs={"noise": jax.random.PRNGKey(2)}))(
            params, jnp.asarray(z))
    got = _port_models(model, cfg_id, params)[0].eval()(
        torch.from_numpy(z), lg, alpha)
    _close(_nhwc(got), want, G_TOL)
    unfolded = _port_models(model, cfg_id, params, fold=False)[0].eval()
    torch.testing.assert_close(got, unfolded(torch.from_numpy(z), lg, alpha),
                               rtol=G_TOL, atol=G_TOL)


@pytest.mark.parametrize("lg,alpha", [(3, 0.4), (5, 1.0)],
                         ids=["8-fade", "32-stable"])
@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_folded_stylegan_with_noise_matches_jax_unfolded(flax_params, cfg_id,
                                                         lg, alpha):
    """Live noise scales and explicit logical noise maps: the port's folded
    synthesis against the JAX unfolded one given the same maps."""
    params = flax_params["stylegan", cfg_id][0]
    jg, _ = _jax_models("stylegan", cfg_id, fold=False)
    rs = np.random.RandomState(10)
    ws = rs.randn(N, 2 * (lg - 1), 16).astype(np.float32)
    nz = [rs.randn(N, h, w, 1).astype(np.float32) for h, w in
          noise_shapes(lg)]
    ja = 1.0 if alpha == 1.0 else jnp.float32(alpha)
    want = jax.jit(lambda p, ws, nz: jg.apply(
        p, ws, lg, ja, nz, method="synthesize"))(
            params, jnp.asarray(ws), [jnp.asarray(a) for a in nz])
    g = _port_models("stylegan", cfg_id, params)[0].eval()
    got = g.synthesize(torch.from_numpy(ws), lg, alpha,
                       [_nchw(a) for a in nz])
    _close(_nhwc(got), want, G_TOL)


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("model", list(PRESETS))
def test_folded_discriminator_matches_jax(flax_params, model, cfg_id):
    """Scores and parameter gradients (of a fixed cotangent) of the port's
    folded D against the JAX folded D at 32x32, within 5e-4 of the
    scale."""
    params = flax_params[model, cfg_id][1]
    _, jd = _jax_models(model, cfg_id)
    rs = np.random.RandomState(11)
    img = rs.randn(4, 32, 32, 3).astype(np.float32)
    ct = rs.randn(4).astype(np.float32)

    @jax.jit
    def run(p, x):
        return jax.value_and_grad(
            lambda p: jnp.sum(jd.apply(p, x, 5, 1.0) * ct))(p)[1], \
            jd.apply(p, x, 5, 1.0)

    grads, want = run(params, jnp.asarray(img))
    want_g = from_flax(jax.tree_util.tree_map(np.array, grads))
    d = _port_models(model, cfg_id, params_d=params)[1]
    got = d(_nchw(img), 5, 1.0)
    _close(got.detach().numpy(), want, D_TOL)
    (got * torch.from_numpy(ct)).sum().backward()
    for name, p in d.named_parameters():
        ref = want_g[name].numpy()
        if p.grad is None:                      # a head of another resolution
            assert not ref.any(), name
            continue
        _close(p.grad.numpy(), ref, D_TOL)


# -- fold on against fold off inside the port ------------------------------------

STEP = {"model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "schedule.progressive": False,
        "schedule.batch_schedule": {32: 2}}
MIXED_STEP = {"model.fold_width": True,       # only the 32x32 blocks fold
              "model.fold_max_channels": 4}


def _step(preset, sets, r1=True):
    cfg = get_config(preset, **dict(STEP, **sets))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():       # every term live: at init the biases, the
        for net in (state.g, state.d):      # noise scales are 0 and the
            for k, v in net.state_dict().items():   # 4x4 planes constant
                if k.endswith(("noise.scale", ".bias", ".b", "const")):
                    v += 0.2 * torch.randn(v.shape, generator=gen)
    real = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (2, 32, 32, 3)).astype(np.uint8))
    state, metrics = tsteps.build_train_step(cfg, phase,
                                             penalty_override=r1)(state, real)
    grads = {f"{net}.{k}": p.grad.clone()
             for net in ("g", "d")
             for k, p in getattr(state, net).named_parameters()
             if p.grad is not None}
    return metrics, grads


@pytest.mark.parametrize("preset,sets", [
    ("stylegan-256", {}), ("stylegan-256", {"model.remat": True}),
    ("stylegan-256", {"optim.grad_accum": 2}),
    ("stylegan-256", {"model.fused_up_conv": True}),
    ("stylegan-256", {"loss.fused_g_step": True}),
    # the reg pass runs at the D after the main update, whose Adam step
    # moves a parameter by ~lr x sign(g): lr 0 keeps rounding out of it
    ("stylegan-256", {"loss.reg_separate": True, "optim.lr_d": 0.0}),
    ("stylegan-256", {"loss.fused_seq": True}),
    ("stylegan-256", {"aug.mode": "ada", "aug.categories": "bcgfnu",
                      "aug.p_init": 0.5}),
    ("progan-128", {})],
    ids=["sequential", "remat", "grad_accum", "fused_up_conv",
         "fused_g_step", "reg_separate", "fused_seq", "ada", "progan"])
@pytest.mark.parametrize("fold", [{"model.fold_width": True}, MIXED_STEP],
                         ids=["all", "mixed"])
def test_train_step_matches_fold_off(preset, sets, fold):
    """One penalty step (R1; ProGAN's WGAN-GP) from one seed with fold on
    and off: the same draws, losses within 1e-4 relative and every
    gradient leaf within 1e-4 of its scale, or of a hundredth of its
    network's largest leaf scale where that is larger (a leaf that sums
    to far less than its terms, as the 4x4 style bias over two
    accumulated microbatches, keeps their rounding). Under
    ``loss.reg_separate`` D's gradients are R1's alone, a second-order
    term: 1e-3 of the scale there, as ``chip_smoke.py`` holds second-order
    steps card vs CPU. Under ``model.fused_up_conv`` the folded blocks
    ignore it, as in the JAX package."""
    rel = REG_REL if "loss.reg_separate" in sets else STEP_REL
    m, grads = _step(preset, dict(sets, **fold))
    m_ref, grads_ref = _step(preset, sets)
    for k, v in m.items():
        torch.testing.assert_close(v, m_ref[k], rtol=STEP_REL, atol=1e-6)
    assert grads.keys() == grads_ref.keys()
    net = {n: max(float(v.abs().max()) for k, v in grads_ref.items()
                  if k[0] == n) for n in "gd"}
    for k, v in grads.items():
        ref = grads_ref[k]
        scale = max(float(ref.abs().max()), 1e-2 * net[k[0]])
        assert float((v - ref).abs().max()) <= \
            (rel if k[0] == "d" else STEP_REL) * scale, k


PLAIN = {"pixelnorm": (pixelnorm, "pixel_norm_ref"),
         "adain": (adain, "adain_ref"),
         "upsample_blur_2x": (resample, "upsample_blur_2x_ref"),
         "blur_downsample_2x": (resample, "blur_downsample_2x_ref"),
         "minibatch_stddev": (mbstd, "minibatch_stddev_ref")}


@pytest.fixture
def counts(monkeypatch):
    seen = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        def counted(*a, _f=getattr(mod, attr), _n=name, **k):
            seen[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    return seen


@pytest.mark.parametrize("preset,sets,r1", [
    ("stylegan-256", {}, False), ("stylegan-256", {}, True),
    ("stylegan-256", {"model.remat": True}, True),
    ("stylegan-256", {"model.fused_up_conv": "hybrid"}, True),
    ("stylegan-256", {"loss.fused_g_step": True}, True),
    ("progan-128", {}, True)],
    ids=["r1_off", "r1_on", "remat", "hybrid", "fused_g_step", "progan"])
def test_step_kernel_calls_match_the_derivation(counts, preset, sets, r1):
    """The plain kernel calls of one mixed-fold step (the launches of the
    same step on the card) against ``chip_smoke.step_launches``: the folded
    32x32 blocks call none, the unfolded ones theirs."""
    recipe = "fused_g_step" if "loss.fused_g_step" in sets else "sequential"
    cfg = get_config(preset, **dict(STEP, **MIXED_STEP, **sets))
    assert [cfg.model.fold_block(lg) for lg in (3, 4, 5)] == \
        [False, False, True]
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    counts.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = chip_smoke.launch_totals(chip_smoke.step_launches(
        cfg.model, r1, batch=2, recipe=recipe))
    assert dict(counts) == {n: want[n] for n in PLAIN if want[n]}
    unfolded = chip_smoke.launch_totals(chip_smoke.step_launches(
        get_config(preset, **dict(STEP, **sets)).model, r1, batch=2,
        recipe=recipe))
    assert sum(want.values()) < sum(unfolded.values())


SERVE = {"model.resolution": 16, "model.fmap_base": 128,
         "model.fmap_max": 32, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}


def _live_state(cfg):
    state = create_train_state(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for k, v in state.g_ema.state_dict().items():
            if k.endswith(("noise.scale", ".bias")):
                v += 0.3
    return state


def test_batch_sampler_and_export_match_fold_off(counts, tmp_path):
    """``BatchSampler`` under fold serves the images of fold off (the same
    noise; within one level), launching no AdaIN or up+blur in its folded
    blocks; the exported folded sampler serves ``BatchSampler``'s bits."""
    cfg = get_config("stylegan-256", **dict(SERVE, **{
        "model.fold_width": True, "model.fold_max_channels": 16}))
    state = _live_state(cfg)
    live = BatchSampler(cfg, state=state, batch_size=4, device="cpu")
    counts.clear()
    got = live.generate(4, seed=3)
    want = chip_smoke.launch_totals(chip_smoke.serving_shapes(cfg.model,
                                                              batch=4))
    assert dict(counts) == {n: want[n] for n in PLAIN if want[n]}
    assert want["adain"] == 4 and want["upsample_blur_2x"] == 1
    off = BatchSampler(get_config("stylegan-256", **SERVE), state=state,
                       batch_size=4, device="cpu").generate(4, seed=3)
    diff = np.abs(got.astype(int) - off.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    path = str(tmp_path / "sampler.ganlab.zip")
    export_sampler(cfg, state, path, batch_size=4, platforms=("cpu",))
    exported = ExportedSampler(path, device="cpu").generate(6, seed=5)
    assert np.array_equal(exported, live.generate(6, seed=5))


DP_RANK = """
import sys
import torch
from ganlab_tpu_torch.parallel import dist as pdist
from tests import torch_dist_worker as W

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
pdist.initialize("gloo", device="cpu", rank=rank, world_size=2,
                 init_method=f"tcp://localhost:{port}")
try:
    result = W.part_steps(rank, 2, W.steps_cfg(**{"model.fold_width": True}))
finally:
    pdist.shutdown()
torch.save(result, f"{out}/rank{rank}.pt")
"""


def test_dp_under_fold_equals_accumulation(tmp_path):
    """Two ``gloo`` ranks under fold (every block folded) hold the state of
    one process accumulating their two shards, bit for bit, as
    ``tests/test_torch_dist.py`` holds it unfolded."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from tests import torch_dist_worker as W

    root = Path(__file__).resolve().parents[1]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_RANK, str(r), str(port), str(tmp_path)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
              for r in range(2))
    want = W.part_steps(0, 1, W.steps_cfg(**{"model.fold_width": True,
                                             "optim.grad_accum": 2}))
    for got in (r0, r1):
        assert got["tensors"].keys() == want["tensors"].keys()
        assert [k for k in want["tensors"]
                if not torch.equal(got["tensors"][k], want["tensors"][k])] \
            == []
        assert got["metrics"] == want["metrics"]


@pytest.mark.parametrize("scenario", ["aligned", "tail"])
def test_chunked_stepper_equals_lazy_under_fold(scenario):
    """``make_chunked_stepper`` under fold (every block folded) against the
    lazy stepper over the same batches, bit for bit, as
    ``tests/test_torch_chunked.py`` holds it unfolded."""
    cfg = tiny_config(**{"model.fold_width": True})
    assert cfg.model.fold_block(3) and cfg.model.fold_block(4)
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    initial, pieces, consumed = SCENARIOS[scenario]
    assert pieces == consumed
    data = torch.from_numpy(batches(sum(pieces)))
    state = create_train_state(cfg, seed=0, device="cpu")
    stepper, _ = make_chunked_stepper(cfg, phase, initial_step=initial)
    start = 0
    for n in pieces:
        state, _ = stepper(state, data[start:start + n])
        start += n
    ref, _ = lazy_over(cfg, phase, data, initial)
    assert_bitwise(ref, state)


@pytest.mark.parametrize("preset,sets", [
    ("stylegan2-256", {}), ("stylegan-256", {"model.d_resnet": True}),
    ("resnetgan-cifar10", {})], ids=["stylegan2", "resnet_d", "resnetgan"])
def test_ignored_where_jax_ignores_it(preset, sets):
    """StyleGAN2's G, the residual D and ResNet-GAN do not fold: under
    ``fold_width`` they build the same parameters and give the same bits
    (at fmap 16, where every block would fold). Beside the residual D,
    StyleGAN's G folds: its images are the unfolded G's to rounding."""
    small = {"model.resolution": 16, "model.fmap_base": 64,
             "model.fmap_max": 16, "model.latent_dim": 16,
             "model.mapping_layers": 2, "model.base_channels": 16,
             "run.compute_dtype": "float32", **sets}
    outs = []
    for fold in (False, True):
        cfg = get_config(preset, **dict(small, **{"model.fold_width": fold}))
        torch.manual_seed(0)
        g, d = build_models(cfg.model)
        z = torch.from_numpy(_rand(2, cfg.model.latent_dim, seed=12))
        real = torch.from_numpy(_rand(2, 3, 16, 16, seed=13))
        with torch.no_grad():
            img = g(z) if preset == "resnetgan-cifar10" else \
                g(z, generator=torch.Generator().manual_seed(1))
            outs.append((g.state_dict(), d.state_dict(), img, d(real)))
    (g0, d0, i0, s0), (g1, d1, i1, s1) = outs
    for a, b in ((g0, g1), (d0, d1)):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(s0, s1)
    if "model.d_resnet" in sets:
        torch.testing.assert_close(i0, i1, rtol=1e-4, atol=1e-4)
    else:
        assert torch.equal(i0, i1)


def test_resnet_dblock_under_fold_raises_as_in_jax():
    from ganlab_tpu_torch.models.progan import DBlock

    with pytest.raises(AssertionError, match="resnet DBlock"):
        DBlock(8, 8, 8, resnet=True, fold=True)


def test_projector_refuses_noise_optimization_under_fold():
    """JAX's folded blocks take no explicit noise maps, so its projector
    with ``optimize_noise`` fails in a folded block; the port refuses at
    the entry with the same message. Without it, or where no block of the
    projected resolution folds, the projection runs."""
    cfg = get_config("stylegan-256", **dict(SERVE, **{
        "model.fold_width": True, "model.fold_max_channels": 16}))
    g = build_generator(cfg.model).requires_grad_(False)
    target = torch.zeros(1, 3, 16, 16)
    w_avg = torch.zeros(16)
    with pytest.raises(AssertionError) as got:
        project(cfg, g, w_avg, target, num_steps=1, num_restarts=1,
                num_candidates=2, optimize_noise=True)
    jg, _ = jax_build_models(jax_get_config("stylegan-256", **dict(
        SERVE, **{"model.fold_width": True,
                  "model.fold_max_channels": 16})).model)
    params = jax.eval_shape(jg.init_all, jax.random.PRNGKey(0))
    ws = jnp.zeros((1, 6, 16))
    nz = [jnp.zeros((1, h, w, 1)) for h, w in noise_shapes(4)]
    with pytest.raises(AssertionError) as want:
        jax.eval_shape(lambda p: jg.apply(p, ws, 4, 1.0, nz,
                                          method="synthesize"), params)
    assert str(got.value) == str(want.value)
    for lg, noise in ((4, False), (3, True)):
        r = project(cfg, g, w_avg, target[..., :2 ** lg, :2 ** lg],
                    num_steps=1, num_restarts=1, num_candidates=2,
                    res_log2=lg, optimize_noise=noise)
        assert torch.isfinite(r.losses).all()


def test_cli_train_and_sample_with_fold(tmp_path):
    """``--set model.fold_width=True`` through ``cli train`` (two steps of
    a narrow stylegan-256, its 16x16 block folded) and ``cli sample``."""
    wd = str(tmp_path / "run")
    args = ["train", "--preset", "stylegan-256", "--device", "cpu",
            "--workdir", wd, "--max-steps", "2"]
    for k, v in dict(SERVE, **{
            "model.fold_width": True, "model.fold_max_channels": 16,
            "data.dataset": "synthetic", "schedule.progressive": False,
            "schedule.batch_schedule": {16: 2},
            "run.chunk_steps": False, "run.log_every": 1}).items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    with open(f"{wd}/config.json") as f:
        assert json.load(f)["model"]["fold_width"] is True
    rows = [json.loads(line) for line in open(f"{wd}/train.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["g_loss"]) for r in rows)
    out = str(tmp_path / "grid.png")
    assert cli.main(["sample", "--workdir", wd, "--device", "cpu",
                     "--num", "4", "--out", out]) == 0
    assert (tmp_path / "grid.png").stat().st_size > 0


PRESET_SETS = {
    "stylegan-256": SERVE, "stylegan-1024": SERVE, "stylegan2-256": SERVE,
    "progan-64": {"model.resolution": 16, "model.fmap_base": 64,
                  "model.latent_dim": 16, "run.compute_dtype": "float32"},
    "progan-128": {"model.resolution": 16, "model.fmap_base": 64,
                   "model.latent_dim": 16, "run.compute_dtype": "float32"},
    "resnetgan-cifar10": {"model.base_channels": 16,
                          "run.compute_dtype": "float32"}}


@pytest.mark.parametrize("preset", list(PRESET_SETS))
def test_every_preset_trains_and_serves_under_fold(preset, tmp_path):
    """Under ``--set model.fold_width=True`` each preset builds, takes a
    training step and serves, folding the blocks ``cfg.fold_block``
    selects where the JAX package does; ProGAN's folded G also exports
    (``BatchSampler``'s bits)."""
    cfg = get_config(preset, **dict(PRESET_SETS[preset], **{
        "model.fold_width": True, "schedule.progressive": False,
        "run.chunk_steps": False}))
    mc = cfg.model
    phase = build_phases(cfg.schedule, mc)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    g = state.g.synthesis if hasattr(state.g, "synthesis") else state.g
    folds = [getattr(getattr(g, f"block{2 ** lg}", None), "fold", False)
             for lg in range(3, phase.res_log2 + 1)]
    if mc.model in ("stylegan", "progan"):
        assert folds == [mc.fold_block(lg)
                         for lg in range(3, phase.res_log2 + 1)]
        assert any(folds)
    else:
        assert not any(folds)
    real = torch.from_numpy(np.random.RandomState(14).randint(
        0, 256, (phase.batch_size, phase.resolution, phase.resolution, 3))
        .astype(np.uint8))
    state, m = tsteps.make_lazy_stepper(cfg, phase)(state, real)
    assert all(np.isfinite(float(v)) for v in m.values())
    live = BatchSampler(cfg, state=state, batch_size=2, device="cpu")
    imgs = live.generate(3, seed=1)
    assert imgs.shape == (3, phase.resolution, phase.resolution, 3)
    if preset == "progan-128":
        path = str(tmp_path / "sampler.ganlab.zip")
        export_sampler(cfg, state, path, batch_size=2, platforms=("cpu",))
        assert np.array_equal(
            ExportedSampler(path, device="cpu").generate(3, seed=1), imgs)

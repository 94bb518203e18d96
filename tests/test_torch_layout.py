"""The channels-last layout contract (``ops/layout.py``) on the CPU.

* The resample Functions on a channels-last input return channels-last
  results bit-equal to the NCHW call, at gains 1, 4 and 0.25, forward and
  backward; ``gradcheck`` and ``gradgradcheck`` in float64.
* ``conv_grad``'s three passes, ``equalized_conv2d`` and
  ``modulated_conv2d`` keep their activation's layout and match the NCHW
  call within float32 tolerance, an R1-shaped double backward included;
  an NCHW activation stays NCHW beside a channels-last weight.
* The StyleGAN2 synthesis and the ProGAN-family D (average-pool, blur
  and residual blocks, mbstd over the whole batch and in groups) run
  channels-last: the same images and scores, R1's and path length's
  gradients as with their ``to_channels_last`` made the identity (NCHW
  throughout), every conv call channels-last; the D's gradient with
  respect to an NCHW image comes back NCHW. A width-folded D block still
  matches.
* An NCHW input takes NCHW everywhere: ``to_channels_last`` leaves a
  channels-last tensor as it is, and StyleGAN's NCHW G calls every conv
  NCHW beside its channels-last D.
* Every resample call of a StyleGAN2 step with R1 and path length, and
  of its served batch, is channels-last: ``chip_smoke.py`` times them all
  on the NHWC paths.
* Path length's projection given as the image's output gradient is the
  gradient of ``sum(img.float() * y)``, bit for bit.
"""

import collections

import pytest
import torch

import chip_smoke
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.models import build_models, progan, stylegan2
from ganlab_tpu_torch.ops import conv_grad, equalized, layout, modulated
from ganlab_tpu_torch.ops.kernels import resample
from ganlab_tpu_torch.ops.kernels.resample import (
    BlurDownsample2x,
    UpsampleBlur2x,
)
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps

CL = torch.channels_last
F64 = torch.float64
TOL = 1e-5

SMALL = {"model.resolution": 16, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}
B, LG = 4, 4


def _randn(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _cl(x):
    return x.contiguous(memory_format=CL)


def _close(got, want, what="", floor=1e-12):
    """Within TOL of want's scale, or of ``floor`` where that is larger: a
    leaf near zero beside large ones carries float32 rounding of the
    large terms it cancels, which depends on the summation order (the
    CPU's thread count), not on the layout."""
    if want is None:
        assert got is None, what
        return
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), floor)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def _perturb(module, seed):
    """Every parameter moved off its init, so that zero-initialised noise
    scales and biases take part."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    return module


@pytest.fixture
def calls():
    """conv_grad.conv2d's calls by layout during a test."""
    before = dict(conv_grad.conv2d.calls)
    yield lambda: {k: conv_grad.conv2d.calls[k] - before[k]
                   for k in before}


# -- the resample Functions -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gain", [1.0, 4.0, 0.25])
@pytest.mark.parametrize("fn", [UpsampleBlur2x, BlurDownsample2x],
                         ids=["up", "down"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 4), (2, 3, 4, 6)],
                         ids=["c8", "c3"])
def test_resample_channels_last_is_bit_equal(fn, gain, shape, dtype):
    x = _randn(shape, dtype, 1).requires_grad_()
    xc = _cl(x.detach()).requires_grad_()
    want, got = fn.apply(x, gain), fn.apply(xc, gain)
    assert want.is_contiguous() and layout.is_channels_last(got)
    assert torch.equal(got, want)
    g = _randn(want.shape, dtype, 2)
    (gx,) = torch.autograd.grad(want, x, g)
    (gxc,) = torch.autograd.grad(got, xc, _cl(g))
    assert gx.is_contiguous() and layout.is_channels_last(gxc)
    assert torch.equal(gxc, gx)


@pytest.mark.parametrize("fn", [UpsampleBlur2x, BlurDownsample2x],
                         ids=["up", "down"])
def test_resample_channels_last_gradgradcheck(fn):
    x = _cl(_randn((2, 3, 4, 4), F64, 3)).requires_grad_()

    def f(x):
        return fn.apply(x, 0.5)

    assert layout.is_channels_last(f(x))
    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))


# -- the conv passes and the conv ops ---------------------------------------

@pytest.mark.parametrize("k", [3, 1])
def test_conv_passes_keep_the_layout(k, calls):
    pad = (k // 2, k // 2)
    x, w = _randn((3, 8, 6, 5), seed=4), _randn((5, 8, k, k), seed=5)
    g = _randn((3, 5, 6, 5), seed=6)
    passes = {
        "fprop": lambda x, w, g: conv_grad.conv2d(x, w, pad),
        "dgrad": lambda x, w, g: conv_grad._dgrad_op(g, w, x.shape, pad),
        "wgrad": lambda x, w, g: conv_grad._wgrad_op(g, x, w.shape, pad)}
    for name, f in passes.items():
        want = f(x, w, g)
        # an NCHW weight beside channels-last activations, and the reverse
        got = f(_cl(x), w, _cl(g))
        back = f(x, _cl(w), g)
        if name != "wgrad":
            assert layout.is_channels_last(got), name
            assert back.is_contiguous(), name
        _close(got, want, name)
        _close(back, want, name)
    assert calls() == {"nchw": 2, "channels_last": 1}


def _r1_shaped(x, w1, w2, b1):
    """Two equalized convs (3x3, 1x1): y, dy/dx and the weights' gradient
    of |dy/dx|^2."""
    x = x.detach().requires_grad_()
    y = equalized.equalized_conv2d(
        equalized.leaky_relu(equalized.equalized_conv2d(x, w1, b1)), w2)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    return [y, gx, *torch.autograd.grad(gx.square().sum(), [w1, w2, b1])]


def test_equalized_conv_keeps_the_layout_to_second_order(calls):
    ps = [_randn(s, seed=i).requires_grad_() for i, s in enumerate(
        [(5, 4, 3, 3), (6, 5, 1, 1), (5,)])]
    x = _randn((3, 4, 8, 8), seed=7)
    want = _r1_shaped(x, *ps)
    before = calls()
    got = _r1_shaped(_cl(x), *ps)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        _close(a, b, i)
    assert layout.is_channels_last(got[0]) and layout.is_channels_last(
        got[1])
    assert want[0].is_contiguous() and want[1].is_contiguous()
    moved = {k: calls()[k] - before[k] for k in before}
    assert moved["nchw"] == 0 and moved["channels_last"] > 0


@pytest.mark.parametrize("demod", [True, False], ids=["demod", "no_demod"])
def test_modulated_conv_keeps_the_layout(demod):
    w = _randn((6, 4, 3, 3), seed=8).requires_grad_()
    s = _randn((3, 4), seed=9).requires_grad_()

    def run(x):
        x = x.detach().requires_grad_()
        y = modulated.modulated_conv2d(x, w, s, demodulate=demod)
        return [y, *torch.autograd.grad(y.square().sum(), [x, w, s])]

    x = _randn((3, 4, 7, 5), seed=10)
    want, got = run(x), run(_cl(x))
    assert layout.is_channels_last(got[0]) and layout.is_channels_last(
        got[1])
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        _close(a, b, i)


# -- the models --------------------------------------------------------------

def _nchw(monkeypatch, module):
    """The module's models NCHW throughout: the reference."""
    monkeypatch.setattr(module, "to_channels_last", lambda x: x)


def _sg2():
    cfg = get_config("stylegan2-256", **SMALL,
                     **{"model.mbstd_group_size": None})
    g, d = build_models(cfg.model)
    return _perturb(g, 0), _perturb(d, 1)


def _pl(g, z, noises, y):
    """Path length's penalty and G's gradients of it."""
    dr = tsteps.PLDraws(z=z, noises=noises, y=y)
    pen, _, _ = tsteps.path_length_penalty(
        g, torch.zeros(()), dr, LG, 1.0, weight=2.0, decay=0.01)
    # (the toRGB biases do not reach the styles' gradient)
    return [pen, *torch.autograd.grad(pen, list(g.parameters()),
                                      allow_unused=True)]


def test_stylegan2_g_channels_last_matches_nchw(monkeypatch, calls):
    g, _ = _sg2()
    z = _randn((B, 16), seed=11)
    noises = [_randn((B, 1, h, w), seed=20 + i)
              for i, (h, w) in enumerate(stylegan2.noise_shapes(LG))]
    y = _randn((B, 3, 16, 16), seed=12)
    ws = g.map_latents(z)[:, None].repeat(1, 2 * (LG - 1), 1).detach()
    got_img = g.synthesize(ws, LG, 1.0, noises)
    assert layout.is_channels_last(got_img)
    got = _pl(g, z, noises, y)
    assert calls()["nchw"] == 0           # every conv, channels-last
    _nchw(monkeypatch, stylegan2)
    want_img = g.synthesize(ws, LG, 1.0, noises)
    want = _pl(g, z, noises, y)
    assert want_img.is_contiguous() and calls()["nchw"] > 0
    _close(got_img, want_img, "image")
    floor = 0.1 * max(float(t.abs().max()) for t in want[1:]
                       if t is not None)
    for (name, _), a, b in zip([("penalty", 0), *g.named_parameters()],
                               got, want, strict=True):
        _close(a, b, name, floor)


def test_path_length_projection_is_the_output_gradient():
    g, _ = _sg2()
    z = _randn((B, 16), seed=13)
    noises = [_randn((B, 1, h, w), seed=30 + i)
              for i, (h, w) in enumerate(stylegan2.noise_shapes(LG))]
    y = _randn((B, 3, 16, 16), seed=14)
    ws = g.map_latents(z)[:, None].repeat(1, 2 * (LG - 1), 1)
    img = g.synthesize(ws, LG, 1.0, noises)
    (want,) = torch.autograd.grad((img.float() * y).sum(), ws,
                                  retain_graph=True)
    (got,) = torch.autograd.grad(img, ws, grad_outputs=y.to(img.dtype))
    assert torch.equal(got, want)


def _d_case(case):
    preset, mbstd = case
    cfg = get_config(preset, **SMALL, **{"model.mbstd_group_size": mbstd})
    _, d = build_models(cfg.model)
    return _perturb(d, 2)


def _r1(d, img):
    """Scores, d/dimage with its graph, and the parameters' gradient of
    R1's |d/dimage|^2."""
    img = img.detach().requires_grad_()
    scores = d(img, LG, 1.0)
    (gi,) = torch.autograd.grad(scores.sum(), img, create_graph=True)
    # (the heads of the lower resolutions take no part)
    return [scores, gi, *torch.autograd.grad(
        gi.square().sum(), list(d.parameters()), allow_unused=True)]


D_CASES = [("stylegan2-256", None), ("stylegan-256", None),
           ("stylegan-256", 2), ("progan-128", None)]


@pytest.mark.parametrize("case", D_CASES,
                         ids=["residual", "blur", "blur_mbstd2", "avg_pool"])
def test_d_channels_last_matches_nchw(case, monkeypatch, calls):
    d = _d_case(case)
    assert d.block16.blur == (case[0] != "progan-128")
    assert d.block16.resnet == (case[0] == "stylegan2-256")
    img = _randn((B, 3, 16, 16), seed=15)
    got = _r1(d, img)
    # the 4x4 block's conv too: mbstd's result goes back to channels-last
    assert calls()["nchw"] == 0 and calls()["channels_last"] > 0
    # the image's gradient comes back in the image's layout (NCHW)
    assert got[1].is_contiguous()
    _nchw(monkeypatch, progan)
    want = _r1(d, img)
    assert calls()["nchw"] > 0
    names = ["scores", "d/dimage"] + [n for n, _ in d.named_parameters()]
    floor = 0.1 * max(float(t.abs().max()) for t in want[2:]
                       if t is not None)
    for name, a, b in zip(names, got, want, strict=True):
        _close(a, b, name, floor)


def test_folded_d_block_matches_channels_last_input():
    cfg = get_config("stylegan-256", **SMALL, **{
        "model.fold_width": True, "model.mbstd_group_size": None})
    _, d = build_models(cfg.model)
    d = _perturb(d, 3)
    assert d.block16.fold
    x = _randn((B, 16, 16, 16), seed=16)
    want = d.block16(x)
    got = d.block16(_cl(x))
    _close(got, want, "folded block")


def test_nchw_input_stays_nchw(calls):
    xc = _cl(_randn((2, 8, 4, 4)))
    assert layout.to_channels_last(xc) is xc
    cfg = get_config("stylegan-256", **SMALL,
                     **{"model.mbstd_group_size": None})
    g, d = build_models(cfg.model)
    z = _randn((B, 16), seed=17)
    img = g(z, LG, 1.0)
    assert img.is_contiguous() and calls()["channels_last"] == 0
    g_calls = calls()["nchw"]
    out = _r1(d, img)
    assert g_calls > 0 and calls()["nchw"] == g_calls
    assert out[1].is_contiguous()


def test_to_channels_last_returns_the_gradient_in_the_source_layout():
    c = _randn((2, 8, 4, 4), seed=19)

    def grads(x, convert):
        x = x.detach().requires_grad_()
        y = convert(x)
        (gx,) = torch.autograd.grad((y.square() * c).sum(), x,
                                    create_graph=True)
        # R1's double backward runs through the copy's backward
        (gg,) = torch.autograd.grad((gx.square() * c).sum(), x)
        return y, gx, gg

    x = _randn((2, 8, 4, 4), seed=18)
    y, gx, gg = grads(x, layout.to_channels_last)
    _, want_gx, want_gg = grads(x, lambda t: t)
    assert layout.is_channels_last(y) and gx.is_contiguous()
    assert torch.equal(gx, want_gx) and torch.equal(gg, want_gg)


def test_stylegan2_resample_calls_run_channels_last(monkeypatch):
    seen = collections.Counter()

    def plain(ref, x, gain, _f=resample._plain):
        # (the resample ops' CPU version: the plain version on x's values)
        seen[ref.__name__.removesuffix("_ref"),
             layout.is_channels_last(x)] += 1
        return _f(ref, x, gain)
    monkeypatch.setattr(resample, "_plain", plain)
    cfg = get_config("stylegan2-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "schedule.batch_schedule": {32: 4}})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=True,
                                   pl_override=True)
    step(state, torch.zeros(4, 32, 32, 3, dtype=torch.uint8))
    with torch.inference_mode():
        build_sample_fn(cfg, 5)(state.g_ema, state.w_avg, torch.zeros(3, 8))
    want = chip_smoke.launch_totals(chip_smoke.stylegan2_step_launches(
        cfg.model, True, True, batch=4, pl_batch=2))
    served = chip_smoke.launch_totals(
        chip_smoke.stylegan2_serving_launches(cfg.model, batch=3))
    assert dict(seen) == {(n, True): want[n] + served[n]
                          for n in chip_smoke.RESAMPLE_PATHS}

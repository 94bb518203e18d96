"""The launch counts ``chip_smoke.py`` derives per training step and per
projection hold.

On the card every call of a kernel's autograd Function launches the
kernel once; on the CPU the same call runs the plain version. So counting
the plain versions' calls in one step of a small model on the CPU counts
the launches the same step makes on the card, recomputes of
``model.remat`` included. ``chip_smoke.step_launches`` must derive those
counts from the config alone, with and without remat, R1 on and off;
``chip_smoke.projector_shapes`` the shapes and counts of a W+ projection,
which its kernel phase checks and times. The same for each opt-in step
recipe (``loss.reg_separate``, ``loss.fused_seq``, ``loss.fused_g_step``)
of stylegan-256 and progan-128. ``step_launches(..., channels_last=True)``
counts the resample calls on channels-last memory, the D's (the G's run
NCHW), which the kernel phase times on the NHWC paths.
"""

import collections

import pytest
import torch

import chip_smoke
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.models import build_generator
from ganlab_tpu_torch.ops.kernels import adain, mbstd, pixelnorm, resample
from ganlab_tpu_torch.ops.layout import is_channels_last
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
from ganlab_tpu_torch.utils.projector import project

torch.set_num_threads(1)

PLAIN = {"pixelnorm": (pixelnorm, "pixel_norm_ref"),
         "adain": (adain, "adain_ref"),
         "upsample_blur_2x": (resample, "upsample_blur_2x_ref"),
         "blur_downsample_2x": (resample, "blur_downsample_2x_ref"),
         "minibatch_stddev": (mbstd, "minibatch_stddev_ref")}


@pytest.fixture
def counts(monkeypatch):
    seen = collections.Counter()
    seen.nhwc = collections.Counter()    # the resample calls channels-last
    for name, (mod, attr) in PLAIN.items():
        def counted(*a, _f=getattr(mod, attr), _n=name, **k):
            seen[_n] += 1
            return _f(*a, **k)
        counted.kernel = name
        monkeypatch.setattr(mod, attr, counted)

    def plain(ref, x, gain, _f=resample._plain):
        # (the resample ops' CPU version: the plain version on x's values)
        if is_channels_last(x):
            seen.nhwc[ref.kernel] += 1
        return _f(ref, x, gain)
    monkeypatch.setattr(resample, "_plain", plain)
    return seen


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_step_launches_match_a_counted_step(counts, remat, r1):
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "model.remat": remat,
        "schedule.progressive": False, "schedule.batch_schedule": {32: 2}})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    counts.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = {n: sum(v.values()) for n, v in chip_smoke.step_launches(
        cfg.model, r1, batch=2).items()}
    assert dict(counts) == want


@pytest.mark.parametrize("recipe", ["reg_separate", "fused_seq",
                                    "fused_g_step"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_recipe_step_launches_match_a_counted_step(counts, remat, r1,
                                                   recipe):
    """Each opt-in recipe's step, counted as the sequential one, against
    ``step_launches(..., recipe=)``; ``fused_seq`` one G forward below the
    sequential step's count."""
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "model.remat": remat,
        "schedule.progressive": False, "schedule.batch_schedule": {32: 2},
        f"loss.{recipe}": True})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    counts.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = {n: sum(v.values()) for n, v in chip_smoke.step_launches(
        cfg.model, r1, batch=2, recipe=recipe).items()}
    assert dict(counts) == want
    if recipe == "fused_seq":
        seq = chip_smoke.step_launches(cfg.model, r1, batch=2)
        g_fwd = {"pixelnorm": 1, "adain": 2 * 4, "upsample_blur_2x": 3}
        assert {n: sum(v.values()) - want.get(n, 0) for n, v in
                seq.items()} == dict(g_fwd, blur_downsample_2x=0,
                                     minibatch_stddev=0)


@pytest.mark.parametrize("recipe", ["sequential", "fused_g_step"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_channels_last_step_launches_match_a_counted_step(counts, r1,
                                                          recipe):
    """The resample calls of a step (with remat) that run channels-last,
    the D's, against ``step_launches(..., channels_last=True)``."""
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "model.remat": True,
        "schedule.progressive": False, "schedule.batch_schedule": {32: 2},
        **({} if recipe == "sequential" else {f"loss.{recipe}": True})})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    counts.clear()
    counts.nhwc.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = {n: sum(v.values()) for n, v in chip_smoke.step_launches(
        cfg.model, r1, batch=2, recipe=recipe, channels_last=True).items()}
    assert dict(counts.nhwc) == want
    assert all(0 < want[n] < counts[n] for n in chip_smoke.RESAMPLE_PATHS)


@pytest.mark.parametrize("recipe", chip_smoke.RECIPES)
def test_progan_recipe_step_launches_match_a_counted_step(counts, recipe):
    """progan-128's WGAN-GP step (every step) under each recipe against
    ``progan_step_launches``: pixelnorm (rows and over NCHW) and mbstd."""
    cfg = get_config("progan-128", **{
        "model.resolution": 16, "model.fmap_base": 64,
        "model.latent_dim": 16, "run.compute_dtype": "float32",
        "schedule.progressive": False, "schedule.batch_schedule": {16: 2},
        **({} if recipe == "sequential" else {f"loss.{recipe}": True})})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase)
    counts.clear()
    step(state, torch.zeros(2, 16, 16, 3, dtype=torch.uint8))
    want = chip_smoke.step_launches(cfg.model, True, batch=2, recipe=recipe)
    assert dict(counts) == {n: sum(v.values()) for n, v in want.items()
                            if n != "pixelnorm_nchw"}


@pytest.fixture
def shapes(monkeypatch):
    seen = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        def counted(x, *a, _f=getattr(mod, attr), _n=name, **k):
            seen[_n, tuple(x.shape)] += 1
            return _f(x, *a, **k)
        monkeypatch.setattr(mod, attr, counted)
    return seen


def test_projector_shapes_match_a_counted_projection(shapes):
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32"})
    g = build_generator(cfg.model).requires_grad_(False)
    target = torch.zeros(1, 3, 32, 32)
    shapes.clear()
    project(cfg, g, torch.zeros(8), target, num_steps=3, num_restarts=2,
            num_candidates=5)
    want = {(n, s): c for n, by_shape in chip_smoke.projector_shapes(
        cfg.model, 3, restarts=2, pool=5).items()
        for s, c in by_shape.items()}
    assert dict(shapes) == want

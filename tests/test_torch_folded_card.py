"""``model.fold_width`` on a card.

Here on the CPU every test skips. On a CUDA card (``-m gpu``; the file
imports no JAX, so it runs on a host that has only PyTorch)::

    python -m pytest --noconftest tests/test_torch_folded_card.py -m gpu

in float32 with TF32 off: each folded op against its logical op on CUDA
tensors (the logical up+blur, blur+down, AdaIN and pixelnorm are the
kernels), within 1e-5 of the reference's scale (the folded conv, which
sums in another order, within 1e-4); the folded StyleGAN and ProGAN G and
D against the unfolded ones on the same parameters and noise, within
2e-4; the kernels' launches of one training step of a narrow
``stylegan-256`` whose 32x32 blocks fold against
``chip_smoke.step_launches``; and ``make_chunked_stepper`` under fold, its
off-runs replayed as CUDA graphs, bit for bit against the lazy stepper
(``tests/test_torch_graphs.py``'s check).
"""

import pytest
import torch

import chip_smoke
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.ops import (
    adain,
    blur_downsample_2x,
    downsample_avg_2x,
    equalized_conv2d,
    pixel_norm,
    upsample_blur_2x,
    upsample_nearest_2x,
)
from ganlab_tpu_torch.ops import folded as fd
from ganlab_tpu_torch.ops.equalized import equalized_conv2d_folded
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps
# pytest puts this directory on sys.path (the tests are no package)
import test_torch_graphs as graphs

REL = 1e-5
CONV_REL = 1e-4
MODEL_REL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.gpu
def test_card_folded_ops_match_the_logical_ops(card):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(4, 64, 32, 48, device=card, generator=g)
    w = torch.randn(32, 64, 3, 3, device=card, generator=g)
    b = torch.randn(32, device=card, generator=g)
    ys, yb = (torch.randn(4, 64, device=card, generator=g) for _ in "sb")
    xf = fd.fold_w(x)
    _close(fd.unfold_w(equalized_conv2d_folded(xf, w, b)),
           equalized_conv2d(x, w, b), CONV_REL)
    _close(fd.unfold_w(fd.pixel_norm_folded(xf)), pixel_norm(x, dim=1), REL)
    _close(fd.unfold_w(fd.adain_folded(xf, ys, yb)), adain(x, ys, yb), REL)
    _close(fd.unfold_w(fd.upsample_blur_2x_folded(x)), upsample_blur_2x(x),
           REL)
    _close(fd.unfold_w(fd.upsample_blur_2x_folded(x, blur=False)),
           upsample_nearest_2x(x), REL)
    _close(fd.blur_downsample_2x_folded(xf), blur_downsample_2x(x), REL)
    _close(fd.blur_downsample_2x_folded(xf, blur=False),
           downsample_avg_2x(x), REL)


NARROW = {"model.resolution": 32, "model.fmap_base": 512,
          "model.fmap_max": 64, "model.latent_dim": 32,
          "model.mapping_layers": 2, "run.compute_dtype": "float32"}


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["stylegan-256", "progan-128"])
def test_card_folded_models_match_unfolded(card, preset):
    """G images and D scores with fold on and off on the same parameters
    (``fold_max_channels`` 32: the 32x32 blocks fold)."""
    nets = []
    for fold in (False, True):
        torch.manual_seed(0)
        nets.append([m.to(card).eval() for m in build_models(get_config(
            preset, **dict(NARROW, **{"model.fold_width": fold,
                                      "model.fold_max_channels": 32}))
            .model)])
    (g0, d0), (g1, d1) = nets
    assert not g1.cfg.fold_block(4) and g1.cfg.fold_block(5)
    z = torch.randn(4, 32, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    with torch.no_grad():
        if preset == "stylegan-256":
            imgs = [g(z, generator=torch.Generator(device=card)
                      .manual_seed(2)) for g in (g0, g1)]
        else:
            imgs = [g(z) for g in (g0, g1)]
        _close(imgs[1], imgs[0], MODEL_REL)
        _close(d1(imgs[0]), d0(imgs[0]), MODEL_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_card_step_launches_under_fold(card, r1):
    cfg = get_config("stylegan-256", **dict(NARROW, **{
        "model.fold_width": True, "model.fold_max_channels": 32,
        "run.compute_dtype": "bfloat16", "schedule.progressive": False,
        "schedule.batch_schedule": {32: 4}}))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cuda")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    real = torch.zeros(4, 32, 32, 3, dtype=torch.uint8, device=card)
    step(state, real)                                   # builds the kernels
    chip_smoke.reset_counts()
    step(state, real)
    torch.cuda.synchronize()
    assert chip_smoke._counts() == chip_smoke.launch_totals(
        chip_smoke.step_launches(cfg.model, r1, batch=4))


@pytest.mark.gpu
def test_card_graphed_chunks_under_fold(card):
    """One folded configuration of ``tests/test_torch_graphs.py``'s check:
    graphed chunks equal the lazy stepper bit for bit (deterministic
    cuDNN), with equal launch counts."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = get_config("stylegan-256", **dict(graphs.NARROW, **{
            "model.fold_width": True}))
        assert all(cfg.model.fold_block(lg) for lg in (3, 4))
        phase = graphs.last_phase_of_kind(cfg, "stabilize")
        data = graphs.batches(3 * graphs.K + 2)
        graphs.zero_counts()
        ref, m_ref = graphs.lazy_run(cfg, phase,
                                     graphs.fresh_state(cfg, phase), data)
        want = graphs.counts()
        graphs.zero_counts()
        stepper, _ = tsteps.make_chunked_stepper(cfg, phase)
        got, m_got = graphs.chunked_run(stepper, graphs.fresh_state(
            cfg, phase), data, [graphs.K] * 3 + [2])
        torch.cuda.synchronize()
        assert graphs.counts() == want
        assert stepper.graphs is not None and stepper.graphs.capture_s
        graphs.assert_same(ref, got)
        assert [k for k in m_ref if not torch.equal(m_ref[k], m_got[k])] \
            == []
        stepper.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic

"""Channels-last activations on a card: the resample kernels' NHWC paths
and a StyleGAN2 step without cuDNN layout transposes.

Here on the CPU every test skips. On a CUDA card (``-m gpu``; the file
imports no JAX)::

    python -m pytest --noconftest tests/test_torch_layout_card.py -m gpu

* Both kernels' NHWC paths against their NCHW paths on the same values,
  bit for bit, at the StyleGAN2 config F shapes at 256² (512 channels at
  8²-64², 256 at 128², 128 at 256², the 3-channel RGB at 256²), float32
  and bfloat16, with the gains the autograd Functions pass: the vector
  path where the channels fill 16-byte vectors, the element path for the
  RGB and from an unaligned copy, and at planes whose halves are odd.
  Each NHWC launch is counted in ``nhwc_launches``.
* A StyleGAN2 config F cycle at 256² (batch 8, R1 and path length every
  4 steps) through ``make_chunked_stepper``: after the warm-up cycle and
  the cycle that captures the off-run, the eager R1 + PL head step and
  the graphed replay of the three plain steps under ``torch.profiler``:
  cuDNN's ``nchwToNhwc`` / ``nhwcToNchw`` kernels take under 0.1% of the
  device time (NCHW activations: about a fifth), and an eager conv that
  still launches one is an image conv, whose weight is a toRGB's or a
  fromRGB's (3 channels, which cuDNN pads to 8); every up+blur and blur+down
  launch is NHWC (the replay's too) and every conv call channels-last.
  A StyleGAN (v1) step keeps its G's resample launches NCHW while its
  D's are NHWC.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.ops import conv_grad
from ganlab_tpu_torch.ops.kernels.resample import (
    blur_downsample_2x_cuda,
    blur_downsample_2x_path,
    upsample_blur_2x_cuda,
    upsample_blur_2x_path,
)
from ganlab_tpu_torch.ops.layout import is_channels_last
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train.steps import make_chunked_stepper

CL = torch.channels_last
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")
# (channels, side) of the StyleGAN2 config F activations at 256²
SG2F_NHWC = [(512, 8), (512, 16), (512, 32), (512, 64), (256, 128),
             (128, 256), (3, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _unaligned_cl(x):
    """A channels-last copy of ``x`` one element off a 16-byte boundary."""
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return buf.as_strided(x.shape, (h * w * c, 1, w * c, c)).copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["up", "down"])
@pytest.mark.parametrize("shape", SG2F_NHWC,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_nhwc_paths_bit_equal_to_nchw(cuda, shape, op, dtype):
    kern, path, gains = {
        "up": (upsample_blur_2x_cuda, upsample_blur_2x_path, (1.0, 0.25)),
        "down": (blur_downsample_2x_cuda, blur_downsample_2x_path,
                 (1.0, 4.0))}[op]
    c, side = shape
    g = torch.Generator(device=cuda).manual_seed(c + side)
    x = torch.randn((4, c, side, side), generator=g, device=cuda).to(dtype)
    xc, xu = x.contiguous(memory_format=CL), _unaligned_cl(x)
    assert is_channels_last(xc) and is_channels_last(xu)
    with torch.inference_mode():
        for gain in gains:
            want = kern(x, gain)
            before = (kern.launches, kern.nhwc_launches)
            got, got_u = kern(xc, gain), kern(xu, gain)
            assert (kern.launches - before[0],
                    kern.nhwc_launches - before[1]) == (2, 2)
            assert is_channels_last(got) and is_channels_last(got_u)
            vec = 16 // x.element_size()
            assert path(xc, got) == ("vector" if c % vec == 0
                                     else "element")
            assert path(xu, got_u) == "element"
            assert torch.equal(got, want) and torch.equal(got_u, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 10, 6), (3, 24, 6, 14),
                                   (1, 8, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_nhwc_paths_at_odd_halves(cuda, shape, dtype):
    """Planes whose halves are odd: blur+down's last row pair holds one
    output row; one-pixel planes; both kernels bit-equal to NCHW."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    xc = x.contiguous(memory_format=CL)
    with torch.inference_mode():
        for kern, path, gain in ((upsample_blur_2x_cuda,
                                  upsample_blur_2x_path, 0.25),
                                 (blur_downsample_2x_cuda,
                                  blur_downsample_2x_path, 4.0)):
            got = kern(xc, gain)
            assert path(xc, got) == "vector"
            assert torch.equal(got, kern(x, gain))


def _counters():
    return {"up": (upsample_blur_2x_cuda.launches,
                   upsample_blur_2x_cuda.nhwc_launches),
            "down": (blur_downsample_2x_cuda.launches,
                     blur_downsample_2x_cuda.nhwc_launches),
            "conv": dict(conv_grad.conv2d.calls)}


def _moved(before, after):
    out = {k: tuple(a - b for a, b in zip(after[k], before[k]))
           for k in ("up", "down")}
    out["conv"] = {k: after["conv"][k] - before["conv"][k]
                   for k in before["conv"]}
    return out


def _cycle(preset, over, batch, res):
    cfg = get_config(preset, **dict({
        "schedule.progressive": False, "schedule.batch_schedule":
        {res: batch}, "run.compute_dtype": "bfloat16",
        "model.mbstd_group_size": None}, **over))
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    stepper, k = make_chunked_stepper(cfg, phase)
    state = create_train_state(cfg, seed=0, device="cuda")
    state.shown_imgs = phase.start_img
    g = torch.Generator(device="cuda").manual_seed(1)
    data = torch.randint(0, 256, (3 * k, batch, res, res, 3), generator=g,
                         device="cuda", dtype=torch.uint8)
    # the eager warm-up cycle, then the cycle that captures the off-run
    for i in range(2):
        state, _ = stepper(state, data[i * k:(i + 1) * k])
    torch.cuda.synchronize()
    return stepper, state, data[2 * k:]


@pytest.mark.gpu
def test_stylegan2_cycle_launches_almost_no_layout_transpose(cuda):
    stepper, state, data = _cycle(
        "stylegan2-256", {"model.fmap_base": 16384, "loss.penalty_every": 4,
                          "loss.pl_every": 4}, 8, 256)
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        state, _ = stepper(state, data)     # R1 + PL head, one replay
        torch.cuda.synchronize()
    moved = _moved(before, _counters())
    stepper.close()
    events = prof.events()
    device = [e for e in events if e.device_type.name == "CUDA"]
    transposes = sum(e.device_time for e in device
                     if any(t in e.name for t in TRANSPOSES))
    assert transposes < 1e-3 * sum(e.device_time for e in device)
    # the convs that may still transpose: the image convs, by their weights
    image_w = {tuple(p.shape) for m in (state.g, state.d)
               for n, p in m.named_parameters()
               if p.dim() == 4 and ("torgb" in n or "fromrgb" in n)}
    assert image_w and all(3 in s[:2] for s in image_w), image_w
    for e in events:
        names = [k.name for k in getattr(e, "kernels", None) or []]
        if e.input_shapes and any(t in n for n in names for t in TRANSPOSES):
            assert any(tuple(s) in image_w for s in e.input_shapes), \
                (e.name, e.input_shapes)
    # (the replay's launches are counted on the wrappers too)
    for op in ("up", "down"):
        launches, nhwc = moved[op]
        assert launches > 0 and nhwc == launches, (op, moved)
    assert moved["conv"]["nchw"] == 0 and moved["conv"]["channels_last"] > 0


@pytest.mark.gpu
def test_stylegan_step_keeps_its_g_nchw(cuda):
    stepper, state, data = _cycle(
        "stylegan-256", {"model.resolution": 64, "model.fmap_base": 2048,
                         "model.fmap_max": 256, "loss.penalty_every": 4},
        8, 64)
    before = _counters()
    state, _ = stepper(state, data)
    torch.cuda.synchronize()
    moved = _moved(before, _counters())
    stepper.close()
    # up+blur: the G's forward (NCHW) and the D's backward (NHWC);
    # blur+down: the D's forward (NHWC) and the G's backward (NCHW)
    for op in ("up", "down"):
        launches, nhwc = moved[op]
        assert 0 < nhwc < launches, (op, moved)
    assert moved["conv"]["nchw"] > 0 and moved["conv"]["channels_last"] > 0

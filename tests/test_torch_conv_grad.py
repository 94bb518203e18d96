"""The port's conv differentiation rule (``ops/conv_grad.py``) on the CPU.

* ``gradcheck`` and ``gradgradcheck`` of the rule in float64, 3x3 and 1x1
  SAME convs, batch 3, 4 -> 5 channels.
* First and second order against ``F.conv2d`` through aten, float64, to
  1e-10 of their scale: R1-shaped (the gradient of |dy/dx|^2 with respect
  to the weights, two equalized convs), PL-shaped (the gradient of the
  styles' gradient's norm with respect to the weights and the styles'
  source, through two modulated convs).
* Under ``torch.no_grad()`` and ``inference_mode`` the call is one plain
  convolution; an exported program holds ``aten.conv2d``.
* The passes of whole training steps (plain, R1, PL, R1 + PL) of a 16x16
  StyleGAN and StyleGAN2, counted by a ``TorchDispatchMode``: no conv has
  a filter larger than a layer's kernel (aten's double backward forms its
  weight term as a whole-plane filter over the batch), and no step makes
  more dgrad or wgrad passes than aten made.
"""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.models.layers import EqualConv
from ganlab_tpu_torch.ops import conv_grad, equalized, modulated
from ganlab_tpu_torch.train import steps as tsteps
from ganlab_tpu_torch.train.schedule import build_phases
from ganlab_tpu_torch.train.state import create_train_state

F64 = torch.float64


def _aten_conv2d(x, w, padding):
    return F.conv2d(x, w, padding=padding)


@pytest.mark.parametrize("k", [3, 1])
def test_gradcheck_and_gradgradcheck(k):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(3, 4, 6, 5, dtype=F64, generator=g, requires_grad=True)
    w = torch.randn(5, 4, k, k, dtype=F64, generator=g, requires_grad=True)

    def f(x, w):
        return conv_grad.conv2d(x, w, (k // 2, k // 2))

    assert torch.autograd.gradcheck(f, (x, w))
    assert torch.autograd.gradgradcheck(f, (x, w))


def _close(got, want):
    scale = want.abs().max()
    assert scale > 0
    assert float((got - want).abs().max() / scale) < 1e-10


def _params(shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, dtype=F64, generator=g, requires_grad=True)
            for s in shapes]


def _r1_shaped():
    """y, dy/dx and d|dy/dx|^2/dw of two equalized convs (3x3, 1x1)."""
    w1, w2, b1 = _params([(5, 4, 3, 3), (6, 5, 1, 1), (5,)], 0)
    x = torch.randn(3, 4, 8, 8, dtype=F64,
                    generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    y = equalized.equalized_conv2d(
        equalized.leaky_relu(equalized.equalized_conv2d(x, w1, b1)), w2)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    gw = torch.autograd.grad(gx.square().sum(), [w1, w2, b1])
    return [y.detach(), gx.detach(), *gw]


def _pl_shaped():
    """The styles' gradient of a projection through two modulated convs
    (3x3 demodulated, then a 1x1 toRGB), and its squared norm's gradient
    with respect to the weights and the styles' source."""
    w1, w2, a = _params([(5, 4, 3, 3), (3, 5, 1, 1), (2, 4)], 2)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 8, 8, dtype=F64, generator=gen)
    proj = torch.randn(2, 3, 8, 8, dtype=F64, generator=gen)
    s1 = a.exp()
    s2 = s1[:, :1].expand(2, 5) + 1.0
    h = equalized.leaky_relu(modulated.modulated_conv2d(x, w1, s1))
    img = modulated.modulated_conv2d(h, w2, s2, demodulate=False, gain=1.0)
    (gs,) = torch.autograd.grad((img * proj).sum(), s1, create_graph=True)
    grads = torch.autograd.grad(gs.square().sum(), [w1, w2, a])
    return [img.detach(), gs.detach(), *grads]


@pytest.mark.parametrize("shaped", [_r1_shaped, _pl_shaped],
                         ids=["r1", "pl"])
def test_first_and_second_order_match_aten(shaped, monkeypatch):
    got = shaped()
    monkeypatch.setattr(equalized, "conv2d", _aten_conv2d)
    monkeypatch.setattr(modulated, "conv2d", _aten_conv2d)
    want = shaped()
    for a, b in zip(got, want, strict=True):
        _close(a, b)


FPROP = (torch.ops.aten.convolution.default, torch.ops.aten.conv2d.default)


class _Ops(TorchDispatchMode):
    """Counts conv passes: ``aten.convolution`` calls by weight shape (or
    ``aten.conv2d`` ones, which inference mode does not decompose), a
    transposed one as a dgrad (``conv_grad``'s on channels-last memory),
    and ``convolution_backward`` calls by what they compute."""

    def __init__(self):
        super().__init__()
        self.convs = collections.Counter()
        self.passes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in FPROP:
            self.convs[tuple(args[1].shape)] += 1
            transposed = func is FPROP[0] and args[6]
            self.passes["dgrad" if transposed else "fprop"] += 1
        elif func is torch.ops.aten.convolution_backward.default:
            mask = args[-1]
            self.passes["dgrad"] += bool(mask[0])
            self.passes["wgrad"] += bool(mask[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_without_grad_a_plain_convolution(mode):
    conv = EqualConv(4, 6, 3)
    x = torch.randn(2, 4, 8, 8)
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx, _Ops() as ops:
        y = conv(x)
    assert y.grad_fn is None
    assert ops.convs == {(6, 4, 3, 3): 1}
    # with grad on the rule's Function records the call
    assert type(conv(x).grad_fn).__name__ == "AddBackward0"
    assert "_Fprop" in type(conv_grad.conv2d(
        x, conv.w, (1, 1)).grad_fn).__name__


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_exported_program_holds_aten_conv2d(grad):
    conv = EqualConv(4, 6, 3)
    with torch.set_grad_enabled(grad):
        ep = torch.export.export(conv, (torch.randn(2, 4, 8, 8),))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("aten.conv2d.default") == 1
    assert not [t for t in targets if "autograd" in t or "conv_grad" in t]


# The passes aten made for the same steps: counted with this mode on the
# port before the rule (every conv through ``F.conv2d``), where a wgrad
# is a ``convolution_backward`` weight output or a whole-plane
# ``aten.convolution`` (the double backward's weight term).
ATEN_PASSES = {
    ("stylegan-256", False, False): {"dgrad": 22, "wgrad": 18},
    ("stylegan-256", True, False): {"dgrad": 34, "wgrad": 30},
    ("stylegan-256", False, True): {"dgrad": 33, "wgrad": 29},
    ("stylegan-256", True, True): {"dgrad": 45, "wgrad": 41},
    ("stylegan2-256", False, False): {"dgrad": 30, "wgrad": 24},
    ("stylegan2-256", True, False): {"dgrad": 46, "wgrad": 40},
    ("stylegan2-256", False, True): {"dgrad": 43, "wgrad": 37},
    ("stylegan2-256", True, True): {"dgrad": 59, "wgrad": 53},
}


@pytest.mark.parametrize("preset", ["stylegan-256", "stylegan2-256"])
@pytest.mark.parametrize("r1,pl", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["plain", "r1", "pl", "r1_pl"])
def test_step_passes(preset, r1, pl):
    over = {"model.resolution": 16, "model.fmap_base": 64,
            "model.fmap_max": 8, "model.latent_dim": 8,
            "model.mapping_layers": 1, "run.compute_dtype": "float32",
            "schedule.batch_schedule": {16: 4}}
    if preset == "stylegan-256":
        over.update({"schedule.progressive": False, "loss.pl_weight": 2.0})
    cfg = get_config(preset, **over)
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1,
                                   pl_override=pl)
    with _Ops() as ops:
        step(state, torch.zeros(4, 16, 16, 3, dtype=torch.uint8))
    kernels = {w[2:] for w in ops.convs}
    assert kernels <= {(1, 1), (3, 3)}, kernels
    aten = ATEN_PASSES[preset, r1, pl]
    for kind in ("dgrad", "wgrad"):
        assert 0 < ops.passes[kind] <= aten[kind], (kind, ops.passes)

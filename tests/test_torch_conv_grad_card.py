"""The conv differentiation rule (``ops/conv_grad.py``) on a card.

Here on the CPU every test skips. On a CUDA card (``-m gpu``; the file
imports no JAX)::

    python -m pytest --noconftest tests/test_torch_conv_grad_card.py -m gpu

an R1-shaped second order (the gradient of |dy/dx|^2 with respect to the
weights of a 3x3 and a 1x1 equalized conv) through the rule against aten's
double backward, in float32 with TF32 off, within 1e-4 of the reference's
norm; and in bf16 at batch 32 and 256x256 the rule's second order
launches no cuDNN legacy ``convolve_sgemm`` kernel, where aten's
whole-plane weight-gradient conv does.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ganlab_tpu_torch.ops import equalized


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _aten_conv2d(x, w, padding):
    return F.conv2d(x, w, padding=padding)


def _r1_weight_grads(dev, dtype, n=8, c=64, hw=64):
    g = torch.Generator(device=dev).manual_seed(0)
    w1 = torch.randn(c, c, 3, 3, device=dev, generator=g, requires_grad=True)
    w2 = torch.randn(c, c, 1, 1, device=dev, generator=g, requires_grad=True)
    x = torch.randn(n, c, hw, hw, device=dev, generator=g).to(dtype)
    x.requires_grad_(True)
    h = equalized.leaky_relu(equalized.equalized_conv2d(x, w1.to(dtype)))
    y = equalized.equalized_conv2d(h, w2.to(dtype))
    (gx,) = torch.autograd.grad(y.float().square().sum(), x,
                                create_graph=True)
    return torch.autograd.grad(gx.float().square().sum(), [w1, w2])


@pytest.mark.gpu
def test_card_second_order_matches_aten(monkeypatch):
    dev = _card()
    got = _r1_weight_grads(dev, torch.float32)
    monkeypatch.setattr(equalized, "conv2d", _aten_conv2d)
    want = _r1_weight_grads(dev, torch.float32)
    for a, b in zip(got, want, strict=True):
        err = float((a - b).norm() / b.norm())
        assert err <= 1e-4, err


def _device_kernels(dev):
    # a 256x256 plane at batch 32, as the 256² training cells have: there
    # aten's whole-plane weight term runs on the legacy kernel (at 64x64
    # and batch 8 cuDNN finds a Hopper kernel for it)
    shape = dict(n=32, c=128, hw=256)
    _r1_weight_grads(dev, torch.bfloat16, **shape)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _r1_weight_grads(dev, torch.bfloat16, **shape)
        torch.cuda.synchronize(dev)
    return [e.key for e in prof.key_averages()
            if e.device_type.name == "CUDA"]


@pytest.mark.gpu
def test_card_second_order_runs_no_legacy_sgemm(monkeypatch):
    dev = _card()
    rule = _device_kernels(dev)
    assert not [k for k in rule if "convolve_sgemm" in k], rule
    monkeypatch.setattr(equalized, "conv2d", _aten_conv2d)
    aten = _device_kernels(dev)
    assert [k for k in aten if "convolve_sgemm" in k], aten

"""The composed upsample + conv (``model.fused_up_conv``) on a card.

Here on the CPU every test skips. On a CUDA card (``-m gpu``; the file
imports no JAX, so it runs on a host that has only PyTorch)::

    python -m pytest --noconftest tests/test_torch_up2conv_card.py -m gpu

each form of ``equalized_conv2d_up2`` against the two-op form (the up+blur
kernel or the nearest upsample, then the conv) in float32 with TF32 off,
within 1e-4 of the reference's scale; the hybrid's backward launches one
up+blur and one blur+down and its gradients agree with the plain versions'
two-op gradients within 1e-5 of the scale; the hybrid's forward and
backward captured in one CUDA graph replay to the eager bits.
"""

import pytest
import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops import (
    equalized_conv2d,
    equalized_conv2d_up2,
    up2_conv2d_hybrid,
    upsample_blur_2x,
    upsample_nearest_2x,
)
from ganlab_tpu_torch.ops.kernels import launch_counters, resample

BLUR = (1.0, 2.0, 1.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("taps,form", [(BLUR, "dilated"), (BLUR, "poly"),
                                       (BLUR, "hybrid"), (None, "dilated"),
                                       (None, "poly")],
                         ids=["blur-dilated", "blur-poly", "blur-hybrid",
                              "nearest-dilated", "nearest-poly"])
def test_card_forms_match_two_op(taps, form):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 64, 32, 24, device=dev, generator=g)
    w = torch.randn(32, 64, 3, 3, device=dev, generator=g)
    up = upsample_nearest_2x if taps is None else upsample_blur_2x
    ref = equalized_conv2d(up(x), w)
    got = equalized_conv2d_up2(x, w, taps=taps, form=form)
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.gpu
def test_card_hybrid_backward_launches_the_resample_kernels():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4, 64, 16, 16, device=dev, generator=g,
                    requires_grad=True)
    w = torch.randn(32, 64, 3, 3, device=dev, generator=g,
                    requires_grad=True)
    ct = torch.randn(4, 32, 32, 32, device=dev, generator=g)
    y = up2_conv2d_hybrid(x, w)
    counters = launch_counters()
    before = [c.launches for c in counters]
    got = torch.autograd.grad(y, (x, w), ct)
    added = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    assert added["upsample_blur_2x_cuda"] == 1
    assert added["blur_downsample_2x_cuda"] == 1
    up = resample.upsample_blur_2x_ref(x.detach()).requires_grad_()
    gu, gw = torch.autograd.grad(F.conv2d(up, w, padding=1), (up, w), ct)
    for a, b in zip(got, (resample.blur_downsample_2x_ref(gu, 4.0), gw)):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), err


@pytest.mark.gpu
def test_card_hybrid_in_a_cuda_graph():
    """The hybrid forward and backward captured in one CUDA graph and
    replayed on new inputs give the eager bits: no host reads."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(4, 64, 16, 16, device=dev, generator=g,
                    requires_grad=True)
    w = torch.randn(32, 64, 3, 3, device=dev, generator=g,
                    requires_grad=True)
    ct = torch.randn(4, 32, 32, 32, device=dev, generator=g)

    def run():
        return torch.autograd.grad(up2_conv2d_hybrid(x, w), (x, w), ct)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    with torch.no_grad():
        x.copy_(torch.randn(x.shape, device=dev, generator=g))
        ct.copy_(torch.randn(ct.shape, device=dev, generator=g))
    graph.replay()
    eager = run()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)

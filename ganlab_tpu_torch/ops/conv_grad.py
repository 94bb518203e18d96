"""A stride-1 convolution whose gradients of every order are convolutions
of the same three kinds (StyleGAN2-ADA's ``conv2d_gradfix``), NCHW / OIHW
shapes in NCHW or channels-last memory.

For y = F(x, w), a stride-1, groups-1 conv with symmetric zero padding,
the three passes and their gradients are::

    F(x, w)   fprop   dx = D(g, w)       dw = W(g, x)
    D(g, w)   dgrad   dg = F(h, w)       dw = W(g, h)
    W(g, x)   wgrad   dg = F(x, h)       dx = D(g, h)

so the set is closed under differentiation. aten differentiates its own
convolution backward in ``_convolution_double_backward``, whose weight
term is a convolution of the batch-transposed tensors: a filter the size
of the whole output plane over the batch as channels, for which cuDNN
has no tensor-core engine (it falls back to ``implicit_convolve_sgemm``).
Here R1's and path length's second order runs on the ordinary fprop,
dgrad and wgrad kernels. Each pass's forward is the aten call that a
plain step makes for it (``F.conv2d``; ``convolution_backward`` with one
output), so a first-order backward launches the kernels it did.

A Python Function's ``needs_input_grad`` is fixed at its forward, while
aten's backward node computes only the outputs the running backward
uses; each backward here asks the engine the same of its inputs' nodes
(``_needed``), so R1's inner gradient with respect to the image computes
no weight gradient.

The rule is taken only where grad mode is on and an argument requires a
gradient: under ``torch.no_grad()``, ``inference_mode`` and in an
exported program the call is a plain convolution.

Layout: each pass returns its activation's layout (``ops.layout``): fprop
and wgrad x's, dgrad g's. cuDNN takes a conv channels-last where its input
or its weight is, and dgrad's input is a zero-stride stand-in that carries
no layout, so fprop and dgrad give the weight their activation's layout
(a no-op for the weights that ``equalized_conv2d`` and
``modulated_conv2d`` cast, which carry it already). A Function's backward
takes the gradient of its result in the result's layout: one that
arrives in the other (a gradient of a gradient through a plain op, such
as mbstd's backward) is copied once, not transposed by each pass.
``conv2d.calls`` counts the calls of :func:`conv2d` by their input's
layout, when the Python runs (eagerly, or once at a CUDA-graph capture).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.layout import (
    as_layout,
    is_channels_last,
    weight_like,
)

_CONV_BACKWARD = torch.ops.aten.convolution_backward.default
_ONE = (1, 1)


def _dgrad_op(g: torch.Tensor, w: torch.Tensor, x_shape, padding
              ) -> torch.Tensor:
    """dx of ``F.conv2d(x, w, padding=padding)`` for the output gradient
    ``g``; ``x`` enters only by its shape (``torch.nn.grad.conv2d_input``'s
    zero-stride stand-in). A channels-last ``g`` takes the transposed conv,
    the same cuDNN pass: aten's ``convolution_backward`` reads a layout
    from its input argument, which the stand-in lacks, and would copy g to
    NCHW and back."""
    if is_channels_last(g):
        return F.conv_transpose2d(g, weight_like(w, g), padding=padding)
    x = g.new_empty(1).expand(x_shape)
    return _CONV_BACKWARD(g, x, w.contiguous(), None, _ONE, padding, _ONE,
                          False, (0, 0), 1, (True, False, False))[0]


def _wgrad_op(g: torch.Tensor, x: torch.Tensor, w_shape, padding
              ) -> torch.Tensor:
    """dw of ``F.conv2d(x, w, padding=padding)`` for the output gradient
    ``g``; ``w`` enters only by its shape."""
    w = g.new_empty(1).expand(w_shape)
    return _CONV_BACKWARD(g, x, w, None, _ONE, padding, _ONE, False, (0, 0),
                          1, (False, True, False))[1]


def _recorded(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)


def _fprop_op(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    return F.conv2d(x, weight_like(w, x), padding=padding)


def conv2d(x: torch.Tensor, w: torch.Tensor, padding: tuple[int, int]
           ) -> torch.Tensor:
    """``F.conv2d(x, w, padding=padding)`` (stride 1, groups 1) that
    autograd differentiates through fprop, dgrad and wgrad alone; the
    result in x's layout."""
    conv2d.calls["channels_last" if is_channels_last(x) else "nchw"] += 1
    if _recorded(x, w):
        return _Fprop.apply(x, w, padding)
    return _fprop_op(x, w, padding)


conv2d.calls = {"nchw": 0, "channels_last": 0}


def _dgrad(g, w, x_shape, padding):
    if _recorded(g, w):
        return _Dgrad.apply(g, w, x_shape, padding)
    return _dgrad_op(g, w, x_shape, padding)


def _wgrad(g, x, w_shape, padding):
    if _recorded(g, x):
        return _Wgrad.apply(g, x, w_shape, padding)
    return _wgrad_op(g, x, w_shape, padding)


def _needed(ctx, i: int) -> bool:
    """Whether the running backward uses the gradient of input ``i``: the
    engine's answer for its node. The engine will not answer for a leaf
    that ``torch.autograd.grad`` was asked for (R1's image), which is
    used."""
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        return True


class _Fprop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None)
        ctx.x_shape, ctx.w_shape, ctx.padding = x.shape, w.shape, padding
        ctx.channels_last = is_channels_last(x)
        return _fprop_op(x, w, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.padding
        g = as_layout(g, ctx.channels_last)
        dx = _dgrad(g, w, ctx.x_shape, p) if _needed(ctx, 0) else None
        dw = _wgrad(g, x, ctx.w_shape, p) if _needed(ctx, 1) else None
        return dx, dw, None


class _Dgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w, x_shape, padding):
        need_g, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(g if need_w else None, w if need_g else None)
        ctx.w_shape, ctx.padding = w.shape, padding
        ctx.channels_last = is_channels_last(g)
        return _dgrad_op(g, w, x_shape, padding)

    @staticmethod
    def backward(ctx, h):
        g, w = ctx.saved_tensors
        p = ctx.padding
        h = as_layout(h, ctx.channels_last)
        dg = conv2d(h, w, p) if _needed(ctx, 0) else None
        dw = _wgrad(g, h, ctx.w_shape, p) if _needed(ctx, 1) else None
        return dg, dw, None, None


class _Wgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, w_shape, padding):
        need_g, need_x = ctx.needs_input_grad[:2]
        ctx.save_for_backward(g if need_x else None, x if need_g else None)
        ctx.x_shape, ctx.padding = x.shape, padding
        return _wgrad_op(g, x, w_shape, padding)

    @staticmethod
    def backward(ctx, h):
        g, x = ctx.saved_tensors
        p = ctx.padding
        dg = conv2d(x, h, p) if _needed(ctx, 0) else None
        dx = _dgrad(g, h, ctx.x_shape, p) if _needed(ctx, 1) else None
        return dg, dx, None, None

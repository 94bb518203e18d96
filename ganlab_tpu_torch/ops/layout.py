"""Activation memory layout: NCHW or channels-last, under (N, C, H, W).

cuDNN runs its convolutions on NHWC engines. On NCHW memory every conv
call transposes its input and its result; on channels-last memory it reads
and writes them as they are. So the StyleGAN2 synthesis and the ProGAN-
family discriminator keep their activations channels-last:
:func:`to_channels_last` sets it at their inputs, and every op on their
paths returns its input's layout (:func:`memory_format`). An NCHW input
takes the NCHW path throughout. Parameters, optimizer state and
checkpoints keep their layout.
"""

from __future__ import annotations

import torch

CHANNELS_LAST = torch.channels_last


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x``'s bytes are NHWC and not also NCHW (where C = 1 or
    H = W = 1 the two orders are the same, and that counts as NCHW)."""
    return not x.is_contiguous() and x.is_contiguous(
        memory_format=CHANNELS_LAST)


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format of an op's result on ``x``: channels-last for a
    channels-last ``x``, else the format of the tensor it is given to
    (``.to(..., memory_format=memory_format(x))`` changes nothing then)."""
    return CHANNELS_LAST if is_channels_last(x) else torch.preserve_format


def as_layout(t: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """``t`` channels-last or NCHW-contiguous."""
    return t.contiguous(memory_format=CHANNELS_LAST if channels_last
                        else torch.contiguous_format)


def weight_like(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The conv weight ``w`` (O, I, kh, kw) in the activation ``x``'s
    layout. cuDNN reads a layout from the strides, and a 1x1 weight's
    NCHW bytes are its channels-last bytes, which ``contiguous`` leaves
    with NCHW strides: such a weight gets channels-last strides as a
    view."""
    if not is_channels_last(x):
        return w.contiguous()
    o, i, kh, kw = w.shape
    if kh == kw == 1 and w.is_contiguous():
        return w.as_strided(w.shape, (i, 1, i, i))
    return w.contiguous(memory_format=CHANNELS_LAST)


class _ToChannelsLast(torch.autograd.Function):
    """A channels-last copy whose gradient comes back NCHW, so that a
    network upstream of the copy (StyleGAN's NCHW G under the
    channels-last D) keeps its own layout in its backward. The gradient's
    gradient (R1's double backward from the image) goes channels-last
    again: each of the two copies differentiates to the other."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous(memory_format=CHANNELS_LAST)

    @staticmethod
    def backward(ctx, g):
        return _ToNchw.apply(g)


class _ToNchw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return g.contiguous()

    @staticmethod
    def backward(ctx, h):
        return _ToChannelsLast.apply(h)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, C, H, W) in channels-last memory. Its gradient comes back
    NCHW-contiguous where ``x`` was not channels-last."""
    if is_channels_last(x):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _ToChannelsLast.apply(x)
    return x.contiguous(memory_format=CHANNELS_LAST)


"""Equalized learning rate ops (ProGAN sec. 4.1), NCHW / OIHW.

Port of ``ganlab_tpu/ops/equalized.py``. Weights are stored
N(0, 1/lr_mult)-initialized; the effective weight is
``w * he_constant(fan_in, gain) * lr_mult`` and the bias is scaled by
``lr_mult`` too (StyleGAN's mapping net runs at lr_mult 0.01). The scale
is applied to the weight, in the weight's dtype, as the JAX op does.
A conv's result takes its input's memory layout (``ops.layout``): the
scaled weight is cast into it with the dtype.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.conv_grad import conv2d
from ganlab_tpu_torch.ops.layout import memory_format
from ganlab_tpu_torch.ops.upfirdn import up2_conv2d, up2_conv2d_hybrid


def he_constant(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    """Runtime weight scale c = gain / sqrt(fan_in) (He init constant)."""
    return gain / math.sqrt(float(fan_in))


def equalized_dense(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None, *,
                    gain: float = math.sqrt(2.0),
                    lr_mult: float = 1.0) -> torch.Tensor:
    """y = x @ (w * c * lr_mult) + b * lr_mult; ``w`` is (in, out)."""
    scale = he_constant(w.shape[0], gain) * lr_mult
    y = x @ (w * scale)
    if b is not None:
        y = y + (b * lr_mult).to(y.dtype)
    return y


def equalized_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *,
                     padding: str | int = "SAME",
                     gain: float = math.sqrt(2.0),
                     lr_mult: float = 1.0) -> torch.Tensor:
    """Equalized-LR stride-1 2D convolution; x (N, C, H, W), NCHW or
    channels-last, the result in x's layout; w OIHW (odd k).

    fan_in = in_ch * kh * kw; ``"SAME"`` pads k // 2 on each side, an int
    or an (h, w) pair pads as ``F.conv2d`` does. The conv's gradients of
    every order are fprop, dgrad and wgrad passes (``ops.conv_grad``).
    """
    out_ch, in_ch, kh, kw = w.shape
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"SAME padding needs an odd kernel, got {kh}x{kw}")
        padding = (kh // 2, kw // 2)
    elif isinstance(padding, int):
        padding = (padding, padding)
    scale = he_constant(kh * kw * in_ch, gain) * lr_mult
    ws = (w * scale).to(x.dtype, memory_format=memory_format(x))
    y = conv2d(x, ws, tuple(padding))
    if b is not None:
        y = y + (b * lr_mult).to(y.dtype)[None, :, None, None]
    return y


HYBRID_NEAREST = ("form='hybrid' supports only the blur taps (nearest-up "
                  "has no hybrid variant) — use form='dilated' or 'poly'")


def equalized_conv2d_up2(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor | None = None, *,
                         taps=(1.0, 2.0, 1.0), form: str = "dilated",
                         gain: float = math.sqrt(2.0),
                         lr_mult: float = 1.0) -> torch.Tensor:
    """``equalized_conv2d(upsample[_blur]_2x(x), w, b)`` as one composed
    conv (``upfirdn.up2_conv2d``); x NCHW, w (O, I, 3, 3).

    The He constant comes from the ORIGINAL (kh, kw, in_ch) fan-in: the
    fusion changes the order of evaluation, not the function. ``taps=None``
    is nearest-up (ProGAN G), the default taps nearest-up + FIR blur
    (StyleGAN G). ``form``: ``'poly'`` (four phase convs), ``'hybrid'``
    (the dilated forward, the two-op backward; blur taps only) or any
    other value, the dilated form (one transposed conv).
    """
    _, in_ch, kh, kw = w.shape
    scale = he_constant(kh * kw * in_ch, gain) * lr_mult
    ws = (w * scale).to(x.dtype)
    if form == "hybrid":
        if taps is None:
            raise ValueError(HYBRID_NEAREST)
        y = up2_conv2d_hybrid(x, ws)
    else:
        y = up2_conv2d(x, ws, taps=taps, polyphase=form == "poly")
    if b is not None:
        y = y + (b * lr_mult).to(y.dtype)[None, :, None, None]
    return y


def equalized_conv2d_folded(x_f: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor | None = None, *,
                            gain: float = math.sqrt(2.0),
                            lr_mult: float = 1.0) -> torch.Tensor:
    """Equalized-LR SAME conv of a WIDTH-FOLDED activation
    (``ops.folded``); ``w`` is the ordinary logical (O, I, kh, kw) weight,
    folded at call time, so parameters and checkpoints are those of the
    unfolded conv. The He constant uses the logical fan-in, and the weight
    is scaled before it is folded, as the JAX op does."""
    from ganlab_tpu_torch.ops import folded as fd

    _, in_ch, kh, kw = w.shape
    scale = he_constant(kh * kw * in_ch, gain) * lr_mult
    y = fd.conv2d_folded(x_f, (w * scale).to(x_f.dtype))
    if b is not None:
        y = fd.bias_folded(y, b * lr_mult)
    return y


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU(0.2), the activation used throughout ProGAN/StyleGAN."""
    return F.leaky_relu(x, slope)


@functools.cache
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: it multiplies a
    tensor of that dtype as ``jnp.asarray(value, dtype)`` does in the JAX
    package (a constant factor such as sqrt(2) in bfloat16)."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))

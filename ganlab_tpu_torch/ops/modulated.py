"""Modulated convolution with weight demodulation (StyleGAN2, Karras et al.
2019 sec. 2.2), (N, C, H, W) in NCHW or channels-last memory / OIHW.

Port of ``ganlab_tpu/ops/modulated.py`` in its activation-side form:
modulate the input, run one shared-weight convolution, demodulate the
output::

    conv(x * s_i, W)[n, o] * d[n, o]
      == conv(x, W * s_i * d_o)[n]          (linearity)
    d[n, o] = rsqrt(sum_{k,i} (W[o,i,k] * s[n,i])^2 + eps)

The demodulation factor needs only sum_k W^2 (O, I), a small product with
the squared styles. This is the computation the JAX package runs, not the
per-sample grouped convolution of the official code. The convolution is
``F.conv2d`` (cuDNN on the card; the JAX package runs it outside any
Pallas kernel too), differentiated to any order through fprop, dgrad and
wgrad passes (``ops.conv_grad``). The result takes x's layout: the
scaled weight is cast into it with the dtype, and the modulation and
demodulation products keep it.
"""

from __future__ import annotations

import math

import torch

from ganlab_tpu_torch.ops.conv_grad import conv2d
from ganlab_tpu_torch.ops.equalized import he_constant
from ganlab_tpu_torch.ops.layout import memory_format


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, styles: torch.Tensor,
                     *, demodulate: bool = True,
                     gain: float = math.sqrt(2.0), lr_mult: float = 1.0,
                     eps: float = 1e-8) -> torch.Tensor:
    """Equalized-LR style-modulated SAME conv. x (N, I, H, W); w (O, I, k,
    k) shared weights; styles (N, I) per-sample per-input-channel scales.

    The He constant (logical fan-in) scales the weight before the cast to
    x's dtype, and before modulation and demodulation; the demodulation
    sum squares that cast weight in float32, and d is computed in float32
    and cast to the output's dtype, as in the JAX op."""
    _, ci, kh, kw = w.shape
    scale = he_constant(kh * kw * ci, gain) * lr_mult
    ws = (w * scale).to(x.dtype, memory_format=memory_format(x))
    s = styles.to(x.dtype)
    y = conv2d(x * s[:, :, None, None], ws, (kh // 2, kw // 2))
    if demodulate:
        ww = ws.float().square().sum(dim=(2, 3))          # (O, I)
        d = torch.rsqrt(s.float().square() @ ww.t() + eps)  # (N, O)
        y = y * d.to(y.dtype)[:, :, None, None]
    return y

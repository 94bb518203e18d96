"""Resampling ops of StyleGAN and ProGAN, NCHW.

Port of ``ganlab_tpu/ops/upfirdn.py``: nearest-2x upsampling, 2x2 average
pooling, the [1,2,1] binomial blur, and the two fused forms StyleGAN uses
(Karras et al. 2018 app. C): nearest-2x up followed by the blur (G) and
the blur followed by 2x down (D). The fused forms go through their autograd
Functions: a CPU tensor takes the plain version, any other tensor the CUDA
kernel of ``csrc/resample.cu``, which launches or raises. The rest is
plain PyTorch, as the JAX package has no kernel for it.

``up2_conv2d`` composes a generator block's 2x upsample (nearest, or
nearest + blur) into its first 3x3 conv as one convolution (the JAX
package's ``model.fused_up_conv``): an exact change of evaluation order
that never makes the 4x upsampled tensor. Its dilated form is one
``F.conv_transpose2d`` of stride 2, its polyphase form four ``F.conv2d``
at the input's resolution; ``up2_conv2d_hybrid`` pairs the dilated
forward with the two-op backward, which runs the resample kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ganlab_tpu_torch.ops.kernels.resample import (
    BlurDownsample2x,
    UpsampleBlur2x,
)
from ganlab_tpu_torch.ops.layout import is_channels_last

BLUR_TAPS = (1.0, 2.0, 1.0)


def binomial_kernel(taps=(1.0, 2.0, 1.0)) -> torch.Tensor:
    """Normalized separable 2D FIR kernel from 1D taps, shape (k, k)."""
    t = torch.tensor(taps, dtype=torch.float32)
    k = torch.outer(t, t)
    return k / k.sum()


def blur2d(x: torch.Tensor, taps=(1.0, 2.0, 1.0)) -> torch.Tensor:
    """Depthwise FIR blur with SAME (zero) padding; odd tap count."""
    c = x.shape[1]
    k = binomial_kernel(taps).to(device=x.device, dtype=x.dtype)
    pad = (k.shape[0] - 1) // 2
    return F.conv2d(x, k.expand(c, 1, *k.shape), padding=pad, groups=c)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (ProGAN G path)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2) \
        .reshape(n, c, 2 * h, 2 * w)


def downsample_avg_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsampling (ProGAN D path, D fade branch), in
    x's layout."""
    n, c, h, w = x.shape
    if is_channels_last(x):
        # the same sums over the (N, H, W, C) memory: channels-last out
        return (x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
                .sum(dim=(2, 4)) * 0.25).permute(0, 3, 1, 2)
    return x.reshape(n, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5)) * 0.25


def upsample_blur_2x(x: torch.Tensor) -> torch.Tensor:
    """blur([1,2,1]) of nearest_up_2x(x), with zero padding at the border."""
    return UpsampleBlur2x.apply(x)


def blur_downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """downsample_avg_2x(blur([1,2,1])(x)), with zero padding at the border."""
    return BlurDownsample2x.apply(x)


def fade_in(alpha: float, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """lerp: old + alpha * (new - old) (progressive-growing fade)."""
    return old + alpha * (new - old)


def _up2_fir(taps) -> tuple[np.ndarray, tuple[int, int]]:
    """(k1, pad) of the 2x zero-stuff resampling FIR as a correlation; its
    2D kernel is ``np.outer(k1, k1)``.

    ``taps=None`` is nearest-neighbour upsampling (zero-stuff * box
    [1, 1]); otherwise nearest-up + FIR blur (zero-stuff * (box conv
    taps)). Both kernels are flip-symmetric, so correlation equals
    convolution and the composition below needs no flips of them.
    """
    if taps is None:
        return np.asarray([1.0, 1.0], dtype=np.float32), (1, 1)
    t = np.asarray(taps, dtype=np.float32)
    k1 = (np.convolve(t, [1.0, 1.0]) / t.sum()).astype(np.float32)
    lo = (len(k1) - 1) // 2
    return k1, (lo + 1, len(k1) - 1 - lo)


def _fir_2d(k1: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``np.outer(k1, k1)`` in float32, cast to ``like``'s dtype, on its
    device. Made from scalar fills: a copy from the host would stop a
    CUDA graph's capture, and ``torch.export`` would hold it as a
    constant."""
    v = torch.stack([like.new_full((), float(t), dtype=torch.float32)
                     for t in k1])
    return torch.outer(v, v).to(like.dtype)


def compose_up2_kernel(w: torch.Tensor, taps=BLUR_TAPS) -> torch.Tensor:
    """Compose an (O, I, kh, kw) conv kernel with the 2x upsampling FIR.

    Returns the (O, I, kh + kK - 1, kw + kK - 1) kernel C with
    ``conv(C, zero_stuff_2x(x)) == conv(w, upsample[_blur]_2x(x))``:
    C[s, t] = sum_{r, q} w[r, q] K[s - r, t - q], the true 2D convolution
    of the two kernels (K symmetric). Built from kh * kw static shifted
    adds in ``w``'s dtype, in the JAX package's order.
    """
    k1, _ = _up2_fir(taps)
    kk = len(k1)
    co, ci, kh, kw = w.shape
    fir = _fir_2d(k1, w)
    c = w.new_zeros((co, ci, kh + kk - 1, kw + kk - 1))
    for r in range(kh):
        for q in range(kw):
            c[:, :, r:r + kk, q:q + kk] += w[:, :, r:r + 1, q:q + 1] * fir
    return c


def _up1d_ext(z: torch.Tensor, k1: np.ndarray) -> torch.Tensor:
    """1D zero-extended blur-upsample of (N, C, L) -> (N, C, 2L + 2), WITH
    tails.

    Positions -1 and 2L of the zero-EXTENDED (not zero-padded) upsampled
    signal carry the FIR tails k1[3] z[0] and k1[0] z[-1]; the interior
    matches the ordinary padded upsample. Only for 4-tap k1.
    """
    assert len(k1) == 4
    k = [float(t) for t in k1]            # Python floats: keep z's dtype
    n, c, size = z.shape
    zp = F.pad(z, (1, 1))
    prev, cur, nxt = zp[..., :-2], zp[..., 1:-1], zp[..., 2:]
    even = k[0] * prev + k[2] * cur       # out[2i]
    odd = k[1] * cur + k[3] * nxt         # out[2i + 1]
    inter = torch.stack([even, odd], dim=-1).reshape(n, c, 2 * size)
    return torch.cat([k[3] * z[..., :1], inter, k[0] * z[..., -1:]], dim=-1)


def _shifted_matmul_1d(v: torch.Tensor, wk: torch.Tensor, pad: int
                       ) -> torch.Tensor:
    """Correlate (N, I, L) with (O, I, K) taps, ``pad`` zeros each side ->
    (N, O, L + 2 pad - K + 1): one ``F.conv1d``."""
    return F.conv1d(v, wk, padding=pad)


def _up2_blur_ring_correction(x: torch.Tensor, w: torch.Tensor,
                              y: torch.Tensor, k1: np.ndarray
                              ) -> torch.Tensor:
    """Subtract the FIR-tail contributions from ``y`` in place, so that the
    composed conv equals the two-op form's zero-padded intermediate.

    The composed conv reads the zero-EXTENDED upsampled signal, whose only
    nonzero values outside the [0, 2H) x [0, 2W) window are a 1-px frame of
    blur tails (``_up1d_ext``); the 3x3 conv reaches 1 px, so only the
    output ring changes. Each frame side is removed with one thin 1D
    correlation against the matching row or column of ``w`` (O, I, 3, 3).
    """
    k3, k0 = float(k1[3]), float(k1[0])
    # Top / bottom rows include the corners (the full extension along W);
    # the left / right columns exclude them (interior H positions only).
    top = k3 * _up1d_ext(x[:, :, 0], k1)              # (N, I, 2W + 2)
    bot = k0 * _up1d_ext(x[:, :, -1], k1)
    lcol = k3 * _up1d_ext(x[..., 0], k1)[..., 1:-1]    # (N, I, 2H)
    rcol = k0 * _up1d_ext(x[..., -1], k1)[..., 1:-1]
    # Output row 0 reads frame row -1 through w's row 0, row 2H - 1 frame
    # row 2H through w's row 2 (a VALID correlation over -1 .. 2W); the
    # columns likewise, over rows 0 .. 2H - 1 with zeros beyond (SAME).
    y[:, :, 0] -= _shifted_matmul_1d(top, w[:, :, 0], 0)
    y[:, :, -1] -= _shifted_matmul_1d(bot, w[:, :, -1], 0)
    y[..., 0] -= _shifted_matmul_1d(lcol, w[..., 0], 1)
    y[..., -1] -= _shifted_matmul_1d(rcol, w[..., -1], 1)
    return y


def up2_conv2d(x: torch.Tensor, w: torch.Tensor, taps=BLUR_TAPS,
               polyphase: bool = False) -> torch.Tensor:
    """conv3x3(upsample[_blur]_2x(x), w) as ONE composed convolution.

    x (N, I, H, W), w (O, I, 3, 3) in x's dtype -> (N, O, 2H, 2W). The
    resampling FIR and the conv kernel compose exactly
    (``compose_up2_kernel``), so the 4x upsampled intermediate is never
    made. Two forms:

    * default: one ``F.conv_transpose2d`` of stride 2 (the lhs-dilated
      conv of the JAX package), its kernel the composed one flipped, in
      and out swapped, padding ``kc - 1 - pad_lo``;
    * ``polyphase=True``: four ``F.conv2d`` at the input's resolution, one
      per output parity class, interleaved as (N, O, H, 2, W, 2).

    ``taps=None`` composes plain nearest-up (ProGAN G), else nearest-up
    + FIR blur (StyleGAN G), whose border ring is then corrected
    (``_up2_blur_ring_correction``).
    """
    k1, kpad = _up2_fir(taps)
    c = compose_up2_kernel(w, taps).to(x.dtype)
    kh = w.shape[2]
    pad_lo = kpad[0] + (kh - 1) // 2
    pad_hi = kpad[1] + kh - 1 - (kh - 1) // 2
    kc = c.shape[2]
    if not polyphase:
        y = F.conv_transpose2d(
            x, c.flip((2, 3)).transpose(0, 1), stride=2,
            padding=kc - 1 - pad_lo, output_padding=pad_hi - pad_lo)
    else:
        n, _, h, wd = x.shape
        phases = []
        for da in (0, 1):
            row = []
            for db in (0, 1):
                # y[2a + da, 2b + db] reads only the taps s with da + s -
                # pad_lo even: c[s0::2], the lowest at x offset -olo
                s0, t0 = (pad_lo + da) % 2, (pad_lo + db) % 2
                ck = c[:, :, s0::2, t0::2]
                oh = -((da + s0 - pad_lo) // 2)
                ow = -((db + t0 - pad_lo) // 2)
                ph, pw = ck.shape[2] - 1 - oh, ck.shape[3] - 1 - ow
                if (oh, ow) == (ph, pw):
                    row.append(F.conv2d(x, ck, padding=(oh, ow)))
                else:
                    row.append(F.conv2d(F.pad(x, (ow, pw, oh, ph)), ck))
            phases.append(torch.stack(row, dim=-1))      # (N, O, H, W, 2)
        y = torch.stack(phases, dim=3).reshape(n, c.shape[0], 2 * h, 2 * wd)
    if taps is None:
        return y          # the box kernel has no tails outside the window
    return _up2_blur_ring_correction(x, w.to(x.dtype), y, k1)


class Up2Conv2dHybrid(torch.autograd.Function):
    """``up2_conv2d`` forward (blur taps, dilated: no 4x intermediate)
    with the TWO-OP backward: the upsampled input is made again by
    ``UpsampleBlur2x`` (the up+blur kernel on the card), the 3x3 conv's
    backward gives the weight's gradient and the upsampled input's, and
    ``BlurDownsample2x`` with gain 4 (the blur+down kernel) takes the
    latter to x. Its gradients are the two-op form's. The backward is
    built of differentiable ops and reads nothing on the host."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return up2_conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        u = UpsampleBlur2x.apply(x)
        kh, kw = w.shape[2:]
        gu, gw, _ = torch.ops.aten.convolution_backward(
            g, u, w, None, [1, 1], [kh // 2, kw // 2], [1, 1], False,
            [0, 0], 1, [need_x, need_w, False])
        gx = BlurDownsample2x.apply(gu, 4.0) if need_x else None
        return gx, gw


def up2_conv2d_hybrid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``up2_conv2d(x, w)`` with the two-op backward (``Up2Conv2dHybrid``);
    blur taps only."""
    return Up2Conv2dHybrid.apply(x, w)

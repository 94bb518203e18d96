"""Width-folded (space-to-depth along W) evaluation of low-channel layers,
NCHW.

Port of ``ganlab_tpu/ops/folded.py`` (``model.fold_width``). A block's
activations are held width-folded,

    (N, C, H, W)  ->  (N, 2C, H, W/2)      [phase-major: ch = p*C + c]

where folded channel ``p*C + c`` at cell ``b`` holds logical pixel
``2b + p`` of channel ``c``: exactly the JAX package's folded
``(N, H, W/2, 2C)`` transposed to NCHW. Every op of the block runs in
folded space with the logical ops' zero padding:

* the 3x3 conv is one conv with a ``(2Co, 2Ci, kh, 3)`` kernel built from
  the logical ``(Co, Ci, kh, 3)`` weight; the slots no tap reaches are
  zero, so padding the cells with zeros is padding the pixels with zeros.
  Twice the multiply-adds of the logical conv;
* the 1x1 conv is a block-diagonal ``(2Co, 2Ci, 1, 1)`` kernel;
* nearest 2x up (+ [1,2,1] blur) makes folded output from an unfolded
  input, and ([1,2,1] blur +) 2x average pool takes a folded input to an
  unfolded output: the W axis's two phases are the two channel groups
  (the polyphase identities), the H axis an ordinary resample;
* noise, bias, LeakyReLU, pixelnorm and AdaIN's instance statistics act
  on a ``(N, 2, C, H, W/2)`` view: the statistics reduce over the same
  sets as the logical ops.

The tensors are contiguous NCHW throughout, so ``fold_w`` and ``unfold_w``
are each a permute and one copy; the resamples make folded output and
take folded input directly, so a G block copies once (its unfold) and a D
block once (its fold). The JAX package runs all of this as plain XLA, with
none of its Pallas kernels, and so does the port: plain PyTorch, on
whatever device the tensor is on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# LeakyReLU is elementwise: the logical op acts on a folded tensor as it
# is, aliased so the folded blocks read uniformly
from ganlab_tpu_torch.ops.equalized import leaky_relu as leaky_relu_folded  # noqa: F401

FOLD = 2  # width fold factor (phase count)


def fold_w(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 2C, H, W/2), phase-major (ch = p*C + c)."""
    n, c, h, w = x.shape
    if w % FOLD:
        raise ValueError(f"fold_w: width {w} is not a multiple of {FOLD}")
    return x.reshape(n, c, h, w // FOLD, FOLD).permute(0, 4, 1, 2, 3) \
        .reshape(n, FOLD * c, h, w // FOLD)


def unfold_w(x_f: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fold_w``: (N, 2C, H, W/2) -> (N, C, H, W)."""
    n, fc, h, wf = x_f.shape
    return x_f.reshape(n, FOLD, fc // FOLD, h, wf).permute(0, 2, 3, 4, 1) \
        .reshape(n, fc // FOLD, h, wf * FOLD)


def _phase_view(x_f: torch.Tensor) -> torch.Tensor:
    """(N, 2C, H, Wf) -> (N, 2, C, H, Wf), a view of a contiguous x_f."""
    n, fc, h, wf = x_f.shape
    return x_f.reshape(n, FOLD, fc // FOLD, h, wf)


def fold_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """Logical (Co, Ci, kh, 3) SAME-conv kernel -> folded (2Co, 2Ci, kh, 3).

    Output phase q at cell b reads logical pixel 2b + q + dw - 1 for the W
    taps dw in 0..2; that pixel lives in cell b + floor(d/2), phase d mod 2,
    with d = q + dw - 1. Slots no tap reaches stay zero. Made from ``w``'s
    own slices and zeros on its device: no copy from the host, which a
    CUDA graph's capture and ``torch.export`` both need.
    """
    co, ci, kh, kw = w.shape
    if kw != 3:
        raise ValueError("folded conv implemented for 3-tap W kernels")
    taps = {}                          # (cell offset, p, q) -> (Co, Ci, kh)
    for q in range(FOLD):
        for dw in range(3):
            d = q + dw - 1
            taps[(d // FOLD, d % FOLD, q)] = w[..., dw]
    zero = w.new_zeros((co, ci, kh))
    cells = [torch.cat([torch.cat([taps.get((cell, p, q), zero)
                                   for p in range(FOLD)], dim=1)
                        for q in range(FOLD)], dim=0)   # (2Co, 2Ci, kh)
             for cell in (-1, 0, 1)]
    return torch.stack(cells, dim=3)


def fold_conv1x1_kernel(w: torch.Tensor) -> torch.Tensor:
    """Logical (Co, Ci, 1, 1) kernel -> block-diagonal (2Co, 2Ci, 1, 1)."""
    co, ci, kh, kw = w.shape
    if kh != 1 or kw != 1:
        raise ValueError(f"fold_conv1x1_kernel: a {kh}x{kw} kernel")
    zero = torch.zeros_like(w)
    return torch.cat([torch.cat([w if p == q else zero for p in range(FOLD)],
                                dim=1) for q in range(FOLD)], dim=0)


def conv2d_folded(x_f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv of the LOGICAL kernel ``w`` (Co, Ci, kh, kw), kw in
    {1, 3}, on a width-folded input; the folded kernel is built at call
    time (small beside the conv)."""
    kh = w.shape[2]
    if w.shape[3] == 1:
        return F.conv2d(x_f, fold_conv1x1_kernel(w), padding=(kh // 2, 0))
    return F.conv2d(x_f, fold_conv_kernel(w), padding=(kh // 2, 1))


def bias_folded(x_f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Add a per-logical-channel bias (C,) to a folded tensor."""
    return x_f + b.to(x_f.dtype).repeat(FOLD)[None, :, None, None]


def pixel_norm_folded(x_f: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """PixelNorm over the LOGICAL channels: per phase, over its C group,
    computed in x's dtype as the JAX op does."""
    v = _phase_view(x_f)
    ms = v.square().mean(dim=2, keepdim=True)
    return (v * torch.rsqrt(ms + eps)).reshape(x_f.shape)


def adain_folded(x_f: torch.Tensor, ys: torch.Tensor, yb: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """AdaIN with instance statistics over the logical (H, W) of each
    channel (the phases and the folded width together), in x's dtype;
    ys / yb: (N, C) style scale and bias."""
    v = _phase_view(x_f)
    mean = v.mean(dim=(1, 3, 4), keepdim=True)
    var = (v - mean).square().mean(dim=(1, 3, 4), keepdim=True)
    norm = (v - mean) * torch.rsqrt(var + eps)
    out = norm * ys.to(x_f.dtype)[:, None, :, None, None] \
        + yb.to(x_f.dtype)[:, None, :, None, None]
    return out.reshape(x_f.shape)


def noise_folded(x_f: torch.Tensor, scale: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    """StyleGAN noise injection on a folded tensor. ``noise`` is the
    LOGICAL single-channel map (N, 1, H, W), folded here, so fold on and
    off consume the same random field."""
    nf = fold_w(noise.to(x_f.dtype))                    # (N, 2, H, Wf)
    out = _phase_view(x_f) \
        + scale.to(x_f.dtype)[None, None, :, None, None] * nf[:, :, None]
    return out.reshape(x_f.shape)


def _up_pair(v: torch.Tensor, dim: int):
    """The two output phases of the [1,2,1]-blurred nearest 2x upsample
    along ``dim``: even = prev/4 + 3 cur/4, odd = 3 cur/4 + next/4, with
    zero padding."""
    n = v.shape[dim]
    pad = [0, 0] * (v.dim() - 1 - dim) + [1, 1]
    vp = F.pad(v, pad)
    prev, cur, nxt = (vp.narrow(dim, s, n) for s in range(3))
    return 0.25 * prev + 0.75 * cur, 0.75 * cur + 0.25 * nxt


def upsample_blur_2x_folded(x: torch.Tensor, blur: bool = True
                            ) -> torch.Tensor:
    """Nearest 2x upsample (+ [1,2,1] FIR) with FOLDED output: input
    (N, C, H, W) unfolded, output (N, 2C, 2H, W) = ``fold_w`` of the
    logical (N, C, 2H, 2W) result. The blur computes in float32 and casts
    back, as the JAX op does."""
    n, c, h, w = x.shape
    if not blur:
        up = x[:, :, :, None].expand(n, c, h, 2, w).reshape(n, c, 2 * h, w)
        return torch.cat([up, up], dim=1)
    even, odd = _up_pair(x.float(), 2)
    y = torch.stack([even, odd], dim=3).reshape(n, c, 2 * h, w)
    return torch.cat(_up_pair(y, 3), dim=1).to(x.dtype)


def blur_downsample_2x_folded(x_f: torch.Tensor, blur: bool = True
                              ) -> torch.Tensor:
    """([1,2,1] FIR +) 2x average pool of a FOLDED input: (N, 2C, H, Wf)
    -> (N, C, H/2, Wf) unfolded (the downsample halves the logical width
    2 Wf back to Wf). Computes in float32 and casts back."""
    n, fc, h, wf = x_f.shape
    c = fc // FOLD
    v = x_f.float()
    p0, p1 = v[:, :c], v[:, c:]                 # logical px 2b, 2b+1
    if not blur:
        y = (0.5 * (p0 + p1)).reshape(n, c, h // 2, 2, wf)
        return (0.5 * (y[:, :, :, 0] + y[:, :, :, 1])).to(x_f.dtype)
    # W: out[b] = p1[b-1]/8 + 3 p0[b]/8 + 3 p1[b]/8 + p0[b+1]/8
    p1m = F.pad(p1, (1, 0))[..., :-1]
    p0p = F.pad(p0, (0, 1))[..., 1:]
    y = 0.125 * p1m + 0.375 * p0 + 0.375 * p1 + 0.125 * p0p
    # H: out[i] = y[2i-1]/8 + 3 y[2i]/8 + 3 y[2i+1]/8 + y[2i+2]/8
    yp = F.pad(y, (0, 0, 1, 1))
    a, b, cc, d = (yp[:, :, s:s + h - 1:2] for s in range(4))
    out = 0.125 * a + 0.375 * b + 0.375 * cc + 0.125 * d
    return out.to(x_f.dtype)

"""Differentiable image augmentation for ADA (StyleGAN2-ADA, Karras et al.
2020) on NCHW images.

Port of ``ganlab_tpu/ops/augment.py``. ``sample_params`` draws one
``AugParams`` per batch from a ``torch.Generator``: per-sample transforms of
the categories in ``categories`` (any non-empty subset of ``"bcgfnu"``),
each gated by Bernoulli(p). ``apply_augment`` is a pure function of the
images and the params, in the official pipeline's order:

* ``b`` blit: x-flip, quarter turns and an integer translation with
  half-sample reflection at the edges (two per-sample 1-D gathers);
* ``g`` geometric: isotropic and anisotropic scaling, rotation and a
  fractional translation, composed into one per-sample inverse affine and
  applied as a conditioning quarter turn and two axis-separated 2-tap
  linear resampling passes (the JAX package's Catmull-Smith factoring,
  taken value for value: a 2-D bilinear warp is another function);
* ``c`` color: brightness, contrast, luma flip, hue rotation and saturation
  composed into one per-sample 3x3 matrix and bias (in the image dtype);
* ``f`` filter: the official 4-band frequency filter bank weighted by
  per-sample band gains, one separable 43-tap FIR, applied as two grouped
  convolutions over reflect-padded images;
* ``n`` noise: an additive per-sample RGB field of drawn sigma;
* ``u`` cutout: a half-resolution square zeroed at a uniform centre.

Draws: every value and every gate's uniform ``u`` is drawn on every call,
and a gate fires where ``u < p`` on the device, so the generator's stream
does not depend on ``p`` and ``p`` (a 0-d tensor under ``aug.mode=ada``)
never crosses to the host. The categories draw in the order ``bcgfnu``, so
adding a later category leaves the earlier ones' draws as they were.

Exactness: at p = 0 every sample is returned bit for bit. Linear resampling
at integer coordinates takes one tap with weight 1; the color matrix is the
identity; non-fired filter samples are selected around the convolutions;
the noise field is an exact zero and the cutout mask an exact 1.

Determinism: the per-sample gathers (blit translation, the resampling taps,
the filter's reflect padding) run through ``_take``, whose backward sums
into the source with ``index_put_(accumulate=True)`` (which sorts the
gathered positions and adds each run in order, the channels and every
other dim the index does not vary along riding as one slice a position),
the same bits on every run on either device; ``torch.gather``'s own
backward is an atomic scatter-add on CUDA. The
filter's grouped convolutions are cuDNN's, as deterministic as the
discriminator's convolutions (``torch.backends.cudnn.deterministic``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# Luma axis of official ADA ([1, 1, 1] / sqrt(3)): luma flip, hue rotation
# and saturation act around it in RGB space.
_LUMA = (1.0 / math.sqrt(3.0),) * 3

BRIGHTNESS_STD = 0.2
CONTRAST_STD = 0.5 * math.log(2.0)
SATURATION_STD = 1.0 * math.log(2.0)
MAX_TRANSLATE = 0.125          # fraction of the resolution, official value
SCALE_STD_LOG2 = 0.2           # iso scale ~ 2^N(0, std), official value
ANISO_STD_LOG2 = 0.2           # aniso ratio ~ 2^N(0, std), official value
FRAC_TRANSLATE_STD = 0.125     # fractional translate ~ N(0, std*res)
IMGFILTER_STD = 1.0            # band gain ~ 2^N(0, std), official value
NOISE_STD = 0.1                # noise sigma ~ |N(0, std)|, official value
CUTOUT_SIZE = 0.5              # cutout square side / resolution, official


def _build_filter_bank() -> np.ndarray:
    """The official ADA 4-band frequency filter bank (octave bands).

    sym2 analysis lowpass -> quadrature highpass; the zero-phase product
    filters ``lo2 = conv(lo, lo[::-1])/2`` and ``hi2`` satisfy
    ``lo2 + hi2 = delta``, so the three-level cascade below yields rows that
    sum exactly to a unit impulse: unit band gains mean identity filtering.
    Row i isolates the octave around Nyquist/2^(3-i).
    """
    lo = np.array([-0.12940952255092145, 0.22414386804185735,
                   0.836516303737469, 0.48296291314469025])
    hi = lo * ((-1.0) ** np.arange(lo.size))
    lo2 = np.convolve(lo, lo[::-1]) / 2.0
    hi2 = np.convolve(hi, hi[::-1]) / 2.0
    fb = np.eye(4, 1)                       # (bands, taps), taps grows
    for i in range(1, 4):
        # upsample rows x2 (zero interleave), lowpass, add band i's
        # highpass at the center: the wavelet-packet cascade
        fb = np.dstack([fb, np.zeros_like(fb)]).reshape(4, -1)[:, :-1]
        fb = np.stack([np.convolve(row, lo2) for row in fb])
        c = (fb.shape[1] - hi2.size) // 2
        fb[i, c:c + hi2.size] += hi2
    return fb


_HZ_FBANK = _build_filter_bank()           # (4, 43), rows sum to delta
FILTER_TAPS = _HZ_FBANK.shape[1]

# Expected per-band power of natural images (~1/f spectrum): each band-gain
# draw is normalized to preserve the expected output power under it. The
# weights sum to 1, so the all-ones gain vector (no gate fired) is a fixed
# point and identity stays exact.
_FILTER_EXPECTED_POWER = np.array([10.0, 1.0, 1.0, 1.0]) / 13.0


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    """The constant float32 tensors of the draws on ``device``, made once a
    device: a copy from the host waits for the device's queue to drain."""
    v = torch.tensor(_LUMA, dtype=torch.float32)
    k = torch.tensor([[0.0, -_LUMA[2], _LUMA[1]],
                      [_LUMA[2], 0.0, -_LUMA[0]],
                      [-_LUMA[1], _LUMA[0], 0.0]], dtype=torch.float32)
    host = {"eye": torch.eye(3), "vv": torch.outer(v, v), "k": k,
            "ep": torch.tensor(_FILTER_EXPECTED_POWER, dtype=torch.float32),
            "bank": torch.tensor(_HZ_FBANK, dtype=torch.float32)}
    return {name: t.to(device) for name, t in host.items()}


def _normalize_filter_gain(t: torch.Tensor) -> torch.Tensor:
    """Normalize a (B, 4) float32 band-gain vector to unit expected output
    power."""
    ep = _constants(t.device)["ep"]
    return t / torch.sqrt((ep * t.square()).sum(dim=1, keepdim=True))


@dataclasses.dataclass
class AugParams:
    """Per-sample transform draws of one batch (``sample_params``);
    ``apply_augment`` is a pure function of these. The fields of a category
    that was not drawn are None."""

    flip: torch.Tensor                 # (B,) bool: x-flip
    rot_k: torch.Tensor                # (B,) int64 0..3: quarter turns
    trans: torch.Tensor                # (B, 2) int64 (ty, tx) pixel shifts
    color_mat: torch.Tensor            # (B, 3, 3) float32
    color_bias: torch.Tensor           # (B, 3) float32
    # 'g': per-sample inverse affine (B, 2, 3), centered output (y, x) ->
    # centered input coordinates
    geom: torch.Tensor | None = None
    # 'f': per-sample separable FIR (B, FILTER_TAPS) and whether any band
    # gate fired (B,) bool (the others bypass the convolutions)
    filt: torch.Tensor | None = None
    filt_active: torch.Tensor | None = None
    # 'n': pre-scaled additive field (B, C, H, W) float32
    noise: torch.Tensor | None = None
    # 'u': (B, 3) = (center_y, center_x, size) in units of the resolution;
    # size 0 cuts nothing
    cutout: torch.Tensor | None = None

    def to(self, device) -> "AugParams":
        return AugParams(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def _rotation_about_luma(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation matrices (B, 3, 3) about the luma axis."""
    const = _constants(theta.device)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    return const["eye"] * c + const["k"] * s + const["vv"] * (1.0 - c)


def sample_params(gen: torch.Generator, batch: int, res: int, p,
                  categories: str = "bc", channels: int = 3) -> AugParams:
    """Draw per-sample transforms on ``gen``'s device, each gated by
    Bernoulli(``p``) (a float or a 0-d float32 tensor on that device),
    in float32."""
    dev = gen.device
    const = _constants(dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def gate():
        return uniform(batch) < p

    def signed_uniform(lim):
        return (uniform(batch) * 2.0 - 1.0) * lim

    flip = torch.zeros((batch,), dtype=torch.bool, device=dev)
    rot_k = torch.zeros((batch,), dtype=torch.int64, device=dev)
    trans = torch.zeros((batch, 2), dtype=torch.int64, device=dev)
    if "b" in categories:
        flip = gate()
        fired = gate()
        rot_k = torch.where(fired, torch.randint(
            0, 4, (batch,), generator=gen, device=dev), 0)
        max_t = max(int(round(res * MAX_TRANSLATE)), 1)
        fired = gate()
        trans = torch.where(fired[:, None], torch.randint(
            -max_t, max_t + 1, (batch, 2), generator=gen, device=dev), 0)

    eye, vv = const["eye"], const["vv"]
    mat = eye.expand(batch, 3, 3)
    bias = torch.zeros((batch, 3), device=dev)
    if "c" in categories:
        # the official order: brightness, contrast, luma flip, hue,
        # saturation; each factor is I unless its gate fires
        b = torch.where(gate(), normal(batch) * BRIGHTNESS_STD, 0.0)
        bias = bias + b[:, None]                       # on [-1, 1] RGB
        c = torch.where(gate(), torch.exp(normal(batch) * CONTRAST_STD), 1.0)
        mat = mat * c[:, None, None]
        bias = bias * c[:, None]
        flip_m = torch.where(gate()[:, None, None], eye - 2.0 * vv, eye)
        for m in (flip_m,
                  _rotation_about_luma(torch.where(
                      gate(), signed_uniform(math.pi), 0.0)),
                  vv + (eye - vv) * torch.where(
                      gate(), torch.exp(normal(batch) * SATURATION_STD),
                      1.0)[:, None, None]):
            mat = m @ mat
            bias = (m @ bias[:, :, None])[:, :, 0]

    geom = None
    if "g" in categories:
        geom = _geom_inverse(gate, normal, signed_uniform, batch, res)

    filt = filt_active = None
    if "f" in categories:
        bank = const["bank"]
        gains = torch.ones((batch, bank.shape[0]), device=dev)
        filt_active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        for i in range(bank.shape[0]):
            fired = gate()
            t = torch.ones((batch, bank.shape[0]), device=dev)
            t[:, i] = torch.where(
                fired, torch.exp2(normal(batch) * IMGFILTER_STD), 1.0)
            gains = gains * _normalize_filter_gain(t)
            filt_active = filt_active | fired
        filt = gains @ bank

    noise = None
    if "n" in categories:
        sigma = torch.where(gate(), normal(batch).abs() * NOISE_STD, 0.0)
        noise = normal(batch, channels, res, res) * sigma[:, None, None, None]

    cutout = None
    if "u" in categories:
        size = torch.where(gate(), CUTOUT_SIZE, 0.0)
        cutout = torch.cat([uniform(batch, 2), size[:, None]], dim=1)

    return AugParams(flip=flip, rot_k=rot_k, trans=trans, color_mat=mat,
                     color_bias=bias, geom=geom, filt=filt,
                     filt_active=filt_active, noise=noise, cutout=cutout)


def _geom_inverse(gate, normal, signed_uniform, batch: int,
                  res: int) -> torch.Tensor:
    """Per-sample inverse affines (B, 2, 3): the forward transform
    ``A = R(theta) @ diag(r, 1/r) * s`` about the image center plus a
    fractional translation ``t``, each factor gated, returned as
    ``[A^-1 | -A^-1 t]`` (output -> input coordinates)."""
    s = torch.where(gate(), torch.exp2(normal(batch) * SCALE_STD_LOG2), 1.0)
    theta = torch.where(gate(), signed_uniform(math.pi), 0.0)
    r = torch.where(gate(), torch.exp2(normal(batch) * ANISO_STD_LOG2), 1.0)
    t = torch.where(gate()[:, None],
                    normal(batch, 2) * (FRAC_TRANSLATE_STD * res), 0.0)
    c, sn = torch.cos(theta), torch.sin(theta)
    # A^-1 = diag(1/r, r) @ R(-theta) / s
    row0 = torch.stack([c / r, sn / r], dim=-1)
    row1 = torch.stack([-sn * r, c * r], dim=-1)
    a_inv = torch.stack([row0, row1], dim=1) / s[:, None, None]
    b = -(a_inv @ t[:, :, None])[:, :, 0]
    return torch.cat([a_inv, b[:, :, None]], dim=-1)


def _index_put_sum(shape, dim: int, index: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """zeros(shape) with ``src`` summed in along ``dim`` at ``index`` (which
    broadcasts to src's shape), by ``index_put_(accumulate=True)``: the
    positions are sorted and each run of equal ones summed in order, the
    same bits on every run (module docstring, Determinism). The dims the
    index is broadcast over ride along as one slice a position, so only
    the index's own positions are sorted (B x H for a row shift, H + 42
    for the filter's padding, not every element)."""
    keep = [d for d in range(src.dim()) if d == dim or index.shape[d] != 1]
    perm = keep + [d for d in range(src.dim()) if d not in keep]
    idx = index.permute(perm)[(...,) + (0,) * (src.dim() - len(keep))]
    where = [idx if d == dim else torch.arange(
        src.shape[d], device=src.device).view(
        [-1 if k == i else 1 for k in range(len(keep))])
        for i, d in enumerate(keep)]
    out = src.new_zeros([shape[d] for d in perm])
    out.index_put_(tuple(where), src.permute(perm), accumulate=True)
    return out.permute([perm.index(d) for d in range(src.dim())])


class _Take(torch.autograd.Function):
    """``x.gather(dim, index)`` (``index`` broadcast to the output) with a
    deterministic backward."""

    @staticmethod
    def forward(ctx, x, index, dim):
        ctx.save_for_backward(index)
        ctx.dim, ctx.shape = dim, x.shape
        shape = list(x.shape)
        shape[dim] = index.shape[dim]
        return x.gather(dim, index.expand(shape))

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return _index_put_sum(ctx.shape, ctx.dim, index, grad), None, None


def _take(x: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    """Gather along ``dim`` with an index that broadcasts to the output's
    shape (x's, with ``index``'s size along ``dim``)."""
    return _Take.apply(x, index, dim)


def _reflect(idx: torch.Tensor, res: int) -> torch.Tensor:
    """Out-of-range indices into [0, res) by half-sample reflection (the
    edge repeats; period 2 res)."""
    t = torch.remainder(idx, 2 * res)
    return torch.where(t >= res, 2 * res - 1 - t, t)


def _reflect_pad_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of an axis of length ``n`` padded by
    ``pad`` on both sides with whole-sample reflection (``np.pad``'s
    ``reflect``: the edge does not repeat), reflecting again and again
    where ``pad`` >= ``n``: a triangle wave of period 2 (n - 1).
    ``F.pad(mode="reflect")`` refuses a pad of ``n`` or more, which the
    43-tap filter needs at every resolution below 22."""
    period = 2 * (n - 1)
    t = torch.remainder(torch.arange(-pad, n + pad, device=device), period)
    return torch.where(t >= n, period - t, t)


def _apply_blit(x: torch.Tensor, params: AugParams, res: int) -> torch.Tensor:
    """x-flip, quarter turns (``out[y, x] = in[res-1-x, y]`` at k = 1) and
    the reflected integer translation, in that order."""
    out = torch.where(params.flip[:, None, None, None], x.flip(3), x)
    k = params.rot_k[:, None, None, None]
    out = torch.where(k == 1, torch.rot90(out, -1, (2, 3)),
                      torch.where(k == 2, torch.rot90(out, 2, (2, 3)),
                                  torch.where(k == 3,
                                              torch.rot90(out, 1, (2, 3)),
                                              out)))
    o = torch.arange(res, device=x.device)
    iy = _reflect(o[None, :] - params.trans[:, 0, None], res)
    ix = _reflect(o[None, :] - params.trans[:, 1, None], res)
    out = _take(out, iy[:, None, :, None], 2)
    return _take(out, ix[:, None, None, :], 3)


def _resample_pass(x: torch.Tensor, f: torch.Tensor, res: int,
                   dim: int) -> torch.Tensor:
    """1-D linear resample of NCHW ``x`` along H (dim 2) or W (dim 3):
    ``f`` (B, H, W) is each output's source coordinate along ``dim``; the
    two taps reflect at the edges, the weights are in x's dtype. At an
    integer coordinate the second tap's weight is 0: an exact copy."""
    i0 = torch.floor(f)
    w = f - i0
    i0 = i0.long()
    w0, w1 = (1.0 - w).to(x.dtype)[:, None], w.to(x.dtype)[:, None]
    return (w0 * _take(x, _reflect(i0, res)[:, None], dim)
            + w1 * _take(x, _reflect(i0 + 1, res)[:, None], dim))


def _apply_geom(x: torch.Tensor, geom: torch.Tensor, res: int) -> torch.Tensor:
    """Per-sample affine warp as two axis-separated resampling passes.

    The inverse map ``F(o) = G o + t`` is factored into an exact per-sample
    quarter turn (taken where it enlarges |h|, so the residual stays well
    conditioned at rotations near 90 degrees), an x-pass (a, b, g) and a
    y-pass (h, i, j), with ``G' = [[h, i], [b h, a + b i]]`` solved in
    closed form. The result is exact on images linear in the coordinates
    and at every integer landing."""
    g00, g01, ty = geom[:, 0, 0], geom[:, 0, 1], geom[:, 0, 2]
    g10, g11, tx = geom[:, 1, 0], geom[:, 1, 1], geom[:, 1, 2]
    use_rot = g10.abs() > g00.abs()
    x0 = torch.where(use_rot[:, None, None, None],
                     torch.rot90(x, -1, (2, 3)), x)
    # residual [G'|t'] = Q^-1 [G|t] (Q^-1 = [[0, 1], [-1, 0]]) when rotated
    h = torch.where(use_rot, g10, g00)
    i = torch.where(use_rot, g11, g01)
    j = torch.where(use_rot, tx, ty)
    bb = torch.where(use_rot, -g00, g10) / h
    a = torch.where(use_rot, -g01, g11) - bb * i
    gg = torch.where(use_rot, -ty, tx) - bb * j

    c0 = float(np.float32((res - 1) / 2.0))
    o = torch.arange(res, dtype=torch.float32, device=x.device) - c0
    vy, vx = o[None, :, None], o[None, None, :]

    def col(v):
        return v[:, None, None]

    fx = col(a) * vx + col(bb) * vy + col(gg) + c0
    out = _resample_pass(x0, fx, res, dim=3)
    fy = col(h) * vy + col(i) * vx + col(j) + c0
    return _resample_pass(out, fy, res, dim=2)


def _sep_filter_pass(x: torch.Tensor, w: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Per-sample 1-D FIR along H (dim 2) or W (dim 3) of NCHW ``x``, the
    reflect-padded images folded into one grouped convolution of B * C
    channels (the bank's rows are palindromes: correlation is
    convolution)."""
    b, c, h, wd = x.shape
    taps = w.shape[1]
    pad = taps // 2
    idx = _reflect_pad_index(x.shape[dim], pad, x.device)
    xp = _take(x, idx.view([-1 if k == dim else 1 for k in range(4)]), dim)
    xp = xp.reshape(1, b * c, *xp.shape[2:])
    k = w.to(x.dtype)[:, None].expand(b, c, taps).reshape(b * c, 1, taps)
    k = k[..., None] if dim == 2 else k[:, :, None, :]
    return F.conv2d(xp, k, groups=b * c).reshape(b, c, h, wd)


def _apply_filter(x: torch.Tensor, filt: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    y = _sep_filter_pass(_sep_filter_pass(x, filt, 2), filt, 3)
    # unit gains make the kernel a delta only up to rounding: the select
    # keeps non-fired samples bit for bit
    return torch.where(active[:, None, None, None], y, x)


def _cutout_mask(cut: torch.Tensor, res: int, dtype) -> torch.Tensor:
    """(B, 1, res, res) keep-mask: zero where both axis distances of the
    pixel centre (i + 0.5) / res to the cut's centre are < size / 2."""
    cy, cx, size = cut[:, 0], cut[:, 1], cut[:, 2]
    coord = (torch.arange(res, dtype=torch.float32, device=cut.device)
             + 0.5) / res
    keep_y = (coord[None, :] - cy[:, None]).abs() >= size[:, None] / 2
    keep_x = (coord[None, :] - cx[:, None]).abs() >= size[:, None] / 2
    keep = keep_y[:, :, None] | keep_x[:, None, :]
    return keep[:, None].to(dtype)


def apply_augment(x: torch.Tensor, params: AugParams) -> torch.Tensor:
    """The drawn transforms on NCHW images in [-1, 1] (square, 3 channels),
    in the images' dtype; differentiable with respect to ``x``."""
    res = x.shape[2]
    if x.shape[3] != res:
        raise ValueError(f"apply_augment: square images only, got "
                         f"{tuple(x.shape)}")
    out = _apply_blit(x, params, res)
    if params.geom is not None:
        out = _apply_geom(out, params.geom, res)
    mat = params.color_mat.to(out.dtype)
    bias = params.color_bias.to(out.dtype)
    out = torch.einsum("bchw,bdc->bdhw", out, mat) + bias[:, :, None, None]
    if params.filt is not None:
        out = _apply_filter(out, params.filt, params.filt_active)
    if params.noise is not None:
        # sigma 0 adds an exact zero field
        out = out + params.noise.to(out.dtype)
    if params.cutout is not None:
        # size 0 multiplies by an exact 1
        out = out * _cutout_mask(params.cutout, res, out.dtype)
    return out


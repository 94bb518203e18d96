"""Plain float32 StyleGAN2 generator and residual discriminator.

A frozen copy of the architecture the ``stylegan2-f-256`` configuration
runs, in plain PyTorch, written from the paper (Karras et al. 2019,
"Analyzing and Improving the Image Quality of StyleGAN", config F) and the
configuration file's sizes. It imports nothing of the program; the layers
it shares with StyleGAN (equalized dense and conv layers, the mapping
network, the [1, 2, 1] resampling, the output block with the minibatch
statistic) and the precision control ``Prec`` come from ``model``.
Parameters are a dict of float32 tensors named as the program's
``state_dict`` names them.

* Mapping: pixelnorm(z), then ``mapping_layers`` dense + LeakyReLU(0.2)
  at ``mapping_lr_mult`` (``model.mapping``).
* Modulated conv, in the paper's weight-side form (eq. 1-3): the style
  s = A(w) (an equalized dense layer, its bias starting at 1) scales the
  weight per sample, W'_n = c W s_n with c = gain / sqrt(fan_in), the
  demodulation divides each output channel by sqrt(sum W'_n^2 + 1e-8),
  and one grouped convolution (a group a sample) applies W'_n to sample
  n. The program computes the same product on the activation side
  (modulate the input, one shared conv, demodulate the output), so the
  two are held to each other across two summation orders.
* A style layer: modulated 3x3 conv -> per-channel scale times one noise
  image -> bias -> LeakyReLU(0.2) x sqrt(2).
* Skip generator: a learned 4x4 constant, one style layer at 4x4, and per
  resolution from 8x8 nearest 2x + [1, 2, 1] blur of the features and two
  style layers; every resolution emits RGB through a modulated 1x1 conv
  of gain 1 without demodulation (plus a bias), and the RGB of the
  resolution below, upsampled the same way, is added. Style rows: the
  convs take 0, 1, 2, ... in order and each toRGB the row after its
  resolution's last conv.
* Residual discriminator: fromRGB 1x1 + LeakyReLU; per block a skip
  branch (1x1 conv, gain 1, no bias, then [1, 2, 1] blur + 2x2 average
  pooling) and a main branch (two 3x3 convs with LeakyReLU, then the same
  blur + pooling), summed and scaled by 1/sqrt(2); the output block over
  the whole batch as StyleGAN's (``model.d_head``).

Departures from the paper's config F, all the program's (and the
configuration file's): the resampling filter is nearest 2x + [1, 2, 1]
(config F: the [1, 3, 3, 1] FIR of upfirdn2d); the minibatch statistic
takes one group of the whole batch (config F: groups of 4); the noise
images are drawn with the step's other inputs (as the program draws
them); the learning rate (0.001 against 0.002) and the R1 weight belong
to the step (``train_sg2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import model as M
from portbench.reference.model import F32, SQRT2, log2_res, lrelu, nf


def num_style_layers(m: dict) -> int:
    return 2 * (log2_res(m) - 1)


def noise_shapes(m: dict) -> list:
    """(H, W) of each noise image: one at 4x4, then two a resolution."""
    return [(4, 4)] + [(2 ** lg, 2 ** lg)
                       for lg in range(3, log2_res(m) + 1) for _ in range(2)]


# -- parameters --------------------------------------------------------------
def _modulated(prefix: str, z: int, cin: int, cout: int, k: int,
               noise: bool) -> list:
    out = [(f"{prefix}.affine.w", (z, cin), "w", 1.0),
           (f"{prefix}.affine.b", (cin,), "scale_b", 1.0),
           (f"{prefix}.w", (cout, cin, k, k), "w", 1.0)]
    if noise:
        out.append((f"{prefix}.noise.scale", (cout,), "noise", 1.0))
    return out + [(f"{prefix}.b", (cout,), "b", 1.0)]


def g_spec(m: dict) -> list:
    """(name, shape, kind, lr_mult) of every generator parameter (kinds
    as ``model.make_params`` reads them)."""
    z, lrm, L = m["latent_dim"], m["mapping_lr_mult"], log2_res(m)
    out = []
    for i in range(m["mapping_layers"]):
        out += [(f"mapping.fc{i}.w", (z, z), "w", lrm),
                (f"mapping.fc{i}.b", (z,), "b", lrm)]
    c1 = nf(m, 1)
    out.append(("synthesis.const.const", (1, c1, 4, 4), "const", 1.0))
    out += _modulated("synthesis.conv4", z, c1, c1, 3, True)
    for lg in range(3, L + 1):
        p, cin, c = f"synthesis.block{2 ** lg}", nf(m, lg - 2), nf(m, lg - 1)
        out += _modulated(f"{p}.conv0", z, cin, c, 3, True)
        out += _modulated(f"{p}.conv1", z, c, c, 3, True)
    for lg in range(2, L + 1):
        out += _modulated(f"synthesis.torgb{2 ** lg}.conv", z, nf(m, lg - 1),
                          m["img_channels"], 1, False)
    return out


def d_spec(m: dict) -> list:
    """StyleGAN's discriminator parameters and, per block, the skip
    branch's 1x1 weight."""
    return M.d_spec(m) + [
        (f"block{2 ** lg}.skip.w", (nf(m, lg - 2), nf(m, lg - 1), 1, 1), "w",
         1.0) for lg in range(3, log2_res(m) + 1)]


# -- generator ---------------------------------------------------------------
def modulated_conv(P, name, x, w, prec=F32, demodulate=True, gain=SQRT2):
    """The weight-side modulated conv of ``name`` on x (N, I, H, W) under
    the latents w (N, z): one grouped convolution, a group a sample."""
    s = M.dense(P, name + ".affine", w, prec, gain=1.0)          # (N, I)
    W = P[name + ".w"]
    o, i, k, _ = W.shape
    wn = (W * (gain / math.sqrt(i * k * k)))[None] \
        * s[:, None, :, None, None]                              # (N, O, I)
    if demodulate:
        wn = wn * torch.rsqrt(wn.square().sum(dim=(2, 3, 4)) + 1e-8)[
            :, :, None, None, None]
    n, _, h, ww = x.shape
    y = F.conv2d(prec.q(x).reshape(1, n * i, h, ww),
                 prec.q(wn).reshape(n * o, i, k, k), padding=k // 2,
                 groups=n)
    return prec.out(y).reshape(n, o, h, ww)


def _layer(P, name, x, w, noise, prec):
    y = modulated_conv(P, name, x, w, prec)
    y = y + P[name + ".noise.scale"][None, :, None, None] * noise
    return lrelu(y + P[name + ".b"][None, :, None, None]) * SQRT2


def _torgb(P, res, x, w, prec):
    name = f"synthesis.torgb{res}.conv"
    y = modulated_conv(P, name, x, w, prec, demodulate=False, gain=1.0)
    return y + P[name + ".b"][None, :, None, None]


def synthesis(P, m, ws, noises, prec=F32):
    """ws (N, L, w) and the noise images (N, 1, H, W) in ``noise_shapes``
    order -> images (N, C, R, R)."""
    n = ws.shape[0]
    x = P["synthesis.const.const"].expand(n, -1, -1, -1)
    x = _layer(P, "synthesis.conv4", x, ws[:, 0], noises[0], prec)
    rgb = _torgb(P, 4, x, ws[:, 1], prec)
    for i, lg in enumerate(range(3, log2_res(m) + 1)):
        p = f"synthesis.block{2 ** lg}"
        x = M.upsample_blur(x)
        x = _layer(P, p + ".conv0", x, ws[:, 2 * i + 1], noises[2 * i + 1],
                   prec)
        x = _layer(P, p + ".conv1", x, ws[:, 2 * i + 2], noises[2 * i + 2],
                   prec)
        rgb = M.upsample_blur(rgb) + _torgb(P, 2 ** lg, x, ws[:, 2 * i + 3],
                                            prec)
    return rgb


# -- discriminator -----------------------------------------------------------
def d_trunk(P, m, img, prec=F32):
    """Images -> the (N, C, 4, 4) input of the output block, through the
    residual blocks: every layer before the minibatch statistic, so it
    can run in blocks of rows."""
    L = log2_res(m)
    x = lrelu(M.conv(P, f"fromrgb{2 ** L}", img, prec))
    for lg in range(L, 2, -1):
        p = f"block{2 ** lg}"
        skip = M.blur_down(M.conv(P, p + ".skip", x, prec, gain=1.0))
        x = lrelu(M.conv(P, p + ".conv0", x, prec))
        x = M.blur_down(lrelu(M.conv(P, p + ".conv1", x, prec)))
        x = (x + skip) * (1.0 / SQRT2)
    return x


d_head = M.d_head

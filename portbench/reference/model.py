"""Plain float32 StyleGAN generator and ProGAN-style discriminator.

A frozen copy of the architecture the benchmark's configurations run, in
plain PyTorch, written from the papers (Karras et al. 2018, StyleGAN;
Karras et al. 2017, ProGAN) and the configuration file's sizes. It
imports nothing of the program. Parameters are a dict of float32 tensors
named as the program's ``state_dict`` names them, which is the format in
which the benchmark hands the same weights to both sides.

* Equalized learning rate: a stored weight is scaled at use by
  ``gain / sqrt(fan_in) * lr_mult``, a bias by ``lr_mult``.
* Mapping: pixelnorm(z), then ``mapping_layers`` dense + LeakyReLU(0.2)
  at ``mapping_lr_mult``.
* Synthesis: a learned 4x4 constant; per style layer noise (a per-channel
  scale times one noise image), bias, LeakyReLU, AdaIN (instance norm with
  the biased variance, eps 1e-8, under the affine style of w); each block
  from 8x8 starts with nearest 2x upsampling and the [1, 2, 1] blur; the
  block's convs are 3x3 without bias; toRGB is a 1x1 conv of gain 1.
* Discriminator: fromRGB 1x1, per block two 3x3 convs with LeakyReLU then
  the [1, 2, 1] blur and 2x2 average pooling; at 4x4 the whole-batch
  minibatch standard deviation channel, a 3x3 conv, a dense layer over the
  (h, w, c)-ordered features and a dense score of gain 1.

``Prec`` says in which precision the convolutions and dense layers run:
float32 (the reference), or float8 (the control, the precision below the
configuration's bfloat16): operands in e4m3 and the output's gradient in
e5m2, as an fp8 GEMM takes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def _fp8(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to the float8 format ``fmt`` under a per-tensor scale
    that maps its largest magnitude to the format's largest."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = torch.finfo(fmt).max / amax
    return (t * s).to(fmt).to(t.dtype) / s


class _Round(torch.autograd.Function):
    """float8 e4m3 forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 (the
    gradients of an fp8 GEMM), itself differentiable for R1."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _RoundE5M2.apply(g)


class _RoundE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return _fp8(g, torch.float8_e5m2)

    @staticmethod
    def backward(ctx, gg):
        return gg


class Prec:
    """Precision of the convs' and dense layers' GEMMs: float32, or float8
    (operands e4m3, the gradient of the output e5m2, each under a
    per-tensor scale), the GEMM and all else in float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _Round.apply(t) if self.fp8 else t

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y) if self.fp8 else y


F32 = Prec(False)
FP8 = Prec(True)


def log2_res(m: dict) -> int:
    return int(round(math.log2(m["resolution"])))


def nf(m: dict, stage: int) -> int:
    """Feature maps at resolution 2**stage (ProGAN's channel rule)."""
    return int(min(max(m["fmap_base"] // 2 ** stage, m["fmap_min"]),
                   m["fmap_max"]))


def num_style_layers(m: dict) -> int:
    return 2 * (log2_res(m) - 1)


def noise_shapes(m: dict) -> list:
    return [(4, 4), (4, 4)] + [(2 ** lg, 2 ** lg)
                               for lg in range(3, log2_res(m) + 1)
                               for _ in range(2)]


# -- parameters --------------------------------------------------------------
# kind: 'w' weight N(0, 1) / lr_mult; 'b' bias; 'scale_b' the AdaIN scale
# head's bias; 'noise' a noise scale; 'const' the constant input.

def g_spec(m: dict) -> list:
    """(name, shape, kind, lr_mult) of every generator parameter."""
    z, lrm, L = m["latent_dim"], m["mapping_lr_mult"], log2_res(m)
    out = []
    for i in range(m["mapping_layers"]):
        out += [(f"mapping.fc{i}.w", (z, z), "w", lrm),
                (f"mapping.fc{i}.b", (z,), "b", lrm)]

    def style(prefix, c):
        return [(f"{prefix}.noise.scale", (c,), "noise", 1.0),
                (f"{prefix}.bias", (c,), "b", 1.0),
                (f"{prefix}.style.scale.w", (z, c), "w", 1.0),
                (f"{prefix}.style.scale.b", (c,), "scale_b", 1.0),
                (f"{prefix}.style.bias.w", (z, c), "w", 1.0),
                (f"{prefix}.style.bias.b", (c,), "b", 1.0)]

    c1 = nf(m, 1)
    out.append(("synthesis.const.const", (1, c1, 4, 4), "const", 1.0))
    out.append(("synthesis.conv4.w", (c1, c1, 3, 3), "w", 1.0))
    out += style("synthesis.style4_0", c1) + style("synthesis.style4_1", c1)
    for lg in range(3, L + 1):
        p, cin, c = f"synthesis.block{2 ** lg}", nf(m, lg - 2), nf(m, lg - 1)
        out.append((f"{p}.conv0.w", (c, cin, 3, 3), "w", 1.0))
        out += style(f"{p}.style0", c)
        out.append((f"{p}.conv1.w", (c, c, 3, 3), "w", 1.0))
        out += style(f"{p}.style1", c)
    for lg in range(2, L + 1):
        c = nf(m, lg - 1)
        out += [(f"synthesis.torgb{2 ** lg}.w", (m["img_channels"], c, 1, 1),
                 "w", 1.0),
                (f"synthesis.torgb{2 ** lg}.b", (m["img_channels"],), "b",
                 1.0)]
    return out


def d_spec(m: dict) -> list:
    """(name, shape, kind, lr_mult) of every discriminator parameter."""
    L, c1 = log2_res(m), nf(m, 1)
    out = []
    for lg in range(2, L + 1):
        c = nf(m, lg - 1)
        out += [(f"fromrgb{2 ** lg}.w", (c, m["img_channels"], 1, 1), "w", 1.0),
                (f"fromrgb{2 ** lg}.b", (c,), "b", 1.0)]
    for lg in range(3, L + 1):
        ci, co = nf(m, lg - 1), nf(m, lg - 2)
        p = f"block{2 ** lg}"
        out += [(f"{p}.conv0.w", (ci, ci, 3, 3), "w", 1.0),
                (f"{p}.conv0.b", (ci,), "b", 1.0),
                (f"{p}.conv1.w", (co, ci, 3, 3), "w", 1.0),
                (f"{p}.conv1.b", (co,), "b", 1.0)]
    out += [("block4_out.conv.w", (c1, c1 + 1, 3, 3), "w", 1.0),
            ("block4_out.conv.b", (c1,), "b", 1.0),
            ("block4_out.dense.w", (c1 * 16, c1), "w", 1.0),
            ("block4_out.dense.b", (c1,), "b", 1.0),
            ("block4_out.score.w", (c1, 1), "w", 1.0),
            ("block4_out.score.b", (1,), "b", 1.0)]
    return out


def make_params(spec: list, seed: int, device) -> dict:
    """Seeded random float32 parameters on ``device``: one normal draw of
    the whole network from a generator on the device, cut in ``spec``'s
    order. Weights N(0, 1) / lr_mult (the program's init); biases, noise
    scales and the AdaIN scale bias's offset from 1 are N(0, 0.1^2), so
    that every path (noise included) carries signal."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, _, _ in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, lrm in spec:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            v = v / lrm
        elif kind == "b":
            v = 0.1 * v / lrm
        elif kind == "scale_b":
            v = 1.0 + 0.1 * v
        elif kind == "noise":
            v = 0.1 * v
        out[name] = v.clone()
    return out


# -- layers ------------------------------------------------------------------
def lrelu(x):
    return F.leaky_relu(x, 0.2)


def dense(P, name, x, prec, gain=SQRT2, lrm=1.0):
    w = P[name + ".w"]
    y = prec.out(prec.q(x) @ prec.q(w * (gain / math.sqrt(w.shape[0])
                                         * lrm)))
    b = P.get(name + ".b")
    return y if b is None else y + b * lrm


def conv(P, name, x, prec, gain=SQRT2):
    w = P[name + ".w"]
    fan = w.shape[1] * w.shape[2] * w.shape[3]
    y = prec.out(F.conv2d(prec.q(x), prec.q(w * (gain / math.sqrt(fan))),
                          padding=w.shape[-1] // 2))
    b = P.get(name + ".b")
    return y if b is None else y + b[None, :, None, None]


def _blur_axis(x, dim):
    """[1, 2, 1] / 4 along ``dim`` (2 or 3) with zero padding."""
    pad = (0, 0, 1, 1) if dim == 2 else (1, 1)
    v = F.pad(x, pad)
    n = x.shape[dim]
    return (v.narrow(dim, 0, n) + 2.0 * v.narrow(dim, 1, n)
            + v.narrow(dim, 2, n)) * 0.25


def _blur(x):
    """The separable [1, 2, 1] blur, outer([1, 2, 1], [1, 2, 1]) / 16."""
    return _blur_axis(_blur_axis(x, 2), 3)


def upsample_blur(x):
    """Nearest 2x, then the [1, 2, 1] blur with zero padding."""
    n, c, h, w = x.shape
    up = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
    return _blur(up.reshape(n, c, 2 * h, 2 * w))


def blur_down(x):
    """The [1, 2, 1] blur with zero padding, then 2x2 average pooling."""
    b = _blur(x)
    n, c, h, w = b.shape
    return b.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def pixelnorm(x):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


def instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-8)


# -- generator ---------------------------------------------------------------
def mapping(P, m, z, prec=F32):
    x = pixelnorm(z)
    for i in range(m["mapping_layers"]):
        x = lrelu(dense(P, f"mapping.fc{i}", x, prec,
                        lrm=m["mapping_lr_mult"]))
    return x


def _style_layer(P, prefix, x, w, noise, prec):
    x = x + P[prefix + ".noise.scale"][None, :, None, None] * noise
    x = lrelu(x + P[prefix + ".bias"][None, :, None, None])
    ys = dense(P, prefix + ".style.scale", w, prec, gain=1.0)
    yb = dense(P, prefix + ".style.bias", w, prec, gain=1.0)
    return ys[:, :, None, None] * instance_norm(x) + yb[:, :, None, None]


def synthesis(P, m, ws, noises, prec=F32):
    """ws (N, L, w) and the noise images (N, 1, H, W) in ``noise_shapes``
    order -> images (N, C, R, R)."""
    n = ws.shape[0]
    x = P["synthesis.const.const"].expand(n, -1, -1, -1)
    x = _style_layer(P, "synthesis.style4_0", x, ws[:, 0], noises[0], prec)
    x = conv(P, "synthesis.conv4", x, prec)
    x = _style_layer(P, "synthesis.style4_1", x, ws[:, 1], noises[1], prec)
    L = log2_res(m)
    for i, lg in enumerate(range(3, L + 1)):
        p = f"synthesis.block{2 ** lg}"
        x = conv(P, p + ".conv0", upsample_blur(x), prec)
        x = _style_layer(P, p + ".style0", x, ws[:, 2 * i + 2],
                         noises[2 * i + 2], prec)
        x = conv(P, p + ".conv1", x, prec)
        x = _style_layer(P, p + ".style1", x, ws[:, 2 * i + 3],
                         noises[2 * i + 3], prec)
    return conv(P, f"synthesis.torgb{2 ** L}", x, prec, gain=1.0)


# -- discriminator -----------------------------------------------------------
def d_trunk(P, m, img, prec=F32):
    """Images -> the (N, C, 4, 4) input of the output block: every layer
    before the minibatch statistic, so it can run in blocks of rows."""
    L = log2_res(m)
    x = lrelu(conv(P, f"fromrgb{2 ** L}", img, prec))
    for lg in range(L, 2, -1):
        p = f"block{2 ** lg}"
        x = lrelu(conv(P, p + ".conv0", x, prec))
        x = blur_down(lrelu(conv(P, p + ".conv1", x, prec)))
    return x


def d_head(P, h, prec=F32):
    """The output block over the whole batch: minibatch stddev (one group),
    conv, dense, score -> (N,)."""
    n, _, hh, ww = h.shape
    mean = h.mean(dim=0, keepdim=True)
    stat = torch.sqrt((h - mean).square().mean(dim=0) + 1e-8).mean()
    x = torch.cat([h, stat.expand(n, 1, hh, ww)], dim=1)
    x = lrelu(conv(P, "block4_out.conv", x, prec))
    x = x.permute(0, 2, 3, 1).reshape(n, -1)
    x = lrelu(dense(P, "block4_out.dense", x, prec))
    return dense(P, "block4_out.score", x, prec, gain=1.0)[:, 0]

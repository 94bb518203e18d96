"""Multiply-accumulates of the StyleGAN G and the ProGAN-style D, forward,
an image, from the configuration's sizes; and the model FLOPs of a
training step and a served batch.

Counted: every convolution (3x3 and 1x1) and dense layer, the mapping
network and the AdaIN style affines included. Not counted: elementwise
work, resampling, normalization, the minibatch statistic, and anything a
program recomputes (remat). A backward pass is counted as twice its
forward (the gradients of the input and of the weights); a pass that
needs only the input's gradient as once.
"""

from __future__ import annotations

from portbench.reference.model import log2_res, nf


def _conv(cin, cout, k, res):
    return cin * cout * k * k * res * res


def g_block_macs(m: dict, lg: int) -> int:
    """The synthesis block at 2**lg: its two 3x3 convs, an image."""
    r, cin, c = 2 ** lg, nf(m, lg - 2), nf(m, lg - 1)
    return _conv(cin, c, 3, r) + _conv(c, c, 3, r)


def mapping_macs(m: dict) -> int:
    return m["mapping_layers"] * m["latent_dim"] ** 2


def g_forward_macs(m: dict) -> int:
    """Synthesis (4x4 conv, the blocks, toRGB at the top resolution, two
    style affines a style layer) an image, without the mapping."""
    L, z = log2_res(m), m["latent_dim"]
    macs = _conv(nf(m, 1), nf(m, 1), 3, 4)
    macs += sum(g_block_macs(m, lg) for lg in range(3, L + 1))
    macs += _conv(nf(m, L - 1), m["img_channels"], 1, 2 ** L)
    affines = sum(2 * z * nf(m, lg - 1) * 2 for lg in range(2, L + 1))
    return macs + affines


def d_forward_macs(m: dict) -> int:
    L, c1 = log2_res(m), nf(m, 1)
    macs = _conv(m["img_channels"], nf(m, L - 1), 1, 2 ** L)
    for lg in range(3, L + 1):
        ci, co, r = nf(m, lg - 1), nf(m, lg - 2), 2 ** lg
        macs += _conv(ci, ci, 3, r) + _conv(ci, co, 3, r)
    macs += _conv(c1 + 1, c1, 3, 4) + c1 * 16 * c1 + c1
    return macs


def train_step_flops(m: dict, batch: int, r1: bool) -> float:
    """Model FLOPs of one sequential step at ``batch``.

    D phase: G forward (no grad); D forward on reals and fakes and their
    backward (2 x 3 D). G phase: G forward, D forward, D backward to the
    images only (1 D), G backward (2 G). R1: a third D forward, its first
    backward to the images (1 D) and the second-order pass through both
    (4 D). The mapping runs over z1 and z2 (2 x the batch)."""
    g = g_forward_macs(m) + 2 * mapping_macs(m)
    d = d_forward_macs(m)
    macs = 4 * g + 8 * d + (6 * d if r1 else 0)
    return 2.0 * macs * batch


def serve_batch_flops(m: dict, batch: int) -> float:
    """Model FLOPs of one served batch: the mapping and synthesis."""
    return 2.0 * (g_forward_macs(m) + mapping_macs(m)) * batch

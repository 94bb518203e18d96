"""The work of a StyleGAN2 training step, counted from the configuration's
shapes: the model FLOPs of its convolutions and dense layers, and the
bytes and FLOPs of each pass of the hand-written ops it runs, as
``flops`` and ``ops`` count StyleGAN's.

Counted as FLOPs: every modulated convolution (3x3 and the 1x1 toRGB), the
style affine of each, the demodulation's product of the squared styles
with the weights' squared sums (O x I a sample), the mapping network, and
in the residual discriminator the 1x1 skip convolution of every block
beside the ProGAN-style convolutions and dense layers. Not counted:
elementwise work, resampling, normalization, the minibatch statistic. A
backward pass counts twice its forward (the gradients of the input and of
the weights); a pass that needs only the input's gradient once.

Path length (at ``pl_rows`` = batch // ``pl_batch_shrink``): the mapping
and synthesis forward, the gradient with respect to the styles (the input
gradients alone, 1 x the synthesis), and the outer backward through both
(2 x for the forward's nodes, 2 x for the first gradient's): 6 x the
synthesis and 3 x the mapping, as R1 is 6 x D.

The hand-written ops' passes a step runs (``instances``), each at its
input shape, as ``chip_smoke.stylegan2_step_launches`` derives the
launches: up+blur once a synthesis block on the features and once on the
RGB (from 8x8), blur+down twice a residual D block (the main branch and
the skip), the minibatch statistic once a D forward, pixelnorm once a
mapping pass. The path-length term's outer backward runs up+blur's
backward's backward, an up+blur of a gradient at the forward's shape,
on the features (the RGB's first-order backward acts on the projection
alone, which has no graph): it is counted as an up+blur forward, the
pass that ``kernels/upsample_blur.json`` names for that kernel. AdaIN
does not run.
"""

from __future__ import annotations

import math

from portbench.reference.model import log2_res, nf
from portbench.work import flops, ops


def _conv(cin, cout, k, res):
    return cin * cout * k * k * res * res


def synthesis_macs(m: dict) -> int:
    """The skip synthesis an image: the modulated convs with their style
    affines and demodulation products, and every toRGB."""
    L, z, C = log2_res(m), m["latent_dim"], m["img_channels"]

    def layer(cin, cout, k, res, demod=True):
        return _conv(cin, cout, k, res) + z * cin + (cin * cout if demod
                                                     else 0)

    c1 = nf(m, 1)
    macs = layer(c1, c1, 3, 4)
    for lg in range(3, L + 1):
        cin, c, r = nf(m, lg - 2), nf(m, lg - 1), 2 ** lg
        macs += layer(cin, c, 3, r) + layer(c, c, 3, r)
    for lg in range(2, L + 1):
        macs += layer(nf(m, lg - 1), C, 1, 2 ** lg, demod=False)
    return macs


def d_forward_macs(m: dict) -> int:
    """The residual D an image: StyleGAN's D and a 1x1 skip a block."""
    skips = sum(_conv(nf(m, lg - 1), nf(m, lg - 2), 1, 2 ** lg)
                for lg in range(3, log2_res(m) + 1))
    return flops.d_forward_macs(m) + skips


def pl_rows(c: dict, batch: int) -> int:
    return max(batch // max(c["loss"]["pl_batch_shrink"], 1), 1)


def train_step_flops(m: dict, batch: int, r1: bool, pl: bool,
                     rows: int) -> float:
    """Model FLOPs of one sequential step at ``batch`` (StyleGAN's count,
    ``flops.train_step_flops``, over these networks), with R1 where
    ``r1`` and path length on ``rows`` rows where ``pl``."""
    g = synthesis_macs(m) + 2 * flops.mapping_macs(m)
    d = d_forward_macs(m)
    macs = batch * (4 * g + 8 * d + (6 * d if r1 else 0))
    if pl:
        macs += rows * (6 * synthesis_macs(m) + 3 * flops.mapping_macs(m))
    return 2.0 * macs


def instances(m: dict, batch: int, r1: bool, pl: bool, rows: int) -> dict:
    """(op, pass) -> [(input shape, passes)] of one step."""
    L, C, z = log2_res(m), m["img_channels"], m["latent_dim"]

    def feats(b):
        return [(b, nf(m, lg - 2), 2 ** (lg - 1), 2 ** (lg - 1))
                for lg in range(3, L + 1)]

    def rgb(b):
        return [(b, C, 2 ** (lg - 1), 2 ** (lg - 1))
                for lg in range(3, L + 1)]

    downs = [(batch, nf(m, lg - 2), 2 ** lg, 2 ** lg)
             for lg in range(L, 2, -1) for _ in range(2)]
    out = {
        # G forward twice (D phase, G phase), backward once (G phase)
        ("upsample_blur", "forward"): [(s, 2) for s in feats(batch)
                                       + rgb(batch)],
        ("upsample_blur", "backward"): [(s, 1) for s in feats(batch)
                                        + rgb(batch)],
        ("pixelnorm", "forward"): [((2 * batch, z), 2)],
        # D forward 3 (+1 with R1), backward 3 (+2), double backward (R1)
        ("blur_down", "forward"): [(s, 3 + r1) for s in downs],
        ("blur_down", "backward"): [(s, 3 + 2 * r1) for s in downs],
        ("blur_down", "double_backward"): [(s, 1) for s in downs] if r1
        else [],
        ("mbstd", "forward"): [((batch, nf(m, 1), 4, 4), 3 + r1)],
        ("adain", "forward"): [],
    }
    if pl:
        # forward, and the outer backward's up+blur of the features'
        # first-order gradient
        out[("upsample_blur", "forward")] += [(s, 2) for s in feats(rows)] \
            + [(s, 1) for s in rgb(rows)]
        # the first-order gradient, and the outer backward of the
        # forward's feature upsamples
        out[("upsample_blur", "backward")] += [(s, 2) for s in feats(rows)] \
            + [(s, 1) for s in rgb(rows)]
        out[("pixelnorm", "forward")].append(((rows, z), 1))
    return out


def least_seconds(m: dict, passes, batch: int, r1: bool, pl: bool,
                  rows: int, elem: int, peaks: dict) -> float:
    """Least time of the listed (op, pass) pairs over one step: per
    instance the larger of bytes / HBM bandwidth and FLOPs / the CUDA
    cores' float32 peak (``ops``'s bytes and FLOPs a pass)."""
    inst = instances(m, batch, r1, pl, rows)
    total = 0.0
    for op, pas in passes:
        for shape, times in inst.get((op, pas), []):
            b = ops.pass_bytes(op, pas, shape, elem)
            f = ops._FLOPS_PER_ELEM[op] * math.prod(shape)
            total += times * max(b / peaks["hbm_bytes_per_s"],
                                 f / peaks["fp32_flops"])
    return total


def cycle_steps(c: dict) -> list:
    """(r1, pl) of each step of one lazy cycle of ``penalty_every`` steps
    from a head step."""
    lc = c["loss"]
    k, pe = lc["penalty_every"], lc["pl_every"]
    pl_on = lc["pl_weight"] > 0
    return [(i % k == 0, pl_on and (pe <= 1 or i % pe == 0))
            for i in range(k)]


def window_work(c: dict, batch: int, cycles: int, kernel_files, elem: int,
                peaks) -> dict:
    """Model FLOPs and the kernels' least seconds of ``cycles`` whole
    cycles."""
    m, rows = c["model"], pl_rows(c, batch)
    steps = cycle_steps(c)
    least = {name: cycles * sum(
        least_seconds(m, kf["passes"], batch, r1, pl, rows, elem, peaks)
        for r1, pl in steps) if peaks else None
        for name, kf in kernel_files.items()}
    flops_ = cycles * sum(train_step_flops(m, batch, r1, pl, rows)
                          for r1, pl in steps)
    return {"model_flops": flops_, "conv_flops": flops_, "least_s": least}

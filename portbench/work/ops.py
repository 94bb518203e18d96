"""Bytes and FLOPs of the five hand-written ops' passes, from the
configuration's shapes, and how many of each pass a step or a served
batch runs.

An op's instances (their input shapes) follow from the model: AdaIN two
a resolution of the synthesis, pixelnorm once over the latents, the
upsample + blur at the start of each synthesis block, the blur + 2x
downsample at the end of each D block, the minibatch statistic once in
D's output block. A pass reads each input byte once and writes each
output byte once. A training step runs G forward twice and backward once,
D forward 3 times and backward 3 times, and with R1 one more D forward,
two more backward passes and one double backward (the backward of the
backward); a served batch runs G forward once.

Which kernel does which pass is data: each ``kernels/<name>.json`` lists
its kernels' names and the (op, pass) pairs they carry out.
"""

from __future__ import annotations

import math

from portbench.reference.model import log2_res, nf

NET = {"adain": "g", "pixelnorm": "g", "upsample_blur": "g",
       "blur_down": "d", "mbstd": "d"}

# FLOPs an element of the pass's input, at least (the byte bound is far
# above them on the card; they are kept for the roofline's max)
_FLOPS_PER_ELEM = {"adain": 8, "pixelnorm": 4, "upsample_blur": 16,
                   "blur_down": 4, "mbstd": 5}


def instances(m: dict, op: str, batch: int, latent_rows: int) -> list:
    """Input shapes of every instance of ``op`` in one G or D forward."""
    L, B = log2_res(m), batch
    if op == "adain":
        return [(B, nf(m, lg - 1), 2 ** lg, 2 ** lg)
                for lg in range(2, L + 1) for _ in range(2)]
    if op == "pixelnorm":
        return [(latent_rows, m["latent_dim"])]
    if op == "upsample_blur":
        return [(B, nf(m, lg - 2), 2 ** (lg - 1), 2 ** (lg - 1))
                for lg in range(3, L + 1)]
    if op == "blur_down":
        return [(B, nf(m, lg - 2), 2 ** lg, 2 ** lg)
                for lg in range(L, 2, -1)]
    if op == "mbstd":
        return [(B, nf(m, 1), 4, 4)]
    raise KeyError(op)


def pass_bytes(op: str, pas: str, shape, elem: int) -> float:
    """Bytes of one pass of one instance (input ``shape``)."""
    n = math.prod(shape)
    if op == "adain":           # x and two (B, C) styles in, y out
        return (2 * n + 2 * shape[0] * shape[1]) * elem
    if op == "pixelnorm":
        return 2 * n * elem
    if op == "upsample_blur":   # forward: x in, 4x out; backward: mirror
        return 5 * n * elem
    if op == "blur_down":       # x in, x / 4 out; backward and the
        return 1.25 * n * elem  # double backward: mirror / same
    if op == "mbstd":
        b, c, h, w = shape
        return (n + b * (c + 1) * h * w) * elem
    raise KeyError(op)


def pass_counts(kind: str, r1: bool = False) -> dict:
    """(net, pass) -> passes a training step (``kind`` 'train') or a
    served batch ('serve')."""
    if kind == "serve":
        return {("g", "forward"): 1}
    return {("g", "forward"): 2, ("g", "backward"): 1,
            ("d", "forward"): 3 + r1, ("d", "backward"): 3 + 2 * r1,
            ("d", "double_backward"): int(r1)}


def least_seconds(m: dict, passes, kind: str, batch: int, r1: bool,
                  elem: int, peaks: dict) -> float:
    """Least time of the listed (op, pass) pairs over one step or served
    batch: per instance the larger of bytes / HBM bandwidth and FLOPs /
    the CUDA cores' float32 peak."""
    rows = 2 * batch if kind == "train" else batch
    counts = pass_counts(kind, r1)
    total = 0.0
    for op, pas in passes:
        times = counts.get((NET[op], pas), 0)
        if not times:
            continue
        for shape in instances(m, op, batch, rows):
            b = pass_bytes(op, pas, shape, elem)
            f = _FLOPS_PER_ELEM[op] * math.prod(shape)
            total += times * max(b / peaks["hbm_bytes_per_s"],
                                 f / peaks["fp32_flops"])
    return total

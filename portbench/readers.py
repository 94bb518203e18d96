"""What the per-layer readers share: the traced window, the window's work
and the card's peaks; and the four quantities they read."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path


@dataclasses.dataclass
class Context:
    trace: object           # trace.TraceData, or None untraced
    work: dict              # the traffic driver's counts of the window
    peaks: dict | None      # the card's peaks (peaks.json), None unknown
    kernel_files: dict      # kernels/<name>.json by name
    here: Path


def _matches(name: str, idents) -> bool:
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(i)}(?![A-Za-z0-9_])",
                         name) for i in idents)


def step_mfu(ctx: Context):
    """Model FLOPs of the window's work over the traced window, as a
    share of the card's bf16 dense peak (%)."""
    if ctx.trace is None or not ctx.peaks or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.work["model_flops"] / ctx.trace.window_s \
        / ctx.peaks["bf16_dense_flops"]


def idle_share(ctx: Context):
    """The share of the window in which no kernel, copy or memset ran (%)."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def kernels_roofline(ctx: Context):
    """Summed least time of the hand-written ops' passes over the summed
    device time of the kernels that the kernel files name (%)."""
    if ctx.trace is None:
        return None
    least = sum(v for v in ctx.work["least_s"].values() if v)
    idents = [k for f in ctx.kernel_files.values() for k in f["kernels"]]
    device = sum(s for n, s in ctx.trace.by_name.items()
                 if _matches(n, idents))
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def conv_roofline(ctx: Context):
    """Conv and dense FLOPs of the window's work at the bf16 dense peak
    over the device time of the conv / GEMM kernels (%), the kernels
    picked by the name patterns of ``metrics/conv_kernels.json``."""
    if ctx.trace is None or not ctx.peaks:
        return None
    with open(ctx.here / "metrics" / "conv_kernels.json") as f:
        pats = [re.compile(p, re.I) for p in json.load(f)["patterns"]]
    device = sum(s for n, s in ctx.trace.by_name.items()
                 if any(p.search(n) for p in pats))
    if device <= 0:
        return None
    return 100.0 * ctx.work["conv_flops"] / ctx.peaks["bf16_dense_flops"] \
        / device

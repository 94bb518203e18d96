"""The traced run: ``torch.profiler`` (CUPTI) over the measured window, the
benchmark's own spans around its calls into the program, and the
reduction of the trace to what the per-layer readers take.

Spans (``record_function``): ``window`` around the whole window,
``train.cycle`` / ``train.step`` / ``serve.request`` around the calls.
Device time is that of kernels, copies and memsets (the CUPTI activities
``kernel``, ``gpu_memcpy``, ``gpu_memset``), clipped to the window.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("train.cycle", "train.step", "serve.request", "serve.copy")


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    by_name: dict          # device op name -> seconds in the window
    idle_gaps: list        # [(label, seconds)], longest first
    events: int


class Tracer:
    """Profiles the window when ``on``; ``span(name)`` marks a host span
    (a no-op when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.data: TraceData | None = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window, profiled when on."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.__enter__()
        try:
            with torch.profiler.record_function("window"):
                yield
                torch.cuda.synchronize()
        finally:
            prof.__exit__(None, None, None)
        self.data = reduce(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    """The CUPTI / profiler activity of an event. Builds whose events do
    not say it: a device event named as one of our spans is its device-side
    copy, any other device event device work; a host event named as one of
    our spans is the span."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    ours = e.name() in SPANS or e.name() == "window"
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if ours else "kernel"
    return "user_annotation" if ours else "cpu_op"


def _union(intervals):
    """Merged (start, end) intervals of sorted ``intervals``."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events) -> TraceData:
    """Window, busy time, device time by name and the ten longest idle
    gaps, each labelled by the innermost benchmark span on the host at
    its start ("none" outside them)."""
    window = None
    spans, dev = [], []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_ACTIVITIES:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name()))
        elif kind == "user_annotation":
            name = e.name()
            if name == "window":
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name in SPANS:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    clipped = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                     if b > w0 and a < w1)
    by_name: dict = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    merged = _union([(a, b) for a, b, _ in clipped])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    labelled = []
    for length, at in gaps:
        inner = [(b - a, n) for a, b, n in spans if a <= at < b]
        labelled.append((min(inner)[1] if inner else "none", length * 1e-9))
    return TraceData(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                     by_name=by_name, idle_gaps=labelled, events=len(dev))


def breakdown(data: TraceData, top: int = 10) -> dict:
    ops = sorted(data.by_name.items(), key=lambda kv: kv[1], reverse=True)
    return {"device_ops": [[n[:96], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in data.idle_gaps[:top]]}

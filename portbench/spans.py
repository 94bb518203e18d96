"""Program spans in a traced window: device, host and idle seconds by span.

The program opens named host ranges at its boundaries while a profiler
records (``ganlab_tpu_torch/utils/spans.py``, whose ``SPANS`` lists
them). ``attribute`` ties a traced window to those, to the benchmark's
own (``trace.SPANS``) and to every user annotation on the host (torch's
``Optimizer.step#...``):

* device seconds by span, inclusive: the busy time of the kernels, copies
  and memsets launched under it. One counts under every span open at the
  CUDA runtime or driver call that launched it (the two matched by
  correlation id), on the launching thread, or on the window's thread
  where the launching thread has none open (the autograd engine's device
  thread, which launches a backward while the thread that called it
  waits). Busy time is the union of the intervals, as kernels on several
  streams overlap (cuDNN's legacy sgemm runs on four at once). The copies
  are also taken apart;
* host seconds by span, self: the span's time in the window less that of
  the spans inside it;
* idle seconds by span: each stretch of the window in which no kernel,
  copy or memset ran, split by the innermost span open on the window's
  thread ("none" outside every span);
* the ten longest idle gaps, each labelled by the innermost span open on
  the window's thread at its start;
* device seconds by op name under each innermost span (summed).

Device time is clipped to the window as ``trace.reduce`` clips it. Where
the profiler's events do not say their activity (torch 2.11), ``reduce``
counts the device-side copy of a user annotation it does not name as
device work; ``attribute`` leaves every such copy out (``busy_s`` is the
busy time without them). The readers below give the four per-layer
numbers that the spans are for.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one traced run of the cell through ``run.py`` (``--trace 1``) with
the trace's events kept, writes one line a span to standard error (count,
host s, device s, idle s) and the share of the window's device seconds
launched under a program span, and prints ``run.py``'s result line with a
``spans`` entry added.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import trace  # noqa: E402

# a CUDA runtime or driver call: cudaLaunchKernel, cudaGraphLaunch,
# cudaMemcpyAsync, cuLaunchKernel, ...
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass
class SpanData:
    count: dict            # span -> ranges that start in the window
    host_s: dict           # span -> self seconds on the host
    device_s: dict         # span -> device seconds launched under it
    copy_s: dict           # span -> the same, copies alone
    idle_s: dict           # span -> idle seconds with it innermost
    idle_gaps: list        # [(label, seconds)], longest first
    busy_s: float          # the window's seconds with device work
    program_s: float       # of which launched under a program span
    unmatched: int         # device events whose launch was not found
    ops: dict              # innermost span -> {device op name -> seconds}


def program_spans() -> tuple:
    """The span names the program emits; none on a tree without them."""
    try:
        from ganlab_tpu_torch.utils.spans import SPANS
    except ImportError:
        return ()
    return SPANS


def _segments(ranges):
    """The nested ``ranges`` [(start, end, name)] of one thread as a flat
    timeline: (starts, stacks), the names open from each start on."""
    starts, stacks, open_ = [], [], []

    def mark(t):
        starts.append(max(t, starts[-1]) if starts else t)
        stacks.append(tuple(n for _, n in open_))

    for a, b, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while open_ and open_[-1][0] <= a:
            mark(open_.pop()[0])
        open_.append((b, n))
        mark(a)
    while open_:
        mark(open_.pop()[0])
    return starts, stacks


def _stack(seg, t) -> tuple:
    starts, stacks = seg
    i = bisect.bisect_right(starts, t) - 1
    return stacks[i] if i >= 0 else ()


def _pieces(seg, a, b):
    """(length in ns, innermost span or "none") of the pieces of [a, b)."""
    starts, stacks = seg
    i = bisect.bisect_right(starts, a) - 1
    t = a
    while t < b:
        end = min(starts[i + 1], b) if i + 1 < len(starts) else b
        if end > t:
            inner = stacks[i][-1] if i >= 0 and stacks[i] else "none"
            yield end - t, inner
        t, i = max(t, end), i + 1


def _add(d: dict, key, value) -> None:
    d[key] = d.get(key, 0.0) + value


def _busy(intervals) -> float:
    """Seconds of the union of sorted ``intervals`` (ns)."""
    return sum(b - a for a, b in trace._union(intervals)) * 1e-9


def _annotation(e, named) -> bool:
    return e.is_user_annotation() or e.name() in named


def attribute(events, program=()) -> SpanData:
    """Device, host and idle seconds by span of the window that the
    ``window`` range of ``events`` marks; ``program`` names the program's
    spans."""
    program = set(program)
    named = program | set(trace.SPANS) | {"window"}
    window = wtid = None
    ranges: dict = {}          # thread -> [(start, end, name)]
    calls: dict = {}           # correlation id -> (start, thread)
    dev = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(e, named):
                s = e.start_ns()
                kind = "gpu_memcpy" if name.startswith("Memcpy") \
                    else "kernel"
                dev.append((s, s + e.duration_ns(), kind,
                            e.correlation_id(), name))
        elif LAUNCH.match(name):
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif _annotation(e, named):
            a = e.start_ns()
            r = (a, a + e.duration_ns(), name)
            if name == "window":
                window, wtid = r[:2], e.start_thread_id()
            else:
                ranges.setdefault(e.start_thread_id(), []).append(r)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    segs = {tid: _segments(rs) for tid, rs in ranges.items()}
    empty = ([], [])
    out = SpanData({}, {}, {}, {}, {}, [], 0.0, 0.0, 0, {})
    for rs in ranges.values():
        for a, _, n in rs:
            if w0 <= a < w1:
                out.count[n] = out.count.get(n, 0) + 1
    for seg in segs.values():
        for length, inner in _pieces(seg, w0, w1):
            if inner != "none":
                _add(out.host_s, inner, length * 1e-9)
    clipped = sorted((max(a, w0), min(b, w1), kind, c, op)
                     for a, b, kind, c, op in dev if b > w0 and a < w1)
    main = segs.get(wtid, empty)
    under: dict = {}           # span -> its device intervals, sorted
    copies: dict = {}
    ours = []
    for a, b, kind, c, op in clipped:
        call = calls.get(c)
        if call is None:
            out.unmatched += 1
            continue
        t, tid = call
        stack = _stack(segs.get(tid, empty), t) or _stack(main, t)
        _add(out.ops.setdefault(stack[-1] if stack else "none", {}), op,
             (b - a) * 1e-9)
        names = set(stack)
        for n in names:
            under.setdefault(n, []).append((a, b))
            if kind == "gpu_memcpy":
                copies.setdefault(n, []).append((a, b))
        if names & program:
            ours.append((a, b))
    out.device_s = {n: _busy(iv) for n, iv in under.items()}
    out.copy_s = {n: _busy(iv) for n, iv in copies.items()}
    out.program_s = _busy(ours)
    merged = trace._union([(a, b) for a, b, *_ in clipped])
    out.busy_s = sum(b - a for a, b in merged) * 1e-9
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    for a, b in idle:
        for length, inner in _pieces(main, a, b):
            _add(out.idle_s, inner, length * 1e-9)
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        stack = _stack(main, a)
        out.idle_gaps.append((stack[-1] if stack else "none",
                              (b - a) * 1e-9))
    return out


# -- the per-layer readings ------------------------------------------------

def reg_share(d: SpanData):
    """Device seconds of the eager steps on which R1 (or path length)
    fires over the window's busy seconds (%)."""
    s = d.device_s.get("step.reg")
    if s is None or d.busy_s <= 0:
        return None
    return 100.0 * s / d.busy_s


def _per_request(d: SpanData, seconds):
    n = d.count.get("serve.generate")
    if not n or seconds is None:
        return None
    return 1e3 * seconds / n


def copy_ms(d: SpanData):
    """Device ms of the copies under ``serve.copy``, a request."""
    return _per_request(d, d.copy_s.get("serve.copy"))


def issue_ms(d: SpanData):
    """Host ms of ``serve.forward`` (the G forward's issue), a request."""
    return _per_request(d, d.host_s.get("serve.forward"))


def host_ms(d: SpanData):
    """Host ms of ``serve.inputs`` and ``serve.assemble``, a request."""
    parts = [d.host_s.get(n) for n in ("serve.inputs", "serve.assemble")]
    if None in parts:
        return None
    return _per_request(d, sum(parts))


def readings(d: SpanData) -> dict:
    out = {"step.reg_share.train": reg_share(d),
           "sampler.copy_ms.serve": copy_ms(d),
           "sampler.issue_ms.serve": issue_ms(d),
           "sampler.host_ms.serve": host_ms(d)}
    return {k: v for k, v in out.items() if v is not None}


# -- one traced run ----------------------------------------------------------

def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    kept = []
    reduce = trace.reduce

    def keep(events):
        events = list(events)
        kept.append(attribute(events, program_spans()))
        return reduce(events)

    trace.reduce = keep
    try:
        res = run.main(["--workload", args.workload, "--seed",
                        str(args.seed), "--seconds", str(args.seconds),
                        "--trace", "1"])
    finally:
        trace.reduce = reduce
    if not kept:
        raise run.Fail("no traced window")
    d = kept[0]
    names = sorted(set(d.count) | set(d.host_s) | set(d.device_s)
                   | set(d.idle_s))
    for n in names:
        run.log(f"span {n}: count {d.count.get(n, 0)} host_s "
                f"{d.host_s.get(n, 0.0)!r} device_s "
                f"{d.device_s.get(n, 0.0)!r} copy_s "
                f"{d.copy_s.get(n, 0.0)!r} idle_s {d.idle_s.get(n, 0.0)!r}")
    for n, ops in sorted(d.ops.items()):
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
        run.log(f"ops under {n}: " + "; ".join(f"{op[:72]} {v!r}"
                                               for op, v in top))
    share = 100.0 * d.program_s / d.busy_s if d.busy_s > 0 else None
    run.log(f"program spans: {share!r}% of {d.busy_s!r} busy s "
            f"({d.unmatched} device events with no launch found; "
            f"{res['device']['busy_s']!r} busy s in reduce)")
    res["spans"] = {"program_share": share, "unmatched": d.unmatched,
                    "busy_s": d.busy_s, "readings": readings(d),
                    "idle_gaps": d.idle_gaps,
                    "by_span": {n: [d.count.get(n, 0), d.host_s.get(n, 0.0),
                                    d.device_s.get(n, 0.0),
                                    d.idle_s.get(n, 0.0)]
                                for n in names}}
    return res


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)

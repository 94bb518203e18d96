"""``trace.reduce`` and ``spans.attribute`` on one hand-built trace.

The trace's events are what torch 2.11 gives (no activity type; a user
annotation's device-side copy on the device's timeline). In ms; thread 1
holds the window [0, 100] and the spans, thread 2 one of torch's own
ranges; the program's spans are host ops, the others user annotations:

    serve.request [5, 95] > serve.generate [10, 90] > serve.inputs
    [10, 20], serve.forward [20, 40], serve.copy [40, 70], serve.assemble
    [70, 90]; Optimizer.step#Adam.step [95, 99] on thread 2; device-side
    copies of window [30, 105], serve.request [30, 68] and
    Optimizer.step#Adam.step [97, 105]

    launch at  device op      on device   launched under
    2          kernel k3      [-5, 3]     no span (clipped to [0, 3])
    25         kernel k1      [30, 50]    serve.forward
    35         kernel k2      [50, 60]    serve.forward
    41         memcpy DtoH    [60, 68]    serve.copy
    -          kernel k5      [92, 94]    no launch in the trace
    96 (t2)    kernel k4      [97, 105]   Optimizer.step#Adam.step
    -          kernel k6      [110, 120]  after the window
    24 (t3)    kernel k7      [35, 45]    serve.forward, by thread 1's
                                          spans (another stream)

``reduce`` keeps the values it gave before the program opened spans (it
counts the copy of torch's annotation as device work); ``attribute``
gives device time by the launch's spans, self host time, the idle time
split by the innermost span, the gaps' labels and the ops under each
innermost span, with no annotation copy as device work. The four readers
read a hand-built ``SpanData`` and give None where their span is absent.
"""

import pytest
import torch

from portbench import spans, trace

MS = 1_000_000
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, kind, start, end, tid=1, corr=0):
        self._v = (name, kind, int(start * MS), int((end - start) * MS),
                   tid, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return CUDA if self._v[1] in ("kernel", "gpu_memcpy", "gpu_ua") \
            else CPU

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_ua")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


UA, OP, RT = "user_annotation", "cpu_op", "cuda_runtime"
EVENTS = [
    Ev("window", UA, 0, 100),
    Ev("serve.request", UA, 5, 95),
    Ev("serve.generate", OP, 10, 90),
    Ev("serve.inputs", OP, 10, 20),
    Ev("serve.forward", OP, 20, 40),
    Ev("serve.copy", OP, 40, 70),
    Ev("serve.assemble", OP, 70, 90),
    Ev("Optimizer.step#Adam.step", UA, 95, 99, tid=2),
    Ev("window", "gpu_ua", 30, 105),
    Ev("serve.request", "gpu_ua", 30, 68),
    Ev("Optimizer.step#Adam.step", "gpu_ua", 97, 105),
    Ev("aten::mm", "cpu_op", 21, 22),
    Ev("cudaLaunchKernel", RT, 2, 2.5, corr=4),
    Ev("cudaLaunchKernel", RT, 25, 26, corr=1),
    Ev("cudaLaunchKernel", RT, 35, 36, corr=2),
    Ev("cudaMemcpyAsync", RT, 41, 69, corr=3),
    Ev("cudaLaunchKernel", RT, 96, 96.5, tid=2, corr=5),
    Ev("k3", "kernel", -5, 3, corr=4),
    Ev("k1", "kernel", 30, 50, corr=1),
    Ev("k2", "kernel", 50, 60, corr=2),
    Ev("Memcpy DtoH", "gpu_memcpy", 60, 68, corr=3),
    Ev("k5", "kernel", 92, 94, corr=99),
    Ev("k4", "kernel", 97, 105, corr=5),
    Ev("k6", "kernel", 110, 120, corr=6),
    Ev("cudaLaunchKernel", RT, 24, 24.5, tid=3, corr=7),
    Ev("k7", "kernel", 35, 45, corr=7),
]


def close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k


def test_reduce_keeps_its_values():
    d = trace.reduce(EVENTS)
    assert d.window_s == pytest.approx(0.1)
    assert d.busy_s == pytest.approx(0.046)
    close(d.by_name, {"k3": 0.003, "k1": 0.02, "k2": 0.01,
                      "Memcpy DtoH": 0.008, "k5": 0.002, "k4": 0.003,
                      "Optimizer.step#Adam.step": 0.003, "k7": 0.01})
    assert d.events == 9
    assert [n for n, _ in d.idle_gaps] == ["none", "serve.copy",
                                           "serve.request"]
    assert [s for _, s in d.idle_gaps] == pytest.approx([0.027, 0.024,
                                                         0.003])


def test_attribute():
    d = spans.attribute(EVENTS, ("serve.generate", "serve.inputs",
                                 "serve.forward", "serve.copy",
                                 "serve.assemble"))
    assert d.count == {"serve.request": 1, "serve.generate": 1,
                       "serve.inputs": 1, "serve.forward": 1,
                       "serve.copy": 1, "serve.assemble": 1,
                       "Optimizer.step#Adam.step": 1}
    close(d.host_s, {"serve.request": 0.010,
                     "serve.inputs": 0.010, "serve.forward": 0.020,
                     "serve.copy": 0.030, "serve.assemble": 0.020,
                     "Optimizer.step#Adam.step": 0.004})
    close(d.device_s, {"serve.request": 0.038, "serve.generate": 0.038,
                       "serve.forward": 0.030, "serve.copy": 0.008,
                       "Optimizer.step#Adam.step": 0.003})
    close(d.copy_s, {"serve.request": 0.008, "serve.generate": 0.008,
                     "serve.copy": 0.008})
    close(d.idle_s, {"none": 0.004, "serve.request": 0.008,
                     "serve.inputs": 0.010, "serve.forward": 0.010,
                     "serve.copy": 0.002, "serve.assemble": 0.020})
    assert d.busy_s == pytest.approx(0.046)
    assert d.program_s == pytest.approx(0.038)
    assert d.unmatched == 1
    assert set(d.ops) == {"none", "serve.forward", "serve.copy",
                          "Optimizer.step#Adam.step"}
    close(d.ops["none"], {"k3": 0.003})
    close(d.ops["serve.forward"], {"k1": 0.02, "k2": 0.01, "k7": 0.01})
    close(d.ops["serve.copy"], {"Memcpy DtoH": 0.008})
    close(d.ops["Optimizer.step#Adam.step"], {"k4": 0.003})
    assert [n for n, _ in d.idle_gaps] == ["none", "serve.copy",
                                           "serve.request"]
    assert [s for _, s in d.idle_gaps] == pytest.approx([0.027, 0.024,
                                                         0.003])
    # the idle seconds by span add up to the window's idle seconds
    assert sum(d.idle_s.values()) == pytest.approx(0.1 - 0.046)


def span_data(**kw):
    base = dict(count={}, host_s={}, device_s={}, copy_s={}, idle_s={},
                idle_gaps=[], busy_s=0.04, program_s=0.0, unmatched=0,
                ops={})
    return spans.SpanData(**dict(base, **kw))


SERVED = span_data(count={"serve.generate": 4},
                   host_s={"serve.forward": 0.08, "serve.inputs": 0.1,
                           "serve.assemble": 0.06},
                   copy_s={"serve.copy": 0.2})


@pytest.mark.parametrize("reader, data, want", [
    (spans.reg_share, span_data(device_s={"step.reg": 0.01}), 25.0),
    (spans.copy_ms, SERVED, 50.0),
    (spans.issue_ms, SERVED, 20.0),
    (spans.host_ms, SERVED, 40.0),
], ids=["reg_share", "copy_ms", "issue_ms", "host_ms"])
def test_readers(reader, data, want):
    assert reader(data) == pytest.approx(want)
    assert reader(span_data()) is None

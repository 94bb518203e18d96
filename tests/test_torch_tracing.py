"""The program's named host spans (``ganlab_tpu_torch/utils/spans.py``).

On the CPU, at a tiny ``stylegan-256`` (16x16, float32): ``span`` is the
shared null context with no profiler on and records nothing, and a
named host range under ``torch.profiler``; a ``generate`` of two
batches, on the exported sampler (its CPU program) and on
``BatchSampler``, opens one ``serve.generate`` that holds, per batch,
``serve.inputs``, ``serve.forward`` and ``serve.copy`` (with one
``serve.alloc`` inside), then one ``serve.assemble``;
the lazy stepper over two cycles of k steps opens two ``step.reg`` and
2k - 2 ``step.plain``; the chunked stepper over one cycle opens one
``train.chunk`` holding one ``step.reg`` and k - 1 ``step.plain``. On a
tiny ``stylegan2-256`` (R1 every 16 steps, path length every 4) one
cycle of either stepper opens one ``step.reg``, three ``step.pl`` and
twelve ``step.plain``.
Every name the program opens is in ``SPANS``. On a card
(``gpu`` marker; this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_tracing.py -m gpu

a replayed cycle of the chunked stepper opens ``graph.replay``, and
``portbench/spans.py`` ties at least 99% of the cycle's device time to
the program's spans.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.export import ExportedSampler, export_sampler
from ganlab_tpu_torch.serve import BatchSampler
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train.steps import (
    make_chunked_stepper,
    make_lazy_stepper,
)
from ganlab_tpu_torch.utils import spans

torch.set_num_threads(1)

K = 4
B = 2
TINY = {"model.resolution": 16, "model.latent_dim": 8,
        "model.fmap_base": 64, "model.fmap_max": 8,
        "model.mapping_layers": 2, "schedule.progressive": False,
        "schedule.batch_schedule": {16: B}, "loss.penalty_every": K,
        "run.compute_dtype": "float32"}


def tiny_config():
    return get_config("stylegan-256", **TINY)


# a span's name: two lowercase words joined by a dot (torch's own ranges,
# ops and autograd nodes read "Optimizer.step#...", "aten::mm", "AdaIN")
SPAN_NAME = re.compile(r"^[a-z]+\.[a-z]+$")


def recorded(fn):
    """The program's spans that ``fn()`` opens under a CPU profiler, as
    (start, end, name) in start order; each is in ``SPANS``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if SPAN_NAME.match(e.name()))
    assert {n for _, _, n in out} <= set(spans.SPANS)
    return out


def inside(spans_, outer) -> list:
    """The names of ``spans_`` that lie within the range ``outer``."""
    a, b, _ = outer
    return [n for s, e, n in spans_ if a <= s and e <= b
            and (s, e) != (a, b)]


def test_span_is_null_without_a_profiler():
    assert spans.span("serve.copy") is spans.span("step.reg")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("train.chunk"):
            torch.ones(2).sum()
    with spans.span("train.data"):
        torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("train.chunk") == 1 and "train.data" not in names


@pytest.fixture(scope="module")
def state():
    return create_train_state(tiny_config(), seed=0, device="cpu")


@pytest.mark.parametrize("kind", ["exported", "batch_sampler"])
def test_generate_spans(kind, state, tmp_path):
    cfg = tiny_config()
    if kind == "exported":
        path = str(tmp_path / "sampler.ganlab.zip")
        export_sampler(cfg, state, path, batch_size=B, platforms=("cpu",))
        sampler = ExportedSampler(path, device="cpu")
    else:
        sampler = BatchSampler(cfg, state=state, batch_size=B, device="cpu")
    got = recorded(lambda: sampler.generate(2 * B - 1, seed=3))
    roots = [s for s in got if s[2] == "serve.generate"]
    assert len(roots) == 1
    held = inside(got, roots[0])
    assert len(held) == len(got) - 1
    # per batch the latents and the device inputs, the forward, the copy;
    # then the concatenation
    assert held.count("serve.inputs") == 4
    assert held.count("serve.forward") == held.count("serve.copy") == 2
    assert held.count("serve.assemble") == 1 and held[-1] == "serve.assemble"
    # both samplers allocate each batch's host array in the copy
    allocs = [r for r in got if r[2] == "serve.alloc"]
    assert len(allocs) == 2
    for a, b, _ in allocs:
        assert any(s <= a and b <= e for s, e, n in got if n == "serve.copy")


def tiny_batches(n: int) -> torch.Tensor:
    rs = np.random.RandomState(0)
    return torch.from_numpy(rs.randint(0, 256, (n, B, 16, 16, 3))
                            .astype(np.uint8))


@pytest.mark.parametrize("stepper", ["lazy", "chunked"])
def test_stepper_spans(stepper):
    """Lazy over two cycles: two ``step.reg``, 2k - 2 ``step.plain``.
    Chunked over one cycle (its off-run eager on the CPU): one
    ``train.chunk`` holding one ``step.reg`` and k - 1 ``step.plain``."""
    cfg = tiny_config()
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st = create_train_state(cfg, seed=0, device="cpu")
    if stepper == "lazy":
        fn = make_lazy_stepper(cfg, phase)
        stack = tiny_batches(2 * K)
        got = recorded(lambda: [fn(st, x) for x in stack])
        names = [n for _, _, n in got]
        assert names.count("step.reg") == 2
        assert names.count("step.plain") == 2 * K - 2
        assert set(names) == {"step.reg", "step.plain"}
        assert names[0] == names[K] == "step.reg"
    else:
        fn, k = make_chunked_stepper(cfg, phase)
        got = recorded(lambda: fn(st, tiny_batches(k)))
        roots = [s for s in got if s[2] == "train.chunk"]
        assert len(roots) == 1
        held = inside(got, roots[0])
        assert held[0] == "step.reg"
        assert sorted(held) == ["step.plain"] * (k - 1) + ["step.reg"]


# stylegan2-256 as the preset regularizes: R1 every 16 steps, path length
# every 4
SG2_TINY = {"model.resolution": 16, "model.latent_dim": 8,
            "model.fmap_base": 64, "model.fmap_max": 8,
            "model.mapping_layers": 2, "schedule.batch_schedule": {16: B},
            "run.compute_dtype": "float32"}
# one cycle: R1 and path length at the head, path length alone at every
# fourth step, nothing between
SG2_CYCLE = ["step.reg"] + ["step.plain"] * 3 \
    + (["step.pl"] + ["step.plain"] * 3) * 3


@pytest.mark.parametrize("stepper", ["lazy", "chunked"])
def test_path_length_steps_open_their_own_span(stepper):
    """StyleGAN2 over one cycle of 16 steps: one ``step.reg`` (R1 with
    path length), three ``step.pl`` (path length alone), twelve
    ``step.plain``, in the cycle's order; the chunked stepper's (its
    off-runs eager on the CPU) inside one ``train.chunk``."""
    cfg = get_config("stylegan2-256", **SG2_TINY)
    assert (cfg.loss.penalty_every, cfg.loss.pl_every) == (16, 4)
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st = create_train_state(cfg, seed=0, device="cpu")
    if stepper == "lazy":
        fn = make_lazy_stepper(cfg, phase)
        got = recorded(lambda: [fn(st, x) for x in tiny_batches(16)])
        assert [n for _, _, n in got] == SG2_CYCLE
    else:
        fn, k = make_chunked_stepper(cfg, phase)
        got = recorded(lambda: fn(st, tiny_batches(k)))
        roots = [s for s in got if s[2] == "train.chunk"]
        assert k == 16 and len(roots) == 1
        assert inside(got, roots[0]) == SG2_CYCLE


@pytest.mark.gpu
def test_replayed_cycle_is_tied_to_program_spans():
    """The third cycle replays the graph the second captured: under a
    CPU + CUDA profiler it opens ``train.chunk``, one ``step.reg`` and
    ``graph.replay``, and at least 99% of its device time was launched
    under a program span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs run only on the card)")
    from portbench.spans import attribute

    cfg = get_config("stylegan-256", **dict(
        TINY, **{"model.fmap_base": 256, "model.fmap_max": 32,
                 "model.latent_dim": 32, "run.compute_dtype": "bfloat16"}))
    phase = build_phases(cfg.schedule, cfg.model)[0]
    st = create_train_state(cfg, seed=0, device="cuda")
    fn, k = make_chunked_stepper(cfg, phase)
    stack = tiny_batches(k).cuda()
    for _ in range(2):
        st, _ = fn(st, stack)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            st, _ = fn(st, stack)
            torch.cuda.synchronize()
    fn.close()
    d = attribute(prof.profiler.kineto_results.events(), spans.SPANS)
    assert d.count["train.chunk"] == d.count["step.reg"] \
        == d.count["graph.replay"] == 1
    assert d.device_s["graph.replay"] > 0 and d.device_s["step.reg"] > 0
    assert d.program_s >= 0.99 * d.busy_s > 0

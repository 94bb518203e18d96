"""The chunked stepper's CUDA graphs (``train/graphs.py``), on a card.

Here on the CPU every test skips. On a CUDA card (``-m gpu``), at a narrow
``stylegan-256`` / ``stylegan2-256`` (16x16, bf16, deterministic cuDNN),
``make_chunked_stepper`` over two full cycles and a two-step tail, its
off-runs replayed as CUDA graphs from the second cycle on, is held bit for
bit to ``make_lazy_stepper`` over the same batches: every tensor of the
state (the generator's state included) and the stacked metrics, in a
stabilize phase, in a fade phase (alpha a graph input), with path length
(segments between the PL steps), with ADA (``ada_p`` chained through the
replays), under n-critic (the pattern of G updates in the graph's key),
under ``optim.ema_rampup`` (beta a graph input) and under the step
recipes ``loss.reg_separate``, ``loss.fused_seq`` and ``loss.fused_g_step``
(the last also with path length); the launches of our
kernels that the wrappers count are the same on both sides (a replay adds
its captured launches). A step that reads a value on the host cannot be
captured: the stepper raises. A state restored from a checkpoint taken
between cycles replays bit for bit with the live one. This file imports
no JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_graphs.py -m gpu
"""

import numpy as np
import pytest
import torch

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.ops.kernels import launch_counters
from ganlab_tpu_torch.train import (
    CheckpointManager,
    build_phases,
    create_train_state,
    state_tensors,
)
from ganlab_tpu_torch.train import steps as tsteps
from ganlab_tpu_torch.train.steps import (
    make_chunked_stepper,
    make_lazy_stepper,
    stack_metrics,
)

K = 4
B = 4
NARROW = {"model.resolution": 16, "model.fmap_base": 256,
          "model.fmap_max": 32, "model.latent_dim": 32,
          "model.mapping_layers": 2, "loss.penalty_every": K,
          "schedule.progressive": False,
          "schedule.batch_schedule": {16: B}}
CASES = {
    "stabilize": ("stylegan-256", {}),
    "fade": ("stylegan-256", {"schedule.progressive": True,
                              "schedule.start_res": 8,
                              "schedule.fade_kimg": 0.2,
                              "schedule.stabilize_kimg": 0.2,
                              "schedule.batch_schedule": {8: B, 16: B}}),
    "pl": ("stylegan2-256", {"loss.pl_every": 2}),
    "ada": ("stylegan-256", {"aug.mode": "ada", "aug.categories": "bcgfnu",
                             "aug.p_init": 0.5, "aug.kimg": 0.1}),
    "n_critic": ("stylegan-256", {"loss.d_steps_per_g": 2}),
    "ema_rampup": ("stylegan-256", {"optim.ema_rampup": 0.05}),
    "reg_separate": ("stylegan-256", {"loss.reg_separate": True}),
    "fused_seq": ("stylegan-256", {"loss.fused_seq": True}),
    "fused_g_step": ("stylegan-256", {"loss.fused_g_step": True}),
    "fused_g_step_pl": ("stylegan2-256", {"loss.pl_every": 2,
                                          "loss.fused_g_step": True}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels run only on "
                    "the card)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def config(case: str):
    preset, over = CASES[case]
    return get_config(preset, **dict(NARROW, **over))


def last_phase_of_kind(cfg, kind: str):
    return [p for p in build_phases(cfg.schedule, cfg.model)
            if p.kind == kind][-1]


def batches(n: int, seed: int = 0) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, 256, (n, B, 16, 16, 3))
                            .astype(np.uint8)).cuda()


def counts() -> list:
    return [w.launches for w in launch_counters()]


def zero_counts() -> None:
    for w in launch_counters():
        w.launches = 0


def lazy_run(cfg, phase, state, stack):
    stepper = make_lazy_stepper(cfg, phase, initial_step=state.step)
    ms = []
    for i in range(stack.shape[0]):
        state, m = stepper(state, stack[i])
        ms.append(m)
    return state, stack_metrics(ms, state.device)


def chunked_run(stepper, state, stack, pieces):
    parts, start = [], 0
    for n in pieces:
        state, m = stepper(state, stack[start:start + n])
        assert len(m["d_loss"]) == n
        parts.append(m)
        start += n
    return state, {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def assert_same(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb)
    assert [k for k in ta if not torch.equal(ta[k].cpu(), tb[k].cpu())] == []


def fresh_state(cfg, phase):
    state = create_train_state(cfg, seed=0, device="cuda")
    state.shown_imgs = phase.start_img
    return state


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_chunks_equal_the_lazy_stepper(cuda, case):
    cfg = config(case)
    kind = "fade" if case == "fade" else "stabilize"
    phase = last_phase_of_kind(cfg, kind)
    data = batches(3 * K + 2)
    pieces = [K, K, K, 2]

    zero_counts()
    ref, m_ref = lazy_run(cfg, phase, fresh_state(cfg, phase), data)
    want = counts()
    zero_counts()
    stepper, k = make_chunked_stepper(cfg, phase)
    assert k == K
    got, m_got = chunked_run(stepper, fresh_state(cfg, phase), data, pieces)
    torch.cuda.synchronize()
    assert counts() == want
    assert stepper.graphs is not None and stepper.graphs.capture_s
    assert_same(ref, got)
    assert m_ref.keys() == m_got.keys()
    assert [k for k in m_ref if not torch.equal(m_ref[k], m_got[k])] == []
    if case == "fade":
        alphas = m_got["alpha"].tolist()
        assert alphas == sorted(alphas) and len(set(alphas)) > K
    stepper.close()


@pytest.mark.gpu
def test_a_step_that_reads_the_host_cannot_be_captured(cuda, monkeypatch):
    """The off-step reads a loss on the host: eager, that is a wait;
    captured, it is refused, and the stepper raises (no eager
    fallback)."""
    cfg = config("stabilize")
    phase = last_phase_of_kind(cfg, "stabilize")
    build = tsteps.build_train_step

    def host_reading(*a, **k):
        fn = build(*a, **k)

        def step(*args, **kw):
            state, m = fn(*args, **kw)
            float(m["d_loss"])
            return state, m

        step.__dict__.update(fn.__dict__)
        return step

    monkeypatch.setattr(tsteps, "build_train_step", host_reading)
    stepper, _ = make_chunked_stepper(cfg, phase)
    state = fresh_state(cfg, phase)
    data = batches(2 * K)
    state, _ = stepper(state, data[:K])        # eager: the warm-up
    with pytest.raises(RuntimeError):
        stepper(state, data[K:])
    stepper.close()


@pytest.mark.gpu
def test_resume_between_cycles_replays(cuda, tmp_path):
    cfg = config("stabilize")
    phase = last_phase_of_kind(cfg, "stabilize")
    data = batches(5 * K, seed=1)
    live = fresh_state(cfg, phase)
    stepper, _ = make_chunked_stepper(cfg, phase)
    live, _ = chunked_run(stepper, live, data, [K, K])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(live.step, live)
    restored = create_train_state(cfg, seed=5, device="cuda")
    ckpt.restore(restored)
    assert all(g["capturable"] for g in restored.opt_d.param_groups)
    assert_same(live, restored)
    again, _ = make_chunked_stepper(cfg, phase, initial_step=restored.step)
    live, m_live = chunked_run(stepper, live, data[2 * K:], [K, K, K])
    restored, m_back = chunked_run(again, restored, data[2 * K:], [K, K, K])
    assert again.graphs.capture_s
    assert_same(live, restored)
    assert all(torch.equal(m_live[k], m_back[k]) for k in m_live)
    stepper.close()
    again.close()

"""The port's checkpoints: keep-k, latest step, atomic write, bitwise resume.

The cases of ``tests/test_checkpoint.py`` (save/restore round trip, resumed
continuation equals the uninterrupted run, keep-last-k) on the port's
``CheckpointManager``, plus what the progressive trainer needs: resume
across a lazy-R1 boundary and across a phase boundary, a checkpoint that is
read from another process's leftovers, and Adam's step count for a
parameter that gets its first gradient late, held against optax. Small
StyleGAN (16x16, fmap_max 16, latent 16, batch 4, float32, CPU). Bitwise
comparisons use ``torch.equal``: on one device the same steps from the same
state give the same bits. The optax comparison allows 1e-5 relative (other
operation order in the update).
"""

import os

import numpy as np
import optax
import pytest
import torch

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.train import (
    CheckpointManager,
    build_phases,
    create_train_state,
    make_lazy_stepper,
    phase_at,
    reset_moments,
    state_tensors,
)
from ganlab_tpu_torch.train.state import seed_new_moments

# The tensors here are small: one intra-op thread is as fast as eight, and
# test processes that run side by side do not fight over the cores.
torch.set_num_threads(1)

B = 4
SMALL = {"model.resolution": 16, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32",
         "loss.penalty_every": 4, "data.dataset": "synthetic",
         "schedule.start_res": 8, "schedule.fade_kimg": 0.016,
         "schedule.stabilize_kimg": 0.016, "schedule.total_kimg": 0.048,
         "schedule.batch_schedule": {8: B, 16: B}}


def tiny_config(**over):
    return get_config("stylegan-256", **dict(SMALL, **over))


def batch(seed, res):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (B, res, res, 3)).astype(np.uint8))


def assert_bitwise(a, b):
    la, lb = state_tensors(a), state_tensors(b)
    assert set(la) == set(lb)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    assert bad == []
    assert len(la) > 100


def run(cfg, state, n, first_seed):
    """n steps along the schedule, a stepper per phase seeded from the
    state's step, as the Trainer does."""
    phases = build_phases(cfg.schedule, cfg.model)
    steppers = {}
    for i in range(n):
        phase = phase_at(phases, state.shown_imgs)
        if phase.index not in steppers:
            steppers[phase.index] = make_lazy_stepper(
                cfg, phase, initial_step=state.step)
        state, m = steppers[phase.index](
            state, batch(first_seed + i, phase.resolution))
    return state, {k: float(v) for k, v in m.items()}


def test_save_restore_roundtrip_bitwise(tmp_path):
    cfg = tiny_config()
    state, _ = run(cfg, create_train_state(cfg, seed=0, device="cpu"), 2, 0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(state.step, state)
    mgr.wait()
    template = create_train_state(cfg, seed=42, device="cpu")  # different
    restored = mgr.restore(template)
    assert restored is template and restored.step == 2
    assert_bitwise(state, restored)
    mgr.close()


# The schedule: 8x8 stabilize at steps 0-3, 16x16 fade at 4-7, 16x16
# stabilize from 8; R1 on at steps 0, 4, 8. Saved after 3 steps, the next
# three cross the lazy-R1 boundary and the phase boundary into the fade;
# after 5, they lie inside the fade (alpha must come back from
# shown_imgs); after 6, they leave the fade across the R1 step 8.
@pytest.mark.parametrize("saved_at,kinds", [
    (3, ["stabilize", "fade", "fade"]),
    (5, ["fade", "fade", "fade"]),
    (6, ["fade", "fade", "stabilize"]),
], ids=["lazy_r1_and_phase_boundary", "inside_fade_phase",
        "out_of_fade_phase"])
def test_resume_continuation_equals_uninterrupted(tmp_path, saved_at, kinds):
    """steps + save + 3 steps equals restore + 3 steps on every leaf."""
    cfg = tiny_config()
    phases = build_phases(cfg.schedule, cfg.model)
    assert [phase_at(phases, s * B).kind for s in
            range(saved_at, saved_at + 3)] == kinds

    def start():
        return run(cfg, create_train_state(cfg, seed=1, device="cpu"),
                   saved_at, 0)[0]

    straight, m_straight = run(cfg, start(), 3, 100)

    interrupted = start()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    mgr.save(interrupted.step, interrupted)
    del interrupted
    resumed = mgr.restore(create_train_state(cfg, seed=99, device="cpu"))
    assert resumed.step == saved_at
    assert resumed.shown_imgs == saved_at * B
    resumed, m_resumed = run(cfg, resumed, 3, 100)

    assert m_straight == m_resumed
    assert_bitwise(straight, resumed)


def test_keep_last_k_latest_step_and_steps(tmp_path):
    cfg = tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert mgr.latest_step() is None and mgr.steps() == []
    assert mgr.restore(state) is None and mgr.load() is None
    for step in (1, 5, 3, 12):
        mgr.save(step, state)
    assert mgr.steps() == [5, 12]          # the newest two by step
    assert mgr.latest_step() == 12
    assert sorted(os.listdir(tmp_path / "ckpt")) == \
        ["ckpt_00000005.pt", "ckpt_00000012.pt"]
    assert mgr.restore(state, step=5) is state


def test_leftover_temporary_file_is_ignored(tmp_path):
    """A save that died before its rename leaves ``*.pt.tmp<pid>``: it is
    no checkpoint, and a later save of the same step replaces nothing of
    it."""
    cfg = tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    mgr.save(4, state)
    junk = tmp_path / "ckpt" / "ckpt_00000009.pt.tmp12345"
    junk.write_bytes(b"half a checkpoint")
    (tmp_path / "ckpt" / "notes.txt").write_text("not a checkpoint")
    assert mgr.steps() == [4] and mgr.latest_step() == 4
    assert mgr.restore(create_train_state(cfg, seed=7, device="cpu")).step == 0
    mgr.save(9, state)
    assert mgr.steps() == [4, 9] and junk.exists()
    files = os.listdir(tmp_path / "ckpt")
    assert not [f for f in files if ".tmp" in f and f != junk.name]


def test_checkpoint_holds_plain_tensors_and_numbers(tmp_path):
    cfg = tiny_config()
    state, _ = run(cfg, create_train_state(cfg, seed=0, device="cpu"), 1, 0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    payload = torch.load(mgr.path(1), weights_only=True)   # no pickled code
    assert set(payload) == {"format", "g", "d", "g_ema", "opt_g", "opt_d",
                            "w_avg", "step", "shown_imgs", "opt_step0",
                            "generator"}
    assert payload["step"] == 1 and payload["shown_imgs"] == B
    assert torch.equal(payload["generator"]["state"],
                       state.generator.get_state())


def test_reset_moments_restarts_the_count(tmp_path):
    cfg = tiny_config()
    state, _ = run(cfg, create_train_state(cfg, seed=0, device="cpu"), 3, 0)
    assert len(state.opt_g.state) > 0 and state.opt_step0 == 0
    reset_moments(state)
    assert len(state.opt_g.state) == 0 == len(state.opt_d.state)
    assert state.opt_step0 == state.step == 3
    state, _ = run(cfg, state, 1, 50)
    steps = {float(s["step"]) for s in state.opt_d.state.values()}
    assert steps == {1.0}                  # counted from the reset
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state)
    restored = mgr.restore(create_train_state(cfg, seed=5, device="cpu"))
    assert restored.opt_step0 == 3
    assert_bitwise(state, restored)


def test_late_parameter_gets_the_global_adam_count():
    """optax keeps one step count for the whole tree: a leaf whose
    gradient is zero for 5 steps and then non-zero is bias-corrected with
    t = 6. torch's Adam counts per parameter from its first gradient;
    ``seed_new_moments`` gives the late parameter the run's count."""
    rs = np.random.RandomState(0)
    early, late = (torch.nn.Parameter(torch.from_numpy(
        rs.randn(3, 4).astype(np.float32))) for _ in range(2))
    hp = dict(lr=1e-2, betas=(0.0, 0.99), eps=1e-8)
    opt = torch.optim.Adam([early, late], **hp)
    jopt = optax.adam(hp["lr"], b1=0.0, b2=0.99, eps=1e-8)
    params = {"early": early.detach().numpy().copy(),
              "late": late.detach().numpy().copy()}
    jstate = jopt.init(params)
    for i in range(8):
        g = {k: rs.randn(3, 4).astype(np.float32) for k in params}
        if i < 5:
            g["late"] = np.zeros_like(g["late"])
        upd, jstate = jopt.update(g, jstate, params)
        params = optax.apply_updates(params, upd)
        early.grad = torch.from_numpy(g["early"].copy())
        late.grad = torch.from_numpy(g["late"].copy()) if i >= 5 else None
        seed_new_moments(opt, i)
        opt.step()
        np.testing.assert_allclose(late.detach().numpy(),
                                   np.asarray(params["late"]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"late, step {i}")
    np.testing.assert_allclose(early.detach().numpy(),
                               np.asarray(params["early"]), rtol=1e-5,
                               atol=1e-7)
    assert float(opt.state[late]["step"]) == 8.0

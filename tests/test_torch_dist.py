"""Data parallelism of the port over two ``gloo`` processes on the CPU.

Two processes of ``tests/torch_dist_worker.py`` (one rank each, as
``torchrun --nproc-per-node 2`` would start them) train small models and
write what they hold; the port's ``optim.grad_accum`` = 2 step in this
process, fed both shards one after the other, is the reference. Held:

* the ranks' states (parameters, G-EMA, Adam, w-average, generator,
  counters) are bitwise identical after three steps (R1 on two of them);
* they equal the accumulating step's state, and the metrics its metrics,
  bit for bit: microbatch j of one process draws what rank j draws, and
  the gradients, metrics and batch mean of w are averaged the same way
  (a sum of two then a division by two, in either order the same bits);
* accumulation and data parallelism compose: the gradients of two ranks
  of two microbatches each equal one process's of four (1e-6 of each
  leaf's scale: the four are summed in another order);
* the ranks drew different latents; ``shown_imgs`` advanced by the global
  batch; the G-EMA's beta is the global batch's, and its horizon in
  images does not depend on the replica count (``optim.ema_kimg``);
* path length: ``pl_mean`` moves by the mean of both ranks' mean lengths
  and stays the same on both;
* ADA (``aug.mode=ada``, ``bcgfnu``): the ranks' states, ``ada_p``
  included, bit-equal to each other and to one process accumulating the
  two shards, metrics (``aug_p``, ``aug_rt``) too;
* ``loss.fused_seq`` (G's forward shared with the D phase) equal to the
  accumulating step (which recomputes it) bit for bit; ``loss.
  fused_g_step`` and ``loss.reg_separate`` (which refuse accumulation):
  two ranks fed the same shard and draws equal to one process bit for
  bit, the reg pass's gradients all-reduced like the main ones;
* a two-process ``Trainer``: each rank's data source is seeded
  ``run.seed + 7919 * rank``, rank 0 alone writes the log, the config and
  the checkpoint, a second ``Trainer`` on the workdir restores the state
  bit for bit on both ranks and continues bit for bit;
* ``cli train`` in two processes with the environment ``torchrun`` sets
  (the ``env://`` rendezvous), and ``--no-mesh`` refusing such a launch.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_dist_worker as W

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), "2", str(port), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)], out


@pytest.fixture(scope="module")
def accum():
    """The same three steps in one process, with grad_accum = 2."""
    return W.part_steps(0, 1, W.steps_cfg(**{"optim.grad_accum": 2}))


def _assert_same(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_replicas_stay_bitwise_identical(ranks):
    (r0, r1), _ = ranks
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    for part in ("steps", "pl"):
        _assert_same(r0[part]["tensors"], r1[part]["tensors"], part)
        assert r0[part]["metrics"] == r1[part]["metrics"]
    assert "generator" in r0["steps"]["tensors"]


def test_dp_equals_accumulation_over_the_same_shards(ranks, accum):
    (r0, _), _ = ranks
    _assert_same(r0["steps"]["tensors"], accum["tensors"],
                 "DP vs grad_accum")
    assert r0["steps"]["metrics"] == accum["metrics"]
    assert [m["penalty"] > 0 for m in accum["metrics"]] == \
        [True, False, True]


def test_dp_with_accumulation_equals_four_microbatches(ranks):
    (r0, r1), _ = ranks
    c0, c1 = r0["composed"], r1["composed"]
    _assert_same(c0["grads"], c1["grads"], "composed")
    want = W.part_composed(0, 1, 4)
    assert c0["counters"] == want["counters"] == (1, 4 * W.MICRO)
    assert torch.equal(c0["generator"], want["generator"])
    assert c0["grads"].keys() == want["grads"].keys()
    for k, v in want["grads"].items():
        scale = max(v.abs().max().item(), 1e-12)
        torch.testing.assert_close(c0["grads"][k], v, rtol=0,
                                   atol=1e-6 * scale, msg=k)


def test_ranks_draw_what_microbatches_draw(ranks, accum):
    """Rank j's first latents are microbatch j's of the accumulating
    step, and the two differ."""
    (r0, r1), _ = ranks
    z0, z1 = r0["steps"]["draws"], r1["steps"]["draws"]
    assert len(accum["draws"]) == 2 * 3 and len(z0) == 3
    assert torch.equal(z0[0], accum["draws"][0])
    assert torch.equal(z1[0], accum["draws"][1])
    assert not torch.equal(z0[0], z1[0])


def test_shown_images_and_ema_follow_the_global_batch(ranks, accum):
    (r0, _), _ = ranks
    cfg = W.steps_cfg()
    assert (r0["steps"]["step"], r0["steps"]["shown"]) == (3, 3 * 2 * W.MICRO)
    assert accum["shown"] == r0["steps"]["shown"]
    betas = r0["steps"]["betas"]
    assert betas == accum["betas"] == [cfg.optim.ema_beta_for(2 * W.MICRO)] * 3
    # the horizon in images does not depend on how many replicas share it
    per_image = betas[0] ** (1.0 / (2 * W.MICRO))
    assert cfg.optim.ema_beta_for(W.MICRO) ** (1.0 / W.MICRO) == \
        pytest.approx(per_image, rel=1e-12)


def test_pl_mean_moves_by_the_mean_over_ranks(ranks):
    (r0, r1), _ = ranks
    decay = W.pl_cfg().loss.pl_decay
    assert len(r0["pl"]["pl"]) == len(r1["pl"]["pl"]) == 2
    for (m0, l0, n0), (m1, l1, n1) in zip(r0["pl"]["pl"], r1["pl"]["pl"]):
        assert m0 == m1 and n0 == n1 and l0 != l1
        assert n0 == pytest.approx(m0 + decay * ((l0 + l1) / 2 - m0),
                                   rel=1e-6)
    assert r0["pl"]["tensors"]["pl_mean"].item() == n0 > 0


def test_ada_dp_equals_accumulation_over_the_same_shards(ranks):
    """Each rank augments its shard with its own draws; rt is averaged over
    the ranks as over the microbatches, so ``ada_p`` moves alike."""
    (r0, r1), _ = ranks
    _assert_same(r0["ada"]["tensors"], r1["ada"]["tensors"], "ada ranks")
    want = W.part_steps(0, 1, W.ada_cfg(**{"optim.grad_accum": 2}))
    _assert_same(r0["ada"]["tensors"], want["tensors"], "ada DP vs accum")
    assert r0["ada"]["metrics"] == r1["ada"]["metrics"] == want["metrics"]
    ps = [m["aug_p"] for m in want["metrics"]]
    rate = 2 * W.MICRO / (W.ada_cfg().aug.kimg * 1000)
    assert all(abs(abs(b - a) - rate) < 1e-6
               for a, b in zip([0.5] + ps, ps))
    assert r0["ada"]["tensors"]["ada_p"].item() == ps[-1]


def test_fused_seq_dp_equals_accumulation_over_the_same_shards(ranks):
    """``loss.fused_seq``: each rank's G phase takes the D phase's graph
    (one microbatch), the accumulating process recomputes each
    microbatch's forward from its D draws: the same bits."""
    (r0, r1), _ = ranks
    _assert_same(r0["fused_seq"]["tensors"], r1["fused_seq"]["tensors"],
                 "fused_seq ranks")
    want = W.part_steps(0, 1, W.steps_cfg(**{"loss.fused_seq": True,
                                             "optim.grad_accum": 2}))
    _assert_same(r0["fused_seq"]["tensors"], want["tensors"],
                 "fused_seq DP vs accum")
    assert r0["fused_seq"]["metrics"] == want["metrics"]


@pytest.mark.parametrize("recipe", ["fused_g_step", "reg_separate"])
def test_recipe_ranks_on_one_shard_equal_one_process(ranks, recipe):
    """The JAX package's DP guarantee for the steps that refuse
    accumulation: two ranks fed the same shard and draws hold the
    one-process step's state bit for bit (the shown-image count is the
    global batch's)."""
    (r0, r1), _ = ranks
    got = [r[f"same_{recipe}"] for r in (r0, r1)]
    want = W.part_same(0, 1, recipe)
    for g in got:
        _assert_same({k: v for k, v in g["tensors"].items()
                      if k != "counters"},
                     {k: v for k, v in want["tensors"].items()
                      if k != "counters"}, f"{recipe} DP vs one process")
        assert g["metrics"] == want["metrics"]
        assert g["counters"] == (3, 3 * 2 * W.MICRO)
    assert want["counters"] == (3, 3 * W.MICRO)
    assert [m["penalty"] > 0 for m in want["metrics"]] == [True, False, True]


def test_chunked_dp_equals_one_process_accumulating_two(ranks):
    """Two ranks, each stacking its own shards, step the chunk cycle as
    one process with ``optim.grad_accum`` = 2 stacking the whole global
    batches: the same consumed counts, stacked metrics and state."""
    (r0, r1), _ = ranks
    want = W.part_chunked(0, 1, W.steps_cfg(**{"optim.grad_accum": 2}))
    _assert_same(r0["chunked"]["tensors"], r1["chunked"]["tensors"],
                 "chunked ranks")
    _assert_same(r0["chunked"]["tensors"], want["tensors"],
                 "chunked DP vs accum")
    assert r0["chunked"]["consumed"] == want["consumed"] == [2, 2, 1]
    assert r0["chunked"]["metrics"] == r1["chunked"]["metrics"] == \
        want["metrics"]
    assert [p > 0 for m in want["metrics"] for p in m["penalty"]] == \
        [True, False, True, False, True]


def test_trainer_resumes_bit_for_bit_on_both_ranks(ranks):
    (r0, r1), out = ranks
    for r in (r0, r1):
        t = r["trainer"]
        assert t["source_seeded"] and t["restored_equal"] \
            and t["continued_equal"]
        assert (t["step"], t["shown"]) == (3, 3 * 2 * W.MICRO)
    assert not np.array_equal(r0["trainer"]["first_batch"],
                              r1["trainer"]["first_batch"])
    _assert_same(r0["trainer"]["tensors"], r1["trainer"]["tensors"],
                 "trainer")
    run = out / "run"
    rows = (run / "train.jsonl").read_text().splitlines()
    assert len(rows) == 3                     # rank 0's rows only
    assert (run / "config.json").exists()
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == \
        ["ckpt_00000003.pt"]


def _cli_train_args(workdir):
    args = ["train", "--preset", "stylegan-256", "--device", "cpu",
            "--workdir", str(workdir), "--max-steps", "2"]
    # a row every step (chunked stepping logs once a chunk)
    for k, v in dict(W.SMALL, **{"run.log_every": 1,
                                 "run.chunk_steps": False,
                                 "run.num_sample_images": 4}).items():
        args += ["--set", f"{k}={v}"]
    return args


def test_cli_train_under_a_launcher(tmp_path):
    """``cli train`` as ``torchrun --nproc-per-node 2`` starts it (RANK,
    WORLD_SIZE, LOCAL_RANK and the rendezvous in the environment): both
    ranks train, rank 0 alone logs, checkpoints and writes the samples."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ganlab_tpu_torch.cli",
             *_cli_train_args(tmp_path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "final samples:" in logs[0] and "final samples:" not in logs[1]
    assert "x 2 ranks" in logs[0]
    assert len((tmp_path / "train.jsonl").read_text().splitlines()) == 2
    assert [p.name for p in (tmp_path / "checkpoints").iterdir()] == \
        ["ckpt_00000002.pt"]
    saved = torch.load(tmp_path / "checkpoints" / "ckpt_00000002.pt",
                       weights_only=True)
    assert saved["shown_imgs"] == 2 * 2 * W.MICRO


def test_cli_no_mesh_refuses_a_launch_of_several(tmp_path, monkeypatch):
    from ganlab_tpu_torch.cli import main

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--no-mesh runs one process"):
        main([*_cli_train_args(tmp_path), "--no-mesh"])

"""The progressive trainer as a whole: the port's ``Trainer`` beside the JAX
package's, the command line, serving from a workdir, the learners.

The same tiny progressive config (8 -> 16 -> 32, five phases of three steps
at batch 2, fmap_max 8, latent 8, float32, ``synthetic`` data, no penalty so
that the JAX side compiles one program a phase: about a minute cold, seconds
with the tests' persistent compile cache) runs through
``ganlab_tpu.train.loop.Trainer`` and the port's ``Trainer``. Their logs must
hold the same ``(step, res, kind, shown_imgs, alpha)`` rows, alpha within
1e-6 (the packages draw other random numbers, so losses are not compared
here; ``test_torch_train_step.py`` holds a step's numbers leaf by leaf).
The port's copy of ``schedule.py`` is held to the golden table of
``tests/test_schedule.py``. Bitwise claims (resume, serving from a workdir)
use ``torch.equal`` / ``np.array_equal``: one device, same steps, same bits.
The carried-over JAX ``TrainState`` is held to optax's next Adam update
within 1e-5 relative (other operation order in the update).
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.train.loop import Trainer as JaxTrainer
from ganlab_tpu.train.state import create_train_state as jax_create_state
from ganlab_tpu.train.state import make_optimizers as jax_make_optimizers
from ganlab_tpu_torch import BatchSampler, cli, get_config
from ganlab_tpu_torch.config import ModelConfig, ScheduleConfig
from ganlab_tpu_torch.convert import from_flax, load_jax_train_state
from ganlab_tpu_torch.learners import (
    ProGANLearner,
    ResNetGANLearner,
    StyleGANLearner,
)
from ganlab_tpu_torch.train import (
    Trainer,
    alpha_at,
    build_phases,
    create_train_state,
    phase_at,
    state_tensors,
)

# The tensors here are small: one intra-op thread is as fast as eight, and
# test processes that run side by side do not fight over the cores.
torch.set_num_threads(1)

B = 2
TINY = {"model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "schedule.start_res": 8,
        "schedule.fade_kimg": 0.006, "schedule.stabilize_kimg": 0.006,
        "schedule.total_kimg": 0.03,
        "schedule.batch_schedule": {8: B, 16: B, 32: B},
        "data.dataset": "synthetic", "run.log_every": 1,
        "run.chunk_steps": False, "run.checkpoint_every": 0,
        "run.sample_every": 0, "loss.penalty": "none"}
# (resolution, kind) of the five phases of TINY, three steps each
PHASES = [(8, "stabilize"), (16, "fade"), (16, "stabilize"), (32, "fade"),
          (32, "stabilize")]
N_STEPS = 15
ROW = ("step", "res", "kind", "shown_imgs")


def tiny_config(**over):
    return get_config("stylegan-256", **dict(TINY, **over))


def read_log(workdir) -> list[dict]:
    with open(os.path.join(workdir, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_states_bitwise(a, b):
    la, lb = state_tensors(a), state_tensors(b)
    assert set(la) == set(lb)
    assert [k for k in la if not torch.equal(la[k], lb[k])] == []
    assert len(la) > 100


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's Trainer over the whole tiny schedule, on the CPU."""
    workdir = str(tmp_path_factory.mktemp("port_run"))
    trainer = Trainer(tiny_config(), workdir, device="cpu")
    last = trainer.train()
    trainer.close()
    return dict(workdir=workdir, trainer=trainer, last=last,
                rows=read_log(workdir))


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("jax_run"))
    trainer = JaxTrainer(jax_get_config("stylegan-256", **TINY), workdir,
                         use_mesh=False)
    trainer.train()
    trainer.close()
    return read_log(workdir)


def test_schedule_copy_golden_table():
    """The table of ``tests/test_schedule.py``, on the port's copy."""
    sched = ScheduleConfig(progressive=True, start_res=4, fade_kimg=2.0,
                           stabilize_kimg=3.0, total_kimg=20.0,
                           batch_schedule={4: 16, 8: 8, 16: 4})
    phases = build_phases(sched, ModelConfig(model="progan", resolution=16))
    assert [(p.res_log2, p.kind, p.start_img, p.end_img, p.batch_size)
            for p in phases] == [
        (2, "stabilize", 0, 3000, 16), (3, "fade", 3000, 5000, 8),
        (3, "stabilize", 5000, 8000, 8), (4, "fade", 8000, 10000, 4),
        (4, "stabilize", 10000, 20000, 4)]
    p = phase_at(phases, 3000)
    assert (p.res_log2, p.kind) == (3, "fade")
    assert alpha_at(p, 3000) == 0.0
    assert alpha_at(p, 4000) == pytest.approx(0.5)
    assert alpha_at(phase_at(phases, 5000), 5000) == 1.0
    assert phase_at(phases, 10 ** 9).index == 4


def test_port_trainer_walks_every_phase(port_run):
    rows, trainer = port_run["rows"], port_run["trainer"]
    assert [(p.resolution, p.kind) for p in trainer.phases] == PHASES
    assert [r["step"] for r in rows] == list(range(1, N_STEPS + 1))
    assert [(r["res"], r["kind"]) for r in rows] == \
        [pk for pk in PHASES for _ in range(3)]
    assert [r["shown_imgs"] for r in rows] == \
        [B * s for s in range(1, N_STEPS + 1)]
    # alpha from the count before the step: 0, 1/3, 2/3 in a fade phase
    for r in rows:
        k = (r["step"] - 1) % 3
        want = k / 3 if r["kind"] == "fade" else 1.0
        assert r["alpha"] == pytest.approx(want, abs=1e-6)
    for r in rows:
        assert all(np.isfinite(r[k]) for k in
                   ("d_loss", "g_loss", "penalty", "real_score",
                    "fake_score"))
    assert (trainer.state.step, trainer.state.shown_imgs) == (N_STEPS,
                                                              N_STEPS * B)
    assert set(port_run["last"]) >= {"d_loss", "g_loss", "alpha"}
    # one step function a phase, built once; the final checkpoint
    assert len(trainer._steps) == len(PHASES)
    assert trainer.ckpt.steps() == [N_STEPS]
    assert os.path.exists(os.path.join(port_run["workdir"], "config.json"))


def test_trainers_log_the_same_rows(port_run, jax_rows):
    """(step, res, kind, shown_imgs, alpha) of every logged step, the port's
    Trainer against the JAX package's."""
    rows = port_run["rows"]
    assert len(rows) == len(jax_rows) == N_STEPS
    for got, want in zip(rows, jax_rows):
        assert {k: got[k] for k in ROW} == {k: want[k] for k in ROW}
        assert got["alpha"] == pytest.approx(want["alpha"], abs=1e-6)
        assert set(want) - {"time"} <= set(got)


def test_resumed_trainer_continues_the_run(port_run, tmp_path):
    """7 steps (into the 16x16 stabilize phase), then a new Trainer on the
    same workdir: it holds the first one's state bit for bit, walks the
    remaining phases to the same counters, and the log continues with
    global step keys. (The data source starts over in a new process, as in
    the JAX package, so the later weights are another trajectory;
    ``test_torch_checkpoint.py`` holds resume + steps on given batches bit
    for bit.)"""
    workdir = str(tmp_path)
    first = Trainer(tiny_config(), workdir, device="cpu")
    first.train(max_steps=7)
    first.close()
    assert first.ckpt.steps() == [7]
    second = Trainer(tiny_config(), workdir, device="cpu")
    assert (second.state.step, second.state.shown_imgs) == (7, 7 * B)
    assert_states_bitwise(second.state, first.state)
    second.train()
    second.close()
    want = port_run["trainer"].state
    assert (second.state.step, second.state.shown_imgs) == \
        (want.step, want.shown_imgs)
    assert set(state_tensors(second.state)) == set(state_tensors(want))
    assert second.ckpt.steps() == [7, N_STEPS]
    rows = read_log(workdir)
    assert [r["step"] for r in rows] == list(range(1, N_STEPS + 1))
    for got, ref in zip(rows, port_run["rows"]):
        assert {k: got[k] for k in ROW + ("alpha",)} == \
            {k: ref[k] for k in ROW + ("alpha",)}
    # the first phase saw the same batches and draws: the same numbers
    # (how far a phase's prefetcher had read ahead when it closed is a
    # matter of timing, so later phases may see other batches)
    for got, ref in zip(rows[:3], port_run["rows"][:3]):
        assert {k: v for k, v in got.items() if k != "time"} == \
            {k: v for k, v in ref.items() if k != "time"}


def test_cadences_and_max_steps(tmp_path):
    """log_every 2, checkpoint_every 4, sample_every 5 over 9 steps."""
    workdir = str(tmp_path)
    cfg = tiny_config(**{"run.log_every": 2, "run.checkpoint_every": 4,
                         "run.sample_every": 5, "run.num_sample_images": 4,
                         "run.keep_checkpoints": 2})
    trainer = Trainer(cfg, workdir, device="cpu")
    trainer.train(max_steps=9)
    trainer.close()
    assert [r["step"] for r in read_log(workdir)] == [2, 4, 6, 8]
    assert trainer.ckpt.steps() == [8, 9]        # 4 dropped by keep-2
    assert sorted(os.listdir(os.path.join(workdir, cfg.run.sample_dir))) == \
        ["step00000005_res16.png"]


def test_reset_moments_on_phase(tmp_path):
    """With ``optim.reset_moments_on_phase`` Adam's count restarts at each
    phase boundary of a run; without it the moments live on (a head that a
    phase switched on takes the run's count)."""
    def adam_steps(**over):
        trainer = Trainer(tiny_config(**over), str(tmp_path / str(len(over))),
                          device="cpu")
        trainer.train(max_steps=5)               # 3 at 8x8, 2 in the fade
        trainer.close()
        st = trainer.state
        return st, {float(s["step"]) for s in st.opt_d.state.values()}

    st, steps = adam_steps(**{"optim.reset_moments_on_phase": True})
    assert steps == {2.0} and st.opt_step0 == 3
    st, steps = adam_steps()
    assert steps == {5.0} and st.opt_step0 == 0


@pytest.mark.parametrize("knob", [{"run.profile": True},
                                  {"run.eval_kimg": 1.0},
                                  {"run.tensorboard": True}],
                         ids=lambda k: next(iter(k)))
def test_unported_trainer_options_raise(tmp_path, knob):
    """Every option is ported now. run.eval_kimg and run.tensorboard
    (tests/test_torch_eval.py, tests/test_torch_cli_latents.py): a Trainer
    with them builds and closes. run.profile: a run of 21 steps writes the
    trace of its steps 10-19 under <workdir>/profile at step 20, and a run
    that ends at step 12 closes its open trace and writes it, with the
    program's spans in it."""
    if "run.profile" in knob:
        for steps, name in ((21, "trace_step00000020.json"),
                            (12, "trace_step00000012.json")):
            wd = tmp_path / str(steps)
            cfg = tiny_config(**knob, **{"schedule.total_kimg": 1.0})
            trainer = Trainer(cfg, str(wd), device="cpu")
            trainer.train(max_steps=steps)
            trainer.close()
            assert trainer._trace is None and trainer.state.step == steps
            assert [p.name for p in (wd / "profile").iterdir()] == [name]
            trace = json.loads((wd / "profile" / name).read_text())
            ops = {e.get("name") for e in trace["traceEvents"]}
            assert "ganlab::adain" in ops and "aten::conv2d" in ops
            # the program's spans: the wait for a batch and each step
            assert "train.data" in ops and "step.plain" in ops
        return
    trainer = Trainer(tiny_config(**knob), str(tmp_path), device="cpu")
    trainer.close()


def test_cuda_default_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tiny_config(), str(tmp_path))


def test_cli_train_sample_and_serve_from_workdir(tmp_path, capsys):
    """``cli train --device cpu --max-steps N`` -> ``cli sample`` ->
    ``BatchSampler(cfg, workdir=)``, each on what the one before wrote."""
    workdir = str(tmp_path / "run")
    sets = [a for k, v in dict(TINY, **{"run.num_sample_images": 4}).items()
            for a in ("--set", f"{k}={v}")]
    assert cli.main(["train", "--preset", "stylegan-256", "--workdir",
                     workdir, "--device", "cpu", "--max-steps", "5",
                     *sets]) == 0
    rows = read_log(workdir)
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert (rows[-1]["res"], rows[-1]["kind"]) == (16, "fade")
    assert os.path.exists(os.path.join(workdir, "samples",
                                       "final_res32.png"))

    # a bare --workdir rebuilds the trained model from its config.json
    png = str(tmp_path / "grid.png")
    assert cli.main(["sample", "--workdir", workdir, "--device", "cpu",
                     "--psi", "0.7", "--num", "4", "--out", png]) == 0
    assert "config.json" in capsys.readouterr().out
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    cfg = tiny_config()
    resumed = Trainer(cfg, workdir, device="cpu")
    resumed.close()
    assert resumed.state.step == 5
    from_disk = BatchSampler(cfg, workdir=workdir, batch_size=4,
                             device="cpu")
    from_state = BatchSampler(cfg, state=resumed.state, batch_size=4,
                              device="cpu")
    imgs = from_disk.generate(6, seed=3)
    assert imgs.shape == (6, 32, 32, 3) and imgs.dtype == np.uint8
    assert np.array_equal(imgs, from_state.generate(6, seed=3))


def test_batch_sampler_sources_are_exclusive(tmp_path):
    cfg = tiny_config()
    with pytest.raises(FileNotFoundError):
        BatchSampler(cfg, workdir=str(tmp_path), device="cpu")
    state = create_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        BatchSampler(cfg, workdir=str(tmp_path), state=state, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        BatchSampler(cfg, device="cpu")
    with pytest.raises(ValueError, match="w_avg"):
        BatchSampler(cfg, params=state.g_ema.state_dict(), device="cpu")


def test_learners(tmp_path):
    learner = StyleGANLearner(workdir=str(tmp_path), device="cpu", **TINY)
    assert learner.config.model.resolution == 32
    learner.train(max_steps=2)
    assert learner.state.step == 2
    learner.train(max_steps=1)
    learner.save_model()
    assert learner.trainer.ckpt.steps() == [2, 3]
    w_saved = learner.state.w_avg.clone()
    with torch.no_grad():
        learner.state.w_avg.add_(1.0)
    assert learner.load_model()
    assert torch.equal(learner.state.w_avg, w_saved)
    assert learner.trainer._steps == {}          # counters re-seed
    assert os.path.exists(learner.gen_samples(tag="t"))
    learner.close()
    with pytest.raises(ValueError, match="either"):
        StyleGANLearner(tiny_config(), str(tmp_path), device="cpu", **TINY)
    with pytest.raises(ValueError, match="expects model"):
        StyleGANLearner(get_config("progan-128"), str(tmp_path),
                        device="cpu")
    # the other two learners train their default presets, cut narrow
    common = {"model.latent_dim": 8, "run.compute_dtype": "float32",
              "data.dataset": "synthetic", "run.log_every": 1}
    for cls, preset, over in (
            (ProGANLearner, "progan-128", {
                "model.resolution": 16, "model.fmap_base": 32,
                "schedule.batch_schedule": {4: B}}),
            (ResNetGANLearner, "resnetgan-cifar10", {
                "model.base_channels": 8,
                "schedule.batch_schedule": {32: B}})):
        other = cls(workdir=str(tmp_path / preset), device="cpu",
                    **common, **over)
        assert other.config.model.model == cls.MODEL
        assert other.config.loss.penalty == get_config(preset).loss.penalty
        other.train(max_steps=2)
        assert other.state.step == 2
        assert os.path.exists(other.gen_samples(tag="t"))
        other.close()


def test_jax_train_state_carries_over():
    """A JAX ``TrainState`` after two optax updates, as numpy arrays, into
    the port's ``TrainState``: parameters, moments and count are such that
    a third update on the same gradients ends in the same parameters."""
    jcfg = jax_get_config("stylegan-256", **TINY)
    js = jax_create_state(jcfg, jax.random.PRNGKey(0))
    jopts = jax_make_optimizers(jcfg, resolution=16)
    rs = np.random.RandomState(0)

    def random_like(tree):
        return jax.tree_util.tree_map(
            lambda a: rs.randn(*a.shape).astype(np.float32), tree)

    def update(js, grads):
        out = {}
        for net, jopt in zip("gd", jopts):
            upd, opt = jopt.update(grads[net], getattr(js, f"opt_{net}"),
                                   getattr(js, f"params_{net}"))
            out[f"opt_{net}"] = opt
            out[f"params_{net}"] = optax.apply_updates(
                getattr(js, f"params_{net}"), upd)
        return js.replace(**out)

    for _ in range(2):
        js = update(js, {"g": random_like(js.params_g),
                         "d": random_like(js.params_d)})
    js = js.replace(step=js.step + 2, shown_imgs=js.shown_imgs + 2.0 * B,
                    w_avg=js.w_avg + 0.5)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    arrays = {k: to_np(getattr(js, k)) for k in
              ("params_g", "params_d", "params_ema", "w_avg")}
    for k in ("opt_g", "opt_d"):
        adam = getattr(js, k)[0]
        arrays[k] = {"count": int(adam.count), "mu": to_np(adam.mu),
                     "nu": to_np(adam.nu)}
    arrays.update(step=int(js.step), shown_imgs=float(js.shown_imgs))

    cfg = tiny_config()
    st = load_jax_train_state(create_train_state(cfg, seed=9, device="cpu"),
                              arrays, cfg)
    assert (st.step, st.shown_imgs, st.opt_step0) == (2, 2 * B, 0)
    assert torch.equal(st.w_avg, torch.full((8,), 0.5))
    assert all(float(s["step"]) == 2.0 for s in st.opt_g.state.values())

    grads = {"g": random_like(js.params_g), "d": random_like(js.params_d)}
    js = update(js, grads)
    from ganlab_tpu_torch.train.state import optimizer_hparams

    for net, hp in zip("gd", optimizer_hparams(cfg, 16)):
        module, opt = getattr(st, net), getattr(st, f"opt_{net}")
        for group in opt.param_groups:
            group.update(hp)
        sd = from_flax(grads[net])
        for name, p in module.named_parameters():
            p.grad = sd[name].clone()
        opt.step()
        want = from_flax(to_np(getattr(js, f"params_{net}")))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)

"""The StyleGAN2 training cell (``sg2f-256-train-b32-pl``) on the CPU at a
tiny size, in float32: a sound run is correct with gaps at round-off; the
reference's parameter lists are the program's state dicts at config F's
widths; the work counts match a hand count and the program's kernel
launches; planted faults and the float8 control each fail the cell's
limits or read far above a sound run."""

import argparse
import json
import math

import pytest
import torch

from conftest import PORTBENCH, ROOT, TINY, load

CELL = "sg2f-256-train-b32-pl"
TRAFFIC = {"batch": 4, "resolution": 16, "reference_rows": 3}


def tiny_run(harness, seed=2147483999, rows=3):
    return harness.main(["--workload", CELL, "--seed", str(seed),
                         "--seconds", "0.2", "--trace", "0"],
                        device="cpu", overrides=TINY,
                        traffic_overrides=dict(TRAFFIC, reference_rows=rows))


@pytest.mark.parametrize("rows", [3, 1], ids=["whole", "blocks_of_one"])
def test_sound_run_matches_reference(harness, rows):
    """Through the cell's chunked stepper: R1 + path length at step 0,
    the followed stage through the next path-length head; with blocks of
    one row the reference's R1 and path length are put back together
    from parts."""
    res = tiny_run(harness, rows=rows)
    assert res["correct"], res["checks"]
    assert {"pl_err", "pl_mean_err", "grad_g_err", "stage_traj_err"} \
        <= set(res["checks"])
    for name, c in res["checks"].items():
        assert c["value"] <= 1e-4, (name, c)
    for name, v in res["readings"].items():
        assert v <= 1e-4, (name, v)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}


def test_parameter_specs_name_every_leaf_at_config_f():
    from ganlab_tpu_torch.config import get_config
    from ganlab_tpu_torch.models import build_models
    from portbench.reference import stylegan2 as S2

    c = json.load(open(PORTBENCH / "configs" / "stylegan2-f-256.json"))
    cfg = get_config(c["preset"], **c["changed"])
    assert (cfg.model.fmap_base, cfg.model.nf(6), cfg.model.nf(7),
            cfg.model.nf(8)) == (16384, 256, 128, 64)
    with torch.device("meta"):
        g, d = build_models(cfg.model)
    for spec, net in ((S2.g_spec(c["model"]), g),
                      (S2.d_spec(c["model"]), d)):
        want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert {n: tuple(s) for n, s, _, _ in spec} == want


M16 = {"resolution": 16, "img_channels": 3, "latent_dim": 16,
       "fmap_base": 64, "fmap_max": 512, "fmap_min": 1, "mapping_layers": 8}


def test_work_by_hand():
    """At 16x16, fmap_base 64 (32 channels at 4x4, 16 at 8x8, 8 at
    16x16), latent 16."""
    from portbench.work import stylegan2 as W

    z = 16
    # conv4; block8 32 -> 16 -> 16; block16 16 -> 8 -> 8; toRGB at 4, 8,
    # 16 (no demodulation): conv + affine (z x in) + demod (in x out)
    syn = (9 * 16 * 32 * 32 + z * 32 + 32 * 32
           + 9 * 64 * 32 * 16 + z * 32 + 32 * 16
           + 9 * 64 * 16 * 16 + z * 16 + 16 * 16
           + 9 * 256 * 16 * 8 + z * 16 + 16 * 8
           + 9 * 256 * 8 * 8 + z * 8 + 8 * 8
           + 16 * 32 * 3 + z * 32 + 64 * 16 * 3 + z * 16
           + 256 * 8 * 3 + z * 8)
    assert W.synthesis_macs(M16) == syn
    # fromRGB 3 -> 8 at 16; block16 8 -> 8 -> 16 and its skip 8 -> 16;
    # block8 16 -> 16 -> 32 and skip 16 -> 32; the output block
    d = (256 * 3 * 8 + 9 * 256 * (8 * 8 + 8 * 16) + 256 * 8 * 16
         + 9 * 64 * (16 * 16 + 16 * 32) + 64 * 16 * 32
         + 9 * 16 * 33 * 32 + 512 * 32 + 32)
    assert W.d_forward_macs(M16) == d
    mapping = 8 * z * z
    plain = 2 * 4 * (4 * (syn + 2 * mapping) + 8 * d)
    assert W.train_step_flops(M16, 4, False, False, 2) == plain
    assert W.train_step_flops(M16, 4, True, True, 2) \
        == plain + 2 * 4 * 6 * d + 2 * 2 * (6 * syn + 3 * mapping)


def test_config_f_step_flops():
    from portbench.work import stylegan2 as W

    c = json.load(open(PORTBENCH / "configs" / "stylegan2-f-256.json"))
    m = c["model"]
    # the 256x256 block: 3x3 convs 256 -> 128 and 128 -> 128 over 256^2
    assert 9 * 65536 * (256 * 128 + 128 * 128) == pytest.approx(28.99e9,
                                                                rel=1e-3)
    plain = W.train_step_flops(m, 32, False, False, 16)
    assert plain / 1e12 == pytest.approx(67.23, abs=0.01)
    w = W.window_work(c, 32, 2, {}, 2, None)
    per_cycle = [W.train_step_flops(m, 32, r1, pl, 16)
                 for r1, pl in W.cycle_steps(c)]
    assert W.cycle_steps(c).count((True, True)) == 1
    assert W.cycle_steps(c).count((False, True)) == 3
    assert W.cycle_steps(c).count((False, False)) == 12
    assert w["model_flops"] == 2 * sum(per_cycle)


def _launches(inst, kernel_file):
    """kernel launches by input shape of the (op, pass) pairs a kernel
    file names: a forward and a double backward (up+blur's, or blur+down's
    backward's backward) at the op's input shape, a backward at its
    output's."""
    out = {}
    for op, pas in kernel_file["passes"]:
        for shape, times in inst.get((op, pas), []):
            if pas == "backward":
                n, c, h, w = shape
                f = 2 if op == "upsample_blur" else 0.5
                shape = (n, c, int(h * f), int(w * f))
            out[shape] = out.get(shape, 0) + times
    return out


@pytest.mark.parametrize("r1,pl", [(False, False), (True, True),
                                   (False, True)])
def test_passes_match_the_program_launch_counts(r1, pl):
    """The passes a step runs, by kernel file and shape, against
    ``chip_smoke.stylegan2_step_launches`` (which a program test holds to
    a counted step)."""
    chip_smoke = pytest.importorskip("chip_smoke")
    from ganlab_tpu_torch.config import get_config
    from portbench.work import stylegan2 as W

    cfg = get_config("stylegan2-256", **{"model.resolution": 32,
                                         "model.fmap_base": 128})
    m = {k: getattr(cfg.model, k) for k in M16}
    inst = W.instances(m, 4, r1, pl, 2)
    want = chip_smoke.stylegan2_step_launches(cfg.model, r1, pl, batch=4,
                                              pl_batch=2)
    names = {"upsample_blur": "upsample_blur_2x",
             "blur_down": "blur_downsample_2x",
             "mbstd": "minibatch_stddev", "pixelnorm": "pixelnorm"}
    for stem, kernel in names.items():
        kf = json.load(open(PORTBENCH / "kernels" / f"{stem}.json"))
        assert _launches(inst, kf) == want[kernel], stem
    assert set(want) == set(names.values())


# -- faults and the control ---------------------------------------------------
def _pl_off(monkeypatch):
    """The path-length penalty is computed and reported, and left out of
    G's objective."""
    from ganlab_tpu_torch.train import steps

    pl = steps.path_length_penalty

    def off(*args, **kwargs):
        pen, mean, lens = pl(*args, **kwargs)
        return pen.detach(), mean, lens

    monkeypatch.setattr(steps, "path_length_penalty", off)


def _pl_half(monkeypatch):
    """The path lengths are taken over the first half of their rows."""
    from ganlab_tpu_torch.train import steps

    pl = steps.path_length_penalty

    def half(g, pl_mean, dr, *args, **kwargs):
        n = dr.z.shape[0] // 2
        return pl(g, pl_mean, steps.PLDraws(
            dr.z[:n], [nz[:n] for nz in dr.noises], dr.y[:n]), *args,
            **kwargs)

    monkeypatch.setattr(steps, "path_length_penalty", half)


def _training_fault(name):
    faults = load("portbench_faults_for_sg2",
                  PORTBENCH / "tests" / "test_portbench_faults.py")
    return getattr(faults, name)


@pytest.mark.parametrize("fault", ["pl_off", "pl_half", "_half_loss",
                                   "_unchanged"],
                         ids=["pl_left_out_of_g", "pl_on_half_its_rows",
                              "half_batch_after_forward", "state_unchanged"])
def test_fault_is_caught(harness, monkeypatch, fault):
    plant = {"pl_off": _pl_off, "pl_half": _pl_half}.get(fault) \
        or _training_fault(fault)
    plant(monkeypatch)
    res = tiny_run(harness)
    assert res["correct"] is False, res["checks"]


def _control(seed, device="cpu", tiny=True):
    cal = load("portbench_calibrate_sg2_under_test",
               PORTBENCH / "calibrate_sg2.py")
    bench = cal.run.load_json(ROOT / "BENCHMARK.json")
    a = argparse.Namespace(workload=CELL, seed=seed, seconds=0.0, trace=0)
    h = cal.run.Harness(a, bench, device, TINY if tiny else None,
                        TRAFFIC if tiny else None)
    driver = cal.run.load_module(PORTBENCH / "drivers" / "train_sg2.py")
    (ctl,) = cal.upper(h, driver, seed, faults=())
    return ctl, h.limits


def test_control_reads_far_above_a_sound_run_tiny(harness):
    ctl, _ = _control(11)
    sound = tiny_run(harness, seed=11)["checks"]
    assert any(ctl[name] > 100 * max(c["value"], 1e-4)
               for name, c in sound.items()), (ctl, sound)
    assert all(math.isfinite(ctl[name]) for name in sound)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2718281828, 3141592653, 1618033988])
def test_control_is_not_correct_on_card(card, seed):
    ctl, limits = _control(seed, str(card), tiny=False)
    assert any(ctl[k] > v for k, v in limits.items()), ctl

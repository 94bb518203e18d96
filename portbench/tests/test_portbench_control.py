"""The control: the reference with float8 GEMMs (the precision below the
configurations' bfloat16) put in the program's place. At the cells' own
size on the card (``gpu``), on three seeds, it comes out not correct
under each cell's limits. On the CPU at the tiny size, where the limits
set for the full size do not carry over, a compared number reads the
control far above the program's sound run (the control has to fail one
of a cell's numbers, not each: the Adam and EMA steps' medians read
arithmetic that float8 GEMMs leave as it is)."""

import argparse

import pytest

from conftest import PORTBENCH, TINY, TINY_TRAFFIC, load, tiny_run

CELLS = {"sg256-train-b32": "train", "sg1024-train-b32": "train",
         "sg1024-serve-b32": "serve_export"}


def _control_fails(cal, h, seed):
    driver = cal.run.load_module(PORTBENCH / "drivers"
                                 / f"{h.traffic['driver']}.py")
    rows = cal.upper_train(h, driver, seed, faults=False) \
        if h.traffic["driver"] == "train" \
        else cal.upper_serve(h, driver, seed, requests=2)
    ctl = next(r for r in rows if r["kind"] == "control_fp8")
    over = {k: ctl[k] for k in h.limits if ctl[k] > h.limits[k]}
    return over, ctl


@pytest.fixture(scope="module")
def cal():
    return load("portbench_calibrate_under_test", PORTBENCH / "calibrate.py")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_far_above_a_sound_run_tiny(cal, harness, cell):
    bench = cal.run.load_json(cal.run.ROOT / "BENCHMARK.json")
    a = argparse.Namespace(workload=cell, seed=11, seconds=0.0, trace=0)
    h = cal.run.Harness(a, bench, "cpu", TINY, TINY_TRAFFIC[CELLS[cell]])
    _, ctl = _control_fails(cal, h, 11)
    sound = tiny_run(harness, cell, seed=11)["checks"]
    assert any(ctl[name] > 100 * max(c["value"], 1e-4)
               for name, c in sound.items()), (ctl, sound)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2718281828, 3141592653, 1618033988])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct_on_card(cal, card, cell, seed):
    bench = cal.run.load_json(cal.run.ROOT / "BENCHMARK.json")
    a = argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0)
    h = cal.run.Harness(a, bench, str(card))
    over, ctl = _control_fails(cal, h, seed)
    assert over, ctl

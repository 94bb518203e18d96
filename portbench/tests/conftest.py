"""Shared fixtures of the benchmark's own tests: the harness module, a
tiny configuration, and the card (for the tests marked ``gpu``)."""

import importlib.util
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cell at a width the CPU runs in seconds, in float32 so that the
# program's sound runs read the reference to round-off
TINY = {"model.resolution": 16, "model.fmap_base": 64,
        "model.latent_dim": 16, "run.compute_dtype": "float32",
        "schedule.batch_schedule": {16: 4}}
TINY_TRAFFIC = {"train": {"batch": 4, "resolution": 16, "reference_rows": 3},
                "serve_export": {"batch": 4}}


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def harness():
    """``portbench/run.py`` as a module."""
    return load("portbench_run_under_test", PORTBENCH / "run.py")


@pytest.fixture(scope="session")
def bench(harness):
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_run(harness, cell: str, seed: int = 2147483999, seconds=0.2):
    """One run of ``cell`` on the CPU at the tiny size (the chip check
    skipped); returns the result."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    drv = harness.load_json(PORTBENCH / "traffic" / f"{w['traffic']}.json")
    return harness.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        device="cpu", overrides=TINY,
                        traffic_overrides=TINY_TRAFFIC[drv["driver"]])


@pytest.fixture
def card():
    """The CUDA device, decided here and not at import: skips without."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")

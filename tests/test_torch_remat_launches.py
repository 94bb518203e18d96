"""The launch counts ``chip_smoke.py`` derives per training step hold.

On the card every call of a kernel's autograd Function launches the
kernel once; on the CPU the same call runs the plain version. So counting
the plain versions' calls in one step of a small model on the CPU counts
the launches the same step makes on the card, recomputes of
``model.remat`` included. ``chip_smoke.step_launches`` must derive those
counts from the config alone, with and without remat, R1 on and off.
"""

import collections

import pytest
import torch

import chip_smoke
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.ops.kernels import adain, mbstd, pixelnorm, resample
from ganlab_tpu_torch.train import build_phases, create_train_state
from ganlab_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

PLAIN = {"pixelnorm": (pixelnorm, "pixel_norm_ref"),
         "adain": (adain, "adain_ref"),
         "upsample_blur_2x": (resample, "upsample_blur_2x_ref"),
         "blur_downsample_2x": (resample, "blur_downsample_2x_ref"),
         "minibatch_stddev": (mbstd, "minibatch_stddev_ref")}


@pytest.fixture
def counts(monkeypatch):
    seen = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        def counted(*a, _f=getattr(mod, attr), _n=name, **k):
            seen[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    return seen


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("r1", [False, True], ids=["r1_off", "r1_on"])
def test_step_launches_match_a_counted_step(counts, remat, r1):
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "model.remat": remat,
        "schedule.progressive": False, "schedule.batch_schedule": {32: 2}})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = create_train_state(cfg, seed=0, device="cpu")
    step = tsteps.build_train_step(cfg, phase, penalty_override=r1)
    counts.clear()
    step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    want = {n: sum(v.values()) for n, v in chip_smoke.step_launches(
        cfg.model, r1, batch=2).items()}
    assert dict(counts) == want

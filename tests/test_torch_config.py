"""The port's config copy equals the JAX package's, preset by preset."""

import dataclasses

import pytest

from ganlab_tpu import config as jax_config
from ganlab_tpu_torch import config as torch_config


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_presets_equal(preset):
    assert sorted(torch_config.PRESETS) == sorted(jax_config.PRESETS)
    assert dataclasses.asdict(torch_config.get_config(preset)) == \
        dataclasses.asdict(jax_config.get_config(preset))


def test_overrides_and_derived_values_equal():
    over = {"model.resolution": 64, "model.fmap_base": 1024,
            "loss.fused_g_step": True, "schedule.batch_schedule": {"64": 8}}
    t = torch_config.get_config("stylegan-256", **over)
    j = jax_config.get_config("stylegan-256", **over)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [t.model.nf(s) for s in range(1, 9)] == \
        [j.model.nf(s) for s in range(1, 9)]
    assert t.model.res_log2 == j.model.res_log2 == 6

"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program on the CPU at the tiny
size, with the rest of the run as on the card."""

import numpy as np
import pytest

from conftest import tiny_run


def _half_batch(monkeypatch):
    """The step leaves out the second half of its real rows; its means
    are taken over the rest."""
    from ganlab_tpu_torch.train import steps

    prep = steps._preprocess

    def half(real_u8, hflip, flip, dtype):
        n = real_u8.shape[0] // 2
        return prep(real_u8[:n], hflip, flip[:n], dtype)

    monkeypatch.setattr(steps, "_preprocess", half)


def _half_loss(monkeypatch):
    """Every row runs through D; every batch mean after the forward (the
    losses', R1's, the w-average's) is taken over the first half of the
    rows only."""
    from ganlab_tpu_torch.ops import losses as L
    from ganlab_tpu_torch.train import steps

    d_loss, g_loss = L.D_LOSSES["nonsaturating"], L.G_LOSSES["nonsaturating"]

    def half(s):
        return s[:s.shape[0] // 2]

    r1 = L.r1_penalty

    def r1_half(critic, real, gamma=10.0):
        return r1(critic, half(real), gamma)

    monkeypatch.setitem(L.D_LOSSES, "nonsaturating",
                        lambda r, f: d_loss(half(r), half(f)))
    monkeypatch.setitem(L.G_LOSSES, "nonsaturating",
                        lambda f: g_loss(half(f)))
    monkeypatch.setattr(L, "r1_penalty", r1_half)

    build = steps.build_generator_forward

    def build_half(cfg, res_log2):
        forward = build(cfg, res_log2)

        def half_w(g, dr, alpha, fade=None):
            fake, _ = forward(g, dr, alpha, fade)
            return fake, g.map_latents(half(dr.z1)).float().mean(dim=0)

        return half_w

    monkeypatch.setattr(steps, "build_generator_forward", build_half)


def _unchanged(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


@pytest.mark.parametrize("cell", ["sg256-train-b32", "sg1024-train-b32"])
@pytest.mark.parametrize("fault", [_half_batch, _half_loss, _unchanged],
                         ids=["half_batch", "half_loss", "state_unchanged"])
def test_training_fault_is_caught(harness, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = tiny_run(harness, cell)
    assert res["correct"] is False, res["checks"]


def _serve_fault(monkeypatch, alter):
    from ganlab_tpu_torch.export import ExportedSampler

    run = ExportedSampler._run

    def broken(self, z, noise_seed, psi):
        return alter(run(self, z, noise_seed, psi))

    monkeypatch.setattr(ExportedSampler, "_run", broken)


def _swap(out):
    out = out.copy()
    out[0] = out[1]
    return out


def _half(out):
    out = out.copy()
    out[out.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("alter", [_swap, _half],
                         ids=["answer_altered", "half_batch"])
def test_serving_fault_is_caught(harness, monkeypatch, alter):
    _serve_fault(monkeypatch, alter)
    res = tiny_run(harness, "sg1024-serve-b32")
    assert res["correct"] is False, res["checks"]
    assert np.isfinite(res["checks"]["image_gap"]["value"])

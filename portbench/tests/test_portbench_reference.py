"""The reference against the program on the CPU at a tiny width: every
cell's run is correct, and its gaps are round-off."""

import pytest

from conftest import ROOT, tiny_run

CELLS = ["sg256-train-b32", "sg1024-train-b32", "sg1024-serve-b32"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_matches_reference(harness, cell):
    res = tiny_run(harness, cell)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        # images: round-off moves a value across a uint8 level here and
        # there (0.0013 levels an image at this size)
        assert c["value"] <= (0.01 if name == "image_gap" else 1e-4), \
            (name, c)
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def test_parameter_specs_name_every_leaf():
    """The reference's parameter lists are the program's state dicts, name
    for name and shape for shape, at both configurations' widths."""
    import torch

    from ganlab_tpu_torch.config import get_config
    from ganlab_tpu_torch.models import build_models
    from portbench.reference import model as M

    for preset, res in (("stylegan-256", 256), ("stylegan-1024", 1024)):
        cfg = get_config(preset, **{"schedule.progressive": False})
        with torch.device("meta"):
            g, d = build_models(cfg.model)
        c = __import__("json").load(open(ROOT / "portbench" / "configs"
                                          / f"{preset}.json"))
        for spec, net in ((M.g_spec(c["model"]), g), (M.d_spec(c["model"]), d)):
            want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
            got = {n: tuple(s) for n, s, _, _ in spec}
            assert got == want


def test_blocked_discriminator_is_exact():
    """The reference's D in blocks of rows (R1's double backward put back
    together) gives the whole batch's gradients."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import train as T

    m = {"resolution": 16, "img_channels": 3, "latent_dim": 8,
         "fmap_base": 32, "fmap_max": 16, "fmap_min": 1, "mapping_layers": 2,
         "mapping_lr_mult": 0.01, "style_mixing_prob": 0.9,
         "w_avg_beta": 0.995}
    P_g = M.make_params(M.g_spec(m), 1, "cpu")
    P_d = M.make_params(M.d_spec(m), 2, "cpu")
    gen = torch.Generator().manual_seed(3)
    dr = T.draw_step(m, 5, gen, "cpu", torch.float32)
    real = torch.rand(5, 3, 16, 16, dtype=torch.float64).float() * 2 - 1
    whole = T._d_update(P_g, P_d, m, real, dr, 160.0, 5, M.F32)
    parts = T._d_update(P_g, P_d, m, real, dr, 160.0, 2, M.F32)
    for k, v in whole[0].items():
        if v is None:
            assert parts[0][k] is None
            continue
        torch.testing.assert_close(parts[0][k], v, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(parts[2], whole[2], rtol=1e-5, atol=0)

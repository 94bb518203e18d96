"""The port's StyleGAN2 against the benchmark's plain float32 reference
(``portbench/reference/stylegan2.py``, ``train_sg2.py``), on the CPU.

At a tiny ``stylegan2-256`` (16x16, ``fmap_base`` 64, latent 16, batch 4,
float32) on seeded random weights, named as the program's state dicts
name them (``stylegan2.g_spec`` / ``d_spec``): the modulated conv
(activation-side in the port) against the weight-side grouped form; the
skip generator with explicit noise; the residual discriminator's scores;
the path-length penalty, its lengths and the running mean; every G and D
leaf's gradient of an R1 + path-length step (the mapping's included, and
nonzero); and one whole R1 + path-length step and one path-length-only
step of ``build_train_step`` (parameters, G-EMA, w-average, running mean,
metrics). The draws come from one seed on both sides, in the program's
order. Tolerance: 1e-4 relative to the reference's norm, float32
round-off between two summation orders (the weight-side against the
activation-side modulation, blocks of rows against the whole batch).
"""

import dataclasses
import math

import pytest
import torch

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.ops.modulated import modulated_conv2d
from ganlab_tpu_torch.train import build_phases
from ganlab_tpu_torch.train.state import TrainState, make_optimizers
from ganlab_tpu_torch.train.steps import (
    PLDraws,
    build_train_step,
    path_length_penalty,
)
from portbench.reference import model as M
from portbench.reference import stylegan2 as S2
from portbench.reference import train as T
from portbench.reference import train_sg2 as R

torch.set_num_threads(1)

B = 4
OVER = {"model.resolution": 16, "model.fmap_base": 64,
        "model.latent_dim": 16, "run.compute_dtype": "float32",
        "schedule.batch_schedule": {16: B}}
# float32 round-off between two summation orders, relative to the
# reference's norm
TOL = 1e-4


def config():
    return get_config("stylegan2-256", **OVER)


def ref_config(cfg) -> dict:
    """The configuration as the reference reads it (a configuration
    file's sections)."""
    return {sec: dataclasses.asdict(getattr(cfg, sec))
            for sec in ("model", "loss", "optim", "data", "run")}


def rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def assert_rel(got, want, what=""):
    assert got.shape == want.shape, what
    err = rel(got, want)
    assert err <= TOL, (what, err)


@pytest.fixture(scope="module")
def params():
    m = ref_config(config())["model"]
    return (M.make_params(S2.g_spec(m), 1, "cpu"),
            M.make_params(S2.d_spec(m), 2, "cpu"))


def nets(cfg, P_g, P_d):
    """The program's G and D holding the reference's parameters."""
    with torch.device("meta"):
        g, d = build_models(cfg.model)
    g, d = g.to_empty(device="cpu"), d.to_empty(device="cpu")
    g.load_state_dict(P_g, strict=True)
    d.load_state_dict(P_d, strict=True)
    return g, d


def randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name,res,demod", [
    ("synthesis.conv4", 4, True), ("synthesis.block16.conv0", 16, True),
    ("synthesis.torgb16.conv", 16, False)])
def test_modulated_conv_matches_the_weight_side_form(params, name, res,
                                                     demod):
    cfg = config()
    g, _ = nets(cfg, *params)
    layer = g.get_submodule(name)
    assert layer.demodulate == demod
    x = randn(B, layer.w.shape[1], res, res, seed=1)
    w = randn(B, cfg.model.latent_dim, seed=2)
    with torch.no_grad():
        got = modulated_conv2d(x, layer.w, layer.affine(w),
                               demodulate=demod, gain=layer.gain)
        want = S2.modulated_conv(params[0], name, x, w, demodulate=demod,
                                 gain=layer.gain)
    assert_rel(got, want, name)


def test_skip_generator_with_explicit_noise(params):
    cfg = config()
    g, _ = nets(cfg, *params)
    m = ref_config(cfg)["model"]
    ws = randn(B, S2.num_style_layers(m), cfg.model.latent_dim, seed=3)
    noises = [randn(B, 1, h, w, seed=10 + i)
              for i, (h, w) in enumerate(S2.noise_shapes(m))]
    with torch.no_grad():
        got = g.synthesize(ws, noises=noises)
        want = S2.synthesis(params[0], m, ws, noises)
    assert got.shape == (B, 3, 16, 16)
    assert_rel(got, want)


def test_residual_discriminator_scores(params):
    cfg = config()
    _, d = nets(cfg, *params)
    m = ref_config(cfg)["model"]
    img = randn(B, 3, 16, 16, seed=4)
    with torch.no_grad():
        got = d(img)
        want = S2.d_head(params[1], S2.d_trunk(params[1], m, img))
    assert_rel(got, want)


def test_path_length_penalty_lengths_and_mean(params):
    cfg = config()
    g, _ = nets(cfg, *params)
    m = ref_config(cfg)["model"]
    nb = B // cfg.loss.pl_batch_shrink
    dr = PLDraws(randn(nb, cfg.model.latent_dim, seed=5),
                 [randn(nb, 1, h, w, seed=20 + i)
                  for i, (h, w) in enumerate(S2.noise_shapes(m))],
                 randn(nb, 3, 16, 16, seed=6) / 16)
    mean0 = torch.tensor(0.3)
    pen, new_mean, lens = path_length_penalty(
        g, mean0, dr, 4, 1.0, weight=8.0, decay=0.01)
    r_pen, r_mean, r_lens = R.path_length(
        params[0], m, R.PLDraws(dr.z, dr.noises, dr.y), mean0, 8.0, 0.01,
        1, M.F32, grad=False)
    assert_rel(lens.detach(), r_lens, "lengths")
    assert_rel(new_mean, r_mean, "pl_mean")
    assert_rel(pen.detach(), r_pen, "penalty")
    assert float(r_pen) > 0 and float(r_mean) != 0.3


def program_state(cfg, P_g, P_d, seed, pl_mean):
    g, d = nets(cfg, P_g, P_d)
    opt_g, opt_d = make_optimizers(cfg, g, d)
    return TrainState(
        g=g, d=d, g_ema=nets(cfg, P_g, P_d)[0].requires_grad_(False),
        opt_g=opt_g, opt_d=opt_d, w_avg=torch.zeros(cfg.model.latent_dim),
        generator=torch.Generator().manual_seed(seed),
        pl_mean=torch.tensor(pl_mean))


def ref_state(c, P_g, P_d, seed, pl_mean):
    hp_g, hp_d = R.hparams(c)
    return R.State({n: t.clone() for n, t in P_g.items()},
                   {n: t.clone() for n, t in P_d.items()},
                   T.Adam(*hp_g), T.Adam(*hp_d),
                   torch.Generator().manual_seed(seed),
                   ema={n: t.clone() for n, t in P_g.items()},
                   w_avg=torch.zeros(c["model"]["latent_dim"]),
                   pl_mean=torch.tensor(pl_mean))


def grads_at_adam(state):
    """Each leaf's gradient as the step hands it to Adam."""
    out = {}

    def hook(net, module):
        def read(opt, args, kwargs):
            out[net] = {n: p.grad.clone() for n, p in
                        module.named_parameters() if p.grad is not None}
        return read

    state.opt_d.register_step_pre_hook(hook("d", state.d))
    state.opt_g.register_step_pre_hook(hook("g", state.g))
    return out


def test_r1_pl_step_gradients_of_every_leaf(params):
    cfg = config()
    c = ref_config(cfg)
    phase = build_phases(cfg.schedule, cfg.model)[0]
    real = torch.randint(0, 256, (B, 16, 16, 3),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.uint8)
    st = program_state(cfg, *params, seed=8, pl_mean=0.0)
    got = grads_at_adam(st)
    step = build_train_step(cfg, phase, penalty_override=True,
                            pl_override=True)
    step(st, real)
    _, (gd, gg, _) = R.step(c, ref_state(c, *params, 8, 0.0), real, 0,
                            "cpu", 3, M.F32)
    for net, want in (("d", gd), ("g", gg)):
        # the lower resolutions' fromRGB take no gradient on either side
        want = {n: v for n, v in want.items() if v is not None}
        assert set(got[net]) == set(want), net
        for n, v in want.items():
            assert_rel(got[net][n], v, f"{net}.{n}")
    for n in ("mapping.fc0.w", "mapping.fc0.b", "mapping.fc7.w"):
        assert float(gg[n].abs().max()) > 0, n


@pytest.mark.parametrize("index,r1", [(0, True), (4, False)],
                         ids=["r1_pl", "pl_only"])
def test_whole_step(params, index, r1):
    """One step of ``build_train_step`` (R1 and path length, or path
    length alone) against the reference's step ``index`` of a cycle."""
    cfg = config()
    c = ref_config(cfg)
    phase = build_phases(cfg.schedule, cfg.model)[0]
    real = torch.randint(0, 256, (B, 16, 16, 3),
                         generator=torch.Generator().manual_seed(9),
                         dtype=torch.uint8)
    st = program_state(cfg, *params, seed=10, pl_mean=0.25)
    step = build_train_step(cfg, phase, penalty_override=r1,
                            pl_override=True)
    assert step.pl_weight == 8.0 and step.pen_weight == (160.0 if r1
                                                         else 0.0)
    _, metrics = step(st, real)
    ref = ref_state(c, *params, 10, 0.25)
    row, _ = R.step(c, ref, real, index, "cpu", 3, M.F32)
    for key in ("d_loss", "g_loss", "pl_penalty", "real_score",
                "fake_score") + (("penalty",) if r1 else ()):
        assert math.isclose(float(metrics[key]), row[key], rel_tol=TOL), key
    assert row["pl_penalty"] > 0 and (row["penalty"] > 0) == r1
    assert_rel(st.pl_mean, ref.pl_mean, "pl_mean")
    assert_rel(st.w_avg, ref.w_avg, "w_avg")
    for name, net, want, start in (
            ("g", st.g, ref.Pg, params[0]), ("d", st.d, ref.Pd, params[1]),
            ("g_ema", st.g_ema, ref.ema, params[0])):
        for n, p in net.named_parameters():
            assert_rel(p.detach() - start[n], want[n] - start[n],
                       f"{name}.{n}")

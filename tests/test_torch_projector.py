"""The port's projector (``ganlab_tpu_torch/utils/projector.py``) and ``cli
project`` against the JAX package's ``ganlab_tpu/utils/projector.py``.

Held to the JAX functions: ``pyramid_loss``, ``noise_regularizer`` and
``_normalize_noises`` (1e-6 relative; NCHW here, NHWC there) and the LR
schedule (1e-6 relative at every step). A short projection (four steps,
two targets, two restarts from a pool of six) leaf by leaf against the JAX
``project``: ResNet-GAN in z, StyleGAN in W+ with ``optimize_noise`` and
in W without it. The port is fed the JAX run's own ``jax.random`` draws,
computed here from its keys: the pool's z, each step's exploration noise,
the initial noise maps, and the synthesis noise the JAX model draws from
its one ``noise_key`` (read through a flax method interceptor and checked
to reproduce the model's own images). Latents, images, noise maps and the
loss trajectory within 1e-4 of their scale (float32, Adam's first moves
are about lr x sign(g)).

The rest mirrors ``tests/test_projector.py``: a StyleGAN target recovered,
shared W broadcast to every layer, z space, ``load_image``, and ``cli
project`` writing ``pairs.png``, ``latents.npy``, ``noises.npz`` and its
loss line. The JAX side runs at ``highest`` matmul precision
(``tests/conftest.py``).
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.layers import NoiseInjection
from ganlab_tpu.utils import projector as JP
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_generator, noise_shapes
from ganlab_tpu_torch.models.stylegan import num_style_layers
from ganlab_tpu_torch.utils import projector as TP
from tests.test_torch_train_step import perturb

torch.set_num_threads(1)

TINY_STYLE = {"model.resolution": 16, "model.fmap_base": 128,
              "model.fmap_max": 32, "model.latent_dim": 16,
              "model.mapping_layers": 2, "run.compute_dtype": "float32"}
TINY_RESNET = {"model.resolution": 16, "model.latent_dim": 8,
               "model.base_channels": 8, "run.compute_dtype": "float32"}
SHORT = dict(num_steps=4, num_restarts=2, num_candidates=6, seed=3)
REL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().cpu().numpy().transpose(0, 2, 3, 1)


def _close(got, want, what, rel=REL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 32, 32, 3),
                                   (2, 6, 6, 3), (1, 12, 12, 3)])
def test_pyramid_loss_matches_jax(shape):
    rs = np.random.RandomState(0)
    a, b = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    want = float(JP.pyramid_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(TP.pyramid_loss(_nchw(a), _nchw(b)))
    assert got == pytest.approx(want, rel=1e-6)


def test_pyramid_loss_zero_on_identical():
    img = torch.full((1, 3, 16, 16), 0.3)
    assert float(TP.pyramid_loss(img, img)) == 0.0
    assert float(TP.pyramid_loss(img, -img)) > 0.0


def test_noise_regularizer_and_normalization_match_jax():
    rs = np.random.RandomState(1)
    maps = [rs.randn(2, s, s, 1).astype(np.float32) for s in (4, 8, 16, 32)]
    smooth = np.tile(np.linspace(-1, 1, 16, dtype=np.float32)[None, None,
                                                              :, None],
                     (2, 16, 1, 1))
    for group in (maps, [smooth], maps[2:]):
        want = float(JP.noise_regularizer([jnp.asarray(m) for m in group]))
        got = float(TP.noise_regularizer([_nchw(m) for m in group]))
        assert got == pytest.approx(want, rel=1e-5)
    want = JP._normalize_noises([jnp.asarray(m * 3 + 1) for m in maps])
    got = TP._normalize_noises([_nchw(m * 3 + 1) for m in maps])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert float(TP.noise_regularizer([])) == 0.0


@pytest.mark.parametrize("num_steps", [300, 7])
def test_lr_schedule_matches_jax(num_steps):
    want = jax.vmap(JP._lr_schedule(0.1, num_steps))(jnp.arange(num_steps))
    got = [TP._lr_schedule(0.1, num_steps)(t) for t in range(num_steps)]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-9)
    assert got[0] == 0.0 and max(got) == pytest.approx(0.1, rel=1e-6)


def test_load_image_matches_jax(tmp_path):
    from PIL import Image

    png = str(tmp_path / "t.png")
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (20, 24, 3), np.uint8)).save(png)
    got = TP.load_image(png, 16)
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JP.load_image(png, 16))


# -- a short projection against the JAX package -------------------------------

def _drawn_noises(jg, params, n, lg, dim, noise_key):
    """The noise maps the JAX synthesis draws from ``noise_key`` at batch
    ``n`` (NHWC, in layer order): NoiseInjection's own draw, made by an
    interceptor and passed back in explicitly."""
    seen = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, NoiseInjection) and \
                context.method_name == "__call__" and \
                kwargs.get("noise") is None:
            x = args[0]
            noise = jax.random.normal(context.module.make_rng("noise"),
                                      (*x.shape[:3], 1), x.dtype)
            seen.append(np.asarray(noise))
            return next_fun(x, noise=noise)
        return next_fun(*args, **kwargs)

    ws = jax.random.normal(jax.random.PRNGKey(99),
                           (n, num_style_layers(lg), dim))
    with nn.intercept_methods(intercept):
        a = jg.apply(params, ws, lg, 1.0, method="synthesize",
                     rngs={"noise": noise_key})
    b = jg.apply(params, ws, lg, 1.0, [jnp.asarray(s) for s in seen],
                 method="synthesize")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return seen


def _jax_draws(jcfg, jg, params, batch, *, num_steps, num_restarts,
               num_candidates, seed, w_plus=True, optimize_noise=False):
    """The port's ``ProjectionDraws`` of the JAX ``project``'s own keys
    (``ganlab_tpu/utils/projector.py:174-245``)."""
    style = hasattr(jg, "map_latents")
    lg, dim = jcfg.model.res_log2, jcfg.model.latent_dim
    n_r, n_c = num_restarts, max(num_candidates, num_restarts)
    n = n_r * batch
    noise_key, stat_key, opt_key = jax.random.split(
        jax.random.PRNGKey(seed), 3)
    lat = ((num_style_layers(lg) if w_plus else 1, dim) if style else (dim,))
    step_noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(opt_key, t), (n, *lat))) for t in range(num_steps)])
    if not style:
        return TP.ProjectionDraws(
            pool_z=torch.from_numpy(np.array(jax.random.normal(
                stat_key, (n_c - 1, dim)))),
            step_noise=torch.from_numpy(step_noise))
    shapes = noise_shapes(get_config("stylegan-256", **TINY_STYLE).model, lg)
    return TP.ProjectionDraws(
        pool_z=torch.from_numpy(np.array(jax.random.normal(
            stat_key, (max(256, n_c - 1), dim)))),
        step_noise=torch.from_numpy(step_noise),
        pool_noises=[_nchw(m) for m in _drawn_noises(
            jg, params, n_c, lg, dim, noise_key)],
        noises=[_nchw(m) for m in _drawn_noises(
            jg, params, n, lg, dim, noise_key)],
        init_noises=[_nchw(jax.random.normal(
            jax.random.fold_in(noise_key, li), (n, h, w, 1)))
            for li, (h, w) in enumerate(shapes)] if optimize_noise else [])


def _world(preset, over, seed=0, scale=0.2):
    """The JAX G's initial parameters (perturbed by ``scale``, so that the
    noise strengths are live) in both packages."""
    jcfg = jax_get_config(preset, **over)
    jg, _ = jax_build_models(jcfg.model)
    params = jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(seed)))
    if scale:
        params = perturb(params, seed + 1, scale=scale)
    cfg = get_config(preset, **over)
    g = build_generator(cfg.model)
    g.load_state_dict(from_flax(params))
    g.requires_grad_(False)
    return jcfg, jg, params, cfg, g


def _compare(jres, tres, what):
    assert tres.is_w_space == bool(jres.is_w_space)
    _close(tres.latents.numpy(), jres.latents, f"{what} latents")
    _close(_nhwc(tres.images), jres.images, f"{what} images")
    _close(tres.losses.numpy(), jres.losses, f"{what} losses")
    assert tres.latents.shape == np.shape(jres.latents)
    if jres.noises is None:
        assert tres.noises is None
    else:
        assert len(tres.noises) == len(jres.noises)
        for i, (t, j) in enumerate(zip(tres.noises, jres.noises)):
            _close(_nhwc(t), j, f"{what} noise {i}")


def test_project_z_space_resnetgan_matches_jax():
    jcfg, jg, params, cfg, g = _world("resnetgan-cifar10", TINY_RESNET)
    z = np.random.RandomState(5).randn(2, 8).astype(np.float32)
    target = np.asarray(jg.apply(params, jnp.asarray(z)), np.float32) * 0.9
    jres = JP.project(jcfg, params, jnp.zeros((8,)), target, lr=0.05,
                      **SHORT)
    draws = _jax_draws(jcfg, jg, params, 2, **{
        k: v for k, v in SHORT.items()})
    tres = TP.project(cfg, g, torch.zeros(8), _nchw(target), lr=0.05,
                      draws=draws, **SHORT)
    _compare(jres, tres, "resnetgan z")
    assert tres.latents.shape == (2, 8) and not tres.is_w_space


@pytest.mark.parametrize("w_plus,optimize_noise", [(True, True),
                                                   (False, False)],
                         ids=["w_plus_noise", "w_shared"])
def test_project_stylegan_matches_jax(w_plus, optimize_noise):
    jcfg, jg, params, cfg, g = _world("stylegan-256", TINY_STYLE)
    lg, nl = 4, num_style_layers(4)
    rs = np.random.RandomState(7)
    target = np.asarray(jg.apply(
        params, jnp.asarray(rs.randn(2, nl, 16).astype(np.float32)), lg,
        1.0, method="synthesize", rngs={"noise": jax.random.PRNGKey(4)}),
        np.float32)
    w_avg = rs.randn(16).astype(np.float32) * 0.1
    kw = dict(SHORT, w_plus=w_plus, optimize_noise=optimize_noise)
    jres = JP.project(jcfg, params, jnp.asarray(w_avg), target, **kw)
    draws = _jax_draws(jcfg, jg, params, 2, **kw)
    tres = TP.project(cfg, g, torch.from_numpy(w_avg), _nchw(target),
                      draws=draws, **kw)
    _compare(jres, tres, f"stylegan w_plus={w_plus}")
    assert tres.latents.shape == (2, nl, 16)
    # step 0's learning rate is 0: the first update moves nothing
    again = TP.project(cfg, g, torch.from_numpy(w_avg), _nchw(target),
                       draws=draws, **dict(kw, num_steps=1))
    assert float(again.losses[0]) == float(tres.losses[0])


def test_project_draws_its_own_from_seed():
    _, _, _, cfg, g = _world("stylegan-256", TINY_STYLE)
    target = torch.rand(1, 3, 16, 16) * 2 - 1
    kw = dict(num_steps=3, num_restarts=2, num_candidates=4,
              optimize_noise=True)
    a = TP.project(cfg, g, torch.zeros(16), target, seed=1, **kw)
    b = TP.project(cfg, g, torch.zeros(16), target, seed=1, **kw)
    c = TP.project(cfg, g, torch.zeros(16), target, seed=2, **kw)
    assert torch.equal(a.latents, b.latents)
    assert not torch.equal(a.latents, c.latents)
    assert [n.shape for n in a.noises] == [
        (1, 1, h, w) for h, w in noise_shapes(cfg.model, 4)]
    assert all(p.grad is None for p in g.parameters())


# -- the port alone (tests/test_projector.py; the JAX initial G) --------------

def _style_target(cfg, g, batch=2, seed=7):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w = g.map_latents(torch.randn(batch, cfg.model.latent_dim,
                                      generator=gen))
        ws = w[:, None].repeat(1, num_style_layers(cfg.model.res_log2), 1)
        return g.synthesize(ws, cfg.model.res_log2, 1.0,
                            generator=torch.Generator().manual_seed(0))


def test_project_recovers_stylegan_image():
    """The JAX test's instance (its target and, injected, its seed-0
    draws): the port reaches its MSE bound too. With the port's own draws
    the loss still falls five-fold; the final MSE then depends on the pool
    drawn."""
    from tests.test_projector import _style_target as jax_style_target

    jcfg, jg, params, cfg, g = _world("stylegan-256", TINY_STYLE, scale=0)
    target = _nchw(jax_style_target(jcfg, params))
    draws = _jax_draws(jcfg, jg, params, 2, num_steps=200, num_restarts=8,
                       num_candidates=64, seed=0)
    res = TP.project(cfg, g, torch.zeros(16), target, num_steps=200,
                     draws=draws)
    assert res.losses.shape == (200,) and res.is_w_space
    assert res.latents.shape == (2, num_style_layers(4), 16)
    assert float(res.losses[-1]) < 0.2 * float(res.losses[0])
    assert float((res.images - target).square().mean()) < 0.05
    own = TP.project(cfg, g, torch.zeros(16), _style_target(cfg, g),
                     num_steps=200, seed=0)
    assert float(own.losses[-1]) < 0.2 * float(own.losses[0])


def test_project_shared_w_and_stylegan2():
    _, _, _, cfg, g = _world("stylegan2-256", TINY_STYLE, seed=1, scale=0)
    res = TP.project(cfg, g, torch.zeros(16), _style_target(cfg, g, 1, 3),
                     num_steps=60, w_plus=False, seed=0)
    nl = num_style_layers(4)
    assert res.latents.shape == (1, nl, 16)
    assert torch.equal(res.latents[:, 0:1].expand(-1, nl, -1), res.latents)
    assert float(res.losses[-1]) < float(res.losses[0])


def test_project_z_space_resnetgan():
    _, _, _, cfg, g = _world("resnetgan-cifar10", TINY_RESNET, scale=0)
    with torch.no_grad():
        target = g(torch.randn(2, 8, generator=torch.Generator()
                               .manual_seed(5)))
    res = TP.project(cfg, g, torch.zeros(8), target, num_steps=150, lr=0.05,
                     seed=0)
    assert not res.is_w_space and res.latents.shape == (2, 8)
    assert float(res.losses[-1]) < 0.2 * float(res.losses[0])


@pytest.mark.parametrize("noise", [False, True], ids=["w_plus", "noise"])
def test_cli_project(tmp_path, capsys, noise):
    """``cli project`` on a fresh workdir (with the warning) writes the
    JAX CLI's outputs: pairs.png, latents.npy, noises.npz (NHWC maps) with
    ``--optimize-noise``, and the loss line."""
    from PIL import Image

    png = str(tmp_path / "target.png")
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (20, 24, 3), np.uint8)).save(png)
    out = tmp_path / "proj"
    args = ["project", "--preset", "stylegan-256", "--device", "cpu",
            "--workdir", str(tmp_path / "run"), "--images", png, png,
            "--steps", "6", "--out", str(out)]
    for k, v in TINY_STYLE.items():
        args += ["--set", f"{k}={v}"]
    if noise:
        args.append("--optimize-noise")
    assert cli.main(args) == 0
    text = capsys.readouterr().out
    assert "WARNING: no checkpoint found" in text
    assert "projection:" in text and "(W space; loss " in text
    grid = np.asarray(Image.open(out / "pairs.png"))
    assert grid.shape == (2 * 16 + 2, 2 * 16 + 2, 3)
    assert np.load(out / "latents.npy").shape == (2, num_style_layers(4), 16)
    if noise:
        saved = np.load(out / "noises.npz")
        cfg = get_config("stylegan-256", **TINY_STYLE)
        assert [saved[f"noise{i}"].shape for i in range(len(saved.files))] \
            == [(2, h, w, 1) for h, w in noise_shapes(cfg.model, 4)]
    else:
        assert not os.path.exists(out / "noises.npz")

"""The port's LPIPS (``eval/lpips.py``) and PPL (``eval/ppl.py``) vs the
JAX package's, and ``cli eval-ppl`` / ``eval-fid --metrics ppl``.

* The random VGG16 of both packages from one seed (bit for bit), the
  torchvision state-dict loader on a file the test writes, and the
  distance at 32x32 and, through the bilinear resize to 32, at 8x8 and
  16x16 (``F.interpolate`` against ``jax.image.resize`` on its own too),
  within 1e-5 relative.
* PPL's pair images: z, t and the noise maps injected into both packages
  (the JAX side is ``compute_ppl``'s ``pair_batch`` assembled from
  ``map_latents`` / ``synthesize``, ``lerp`` and ``slerp`` with explicit
  noise), for a small StyleGAN in w and z space and a small ProGAN in z
  space, sampling ``full`` and ``end``: within 1e-5.
* The whole ``compute_ppl`` (batches, epsilon scaling, the 1% / 99%
  filter) against the JAX function, the port fed the draws the JAX
  function makes from its key, with a plain squared-difference distance.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.eval import lpips as jax_lpips
from ganlab_tpu.eval.ppl import compute_ppl as jax_compute_ppl
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.utils.latents import lerp as jax_lerp
from ganlab_tpu.utils.latents import slerp as jax_slerp
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.eval import lpips
from ganlab_tpu_torch.eval.ppl import compute_ppl, ppl_pairs
from ganlab_tpu_torch.models import build_generator
from ganlab_tpu_torch.models.stylegan import noise_shapes
from tests.test_torch_progan_g import _nchw, _nhwc
from tests.test_torch_train_step import perturb

torch.set_num_threads(1)

STYLE = {"model.resolution": 16, "model.fmap_base": 64,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}
PROGAN = {"model.resolution": 16, "model.fmap_base": 64,
          "model.latent_dim": 16, "run.compute_dtype": "float32"}


@pytest.fixture(scope="module")
def vgg():
    jp = jax_lpips._random_vgg_params(seed=3)
    tp = lpips.random_vgg_params(seed=3)
    return jp, tp


def test_random_vgg_is_the_jax_one(vgg):
    jp, tp = vgg
    assert set(jp) == set(tp) and len(tp) == 26
    for k, v in jp.items():
        want = np.asarray(v)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(tp[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("res", [32, 8, 16])
def test_lpips_matches_jax(vgg, res):
    jp, tp = vgg
    rng = np.random.default_rng(res)
    x = rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    want = np.asarray(jax_lpips.lpips_distance(jp, jnp.asarray(x),
                                               jnp.asarray(y)))
    got = lpips.lpips_distance(tp, _nchw(x), _nchw(y)).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    same = lpips.lpips_distance(tp, _nchw(x), _nchw(x)).numpy()
    np.testing.assert_array_equal(same, np.zeros(2))


@pytest.mark.parametrize("res", [8, 16])
def test_bilinear_resize_matches_jax(res):
    x = np.random.default_rng(1).normal(size=(2, res, res, 3)) \
        .astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), "bilinear")
    got = F.interpolate(_nchw(x), size=(32, 32), mode="bilinear",
                        align_corners=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_vgg16_loader(tmp_path, monkeypatch):
    """A torchvision-layout state dict (``features.N.weight``) loads into
    both packages alike, by argument and through the environment."""
    gen = torch.Generator().manual_seed(0)
    sd, cin, i = {}, 3, 0
    for v in lpips._VGG_CFG:
        if v == "M":
            continue
        ti = lpips._TORCH_IDX[i]
        sd[f"features.{ti}.weight"] = 0.1 * torch.randn(v, cin, 3, 3,
                                                        generator=gen)
        sd[f"features.{ti}.bias"] = 0.1 * torch.randn(v, generator=gen)
        cin, i = v, i + 1
    sd["classifier.0.weight"] = torch.zeros(4, 4)   # ignored
    path = str(tmp_path / "vgg16.pt")
    torch.save(sd, path)
    tp = lpips.load_torch_vgg16(path)
    jp = jax_lpips.load_torch_vgg16(path)
    for k, v in jp.items():
        want = np.asarray(v)
        np.testing.assert_array_equal(
            tp[k].numpy(), want.transpose(3, 2, 0, 1) if want.ndim == 4
            else want, err_msg=k)
    d = lpips.LPIPSDistance(path, device="cpu")
    assert d.pretrained and d.name == "lpips_vgg16"
    monkeypatch.setenv(lpips.LPIPS_WEIGHTS_ENV, path)
    assert lpips.LPIPSDistance(device="cpu").pretrained
    monkeypatch.setenv(lpips.LPIPS_WEIGHTS_ENV, str(tmp_path / "missing"))
    assert lpips.LPIPSDistance(device="cpu").name == "lpips_vgg16_random"
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    jd = jax_lpips.LPIPSDistance(path)
    np.testing.assert_allclose(d(x, -x), jd(_nhwc(x), _nhwc(-x)),
                               rtol=1e-5)


# -- PPL -------------------------------------------------------------------

def _pair(preset, over, seed):
    jcfg = jax_get_config(preset, **over)
    jg, _ = jax_build_models(jcfg.model)
    params = perturb(jax.tree_util.tree_map(
        np.asarray, jg.init_all(jax.random.PRNGKey(seed))), seed + 1, 0.2)
    g = build_generator(get_config(preset, **over).model)
    g.load_state_dict(from_flax(params))
    return jcfg, jg, params, g.eval().requires_grad_(False)


def _jax_pairs(jg, params, z, t, eps, space, lg, noises, style):
    """``ganlab_tpu/eval/ppl.py::compute_ppl``'s pair_batch with the
    draws given and explicit noise."""
    batch, dim = z.shape[1], z.shape[2]
    eps = jnp.float32(eps)
    if space == "w":
        w = jg.apply(params, z.reshape(2 * batch, dim),
                     method="map_latents").astype(jnp.float32)
        w = w.reshape(2, batch, -1)
        lat0, lat1 = jax_lerp(w[0], w[1], t), jax_lerp(w[0], w[1], t + eps)
    else:
        lat0 = jax_slerp(z[0], z[1], t)
        lat1 = jax_slerp(z[0], z[1], t + eps)
        if style:
            ww = jg.apply(params, jnp.concatenate([lat0, lat1], 0),
                          method="map_latents")
            lat0, lat1 = jnp.split(ww.astype(jnp.float32), 2, 0)

    def synth(lat):
        if not style:
            return jg.apply(params, lat, lg, 1.0)
        ws = jnp.broadcast_to(lat[:, None, :],
                              (lat.shape[0], 2 * (lg - 1), lat.shape[-1]))
        return jg.apply(params, ws, lg, 1.0, noises, method="synthesize")

    return synth(lat0), synth(lat1)


@pytest.mark.parametrize("family,space,sampling", [
    ("stylegan", "w", "full"), ("stylegan", "z", "full"),
    ("stylegan", "w", "end"), ("progan", "z", "full"),
    ("progan", "z", "end")])
def test_ppl_pairs_match_jax(family, space, sampling):
    preset = "stylegan-256" if family == "stylegan" else "progan-128"
    over = STYLE if family == "stylegan" else PROGAN
    _, jg, params, g = _pair(preset, over, 0)
    rs = np.random.RandomState(1)
    b, lg, eps = 3, 4, 1e-2
    z = rs.randn(2, b, 16).astype(np.float32)
    t = (rs.rand(b, 1) if sampling == "full" else np.zeros((b, 1))) \
        .astype(np.float32)
    noises = [rs.randn(b, h, w, 1).astype(np.float32)
              for h, w in noise_shapes(lg)]
    style = family == "stylegan"
    want = _jax_pairs(jg, params, jnp.asarray(z), jnp.asarray(t), eps,
                      space, lg, [jnp.asarray(n) for n in noises], style)
    got = ppl_pairs(get_config(preset, **over), g, torch.from_numpy(z),
                    torch.from_numpy(t), eps, space, lg,
                    [_nchw(n) for n in noises] if style else None)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(a), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert not np.array_equal(_nhwc(got[0]), _nhwc(got[1]))


def test_compute_ppl_matches_jax():
    """The whole metric over 3 batches of 8 on a small ProGAN, the port
    given the z and t that the JAX function draws from its key."""
    jcfg, jg, params, g = _pair("progan-128", PROGAN, 4)
    num, batch, eps, seed = 24, 8, 1e-1, 5
    draws, key = [], jax.random.PRNGKey(seed)
    for _ in range(num // batch):
        key, k = jax.random.split(key)
        kz, kt, _ = jax.random.split(k, 3)
        draws.append((torch.from_numpy(np.array(
            jax.random.normal(kz, (2, batch, 16)))), torch.from_numpy(
            np.array(jax.random.uniform(kt, (batch, 1)))), None))

    class JaxDist:
        pretrained = True

        def __call__(self, x, y):
            return np.square(np.asarray(x) - np.asarray(y)).mean((1, 2, 3))

    def port_dist(x, y):
        return (x - y).square().mean(dim=(1, 2, 3)).numpy()

    want = jax_compute_ppl(jcfg, params, num_samples=num, epsilon=eps,
                           batch=batch, seed=seed, distance=JaxDist())
    got = compute_ppl(get_config("progan-128", **PROGAN), g,
                      num_samples=num, epsilon=eps, batch=batch,
                      distance=port_dist, draws=draws)
    assert got["space"] == want["space"] == "z"
    assert got["num"] == want["num"] == num
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-4)
    with pytest.raises(ValueError, match="style"):
        compute_ppl(get_config("progan-128", **PROGAN), g, space="w",
                    distance=port_dist)


@pytest.fixture(scope="module")
def progan_workdir(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("ppl_run"))
    args = ["train", "--preset", "progan-128", "--device", "cpu",
            "--workdir", wd, "--max-steps", "1"]
    for k, v in dict(PROGAN, **{"data.dataset": "synthetic",
                                "schedule.batch_schedule": {4: 4}}).items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    return wd


def test_cli_eval_ppl(progan_workdir, capsys):
    """``eval-ppl`` and ``eval-fid --metrics ppl`` on a tiny ProGAN run (16x16
    images: LPIPS resizes them to 32), on the random VGG16; ``mixgrid``
    refuses a family without styles, as the JAX CLI does."""
    wd = progan_workdir
    assert cli.main(["eval-ppl", "--workdir", wd, "--device", "cpu",
                     "--num-samples", "8", "--space", "z",
                     "--sampling", "end"]) == 0
    out = capsys.readouterr().out
    assert "PPL (z-end, n=8):" in out and "random features" in out
    assert cli.main(["eval-fid", "--workdir", wd, "--device", "cpu",
                     "--num-samples", "8", "--metrics", "ppl"]) == 0
    line = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith("PPL:")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))
    with pytest.raises(ValueError, match="style"):
        cli.main(["eval-ppl", "--workdir", wd, "--device", "cpu",
                  "--num-samples", "8", "--space", "w"])
    assert cli.main(["mixgrid", "--workdir", wd, "--device", "cpu"]) == 1

"""The port's latent walks, style-mixing grid, CLI commands and
TensorBoard logging vs the JAX package.

* ``lerp`` and the closed walk of ``interpolation_path`` on the anchors
  the JAX package draws (injected): 1e-6 (the same float32 arithmetic;
  slerp's arccos in another library).
* ``cli.mixgrid_images`` on injected za / zb against the JAX CLI's
  composition (``map_latents`` -> ``truncate_ws`` -> the crossover
  ``where`` -> one ``synthesize`` over [A; B; cells], clipped), noise
  scales 0 so that the two RNG streams do not matter: 1e-4 (float32
  through the synthesis network, as ``test_torch_stylegan.py``), and the
  grid's layout: corner blank, top row B, left column A.
* ``cli prepare-data``, ``interpolate`` and ``mixgrid`` on a tiny trained
  workdir on the CPU.
* ``run.tensorboard`` writes event files under ``<log_dir>/tb``; without
  the ``tensorboard`` package the JSONL record alone, as the JAX logger
  without ``tensorflow``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models as jax_build_models
from ganlab_tpu.models.stylegan import truncate_ws as jax_truncate_ws
from ganlab_tpu.utils import latents as jax_latents
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.convert import from_flax
from ganlab_tpu_torch.models import build_generator
from ganlab_tpu_torch.utils.image import make_grid
from ganlab_tpu_torch.utils.latents import (
    interpolation_frames,
    interpolation_path,
    lerp,
)
from ganlab_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

SMALL = {"model.resolution": 16, "model.fmap_base": 64, "model.fmap_max": 8,
         "model.latent_dim": 8, "model.mapping_layers": 1,
         "run.compute_dtype": "float32"}


@pytest.mark.parametrize("spherical", [True, False])
def test_interpolation_path_on_jax_anchors(spherical):
    key = jax.random.PRNGKey(4)
    want = jax_latents.interpolation_path(key, 3, 5, 6, spherical=spherical)
    anchors = np.array(jax_latents.gen_latents(key, 3, 6))
    got = interpolation_frames(torch.from_numpy(anchors), 5,
                               spherical=spherical)
    assert got.shape == (15, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    walk = interpolation_path(torch.Generator().manual_seed(0), 3, 5, 6)
    assert walk.shape == (15, 6) and torch.equal(walk[::5][1], walk[5])


def test_lerp_matches_jax():
    rs = np.random.RandomState(1)
    a, b = rs.randn(4, 5).astype(np.float32), rs.randn(4, 5).astype(
        np.float32)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            lerp(torch.from_numpy(a), torch.from_numpy(b), t).numpy(),
            np.asarray(jax_latents.lerp(jnp.asarray(a), jnp.asarray(b), t)),
            rtol=1e-6, atol=1e-6)


def _jax_mixgrid(g_model, params, w_avg, za, zb, crossover, psi, lg, cutoff):
    """The composition of ``ganlab_tpu/cli.py``'s mixgrid."""
    from ganlab_tpu.models.stylegan import num_style_layers

    n, nl = za.shape[0], num_style_layers(lg)
    wa = g_model.apply(params, za, method="map_latents")
    wb = g_model.apply(params, zb, method="map_latents")
    wsa = jnp.repeat(wa[:, None, :], nl, 1)
    wsb = jnp.repeat(wb[:, None, :], nl, 1)
    wsa = jax_truncate_ws(wsa, w_avg, psi, cutoff)
    wsb = jax_truncate_ws(wsb, w_avg, psi, cutoff)
    layer = jnp.arange(nl)[None, None, :, None]
    mixed = jnp.where(layer < crossover, wsa[:, None], wsb[None, :])
    ws = jnp.concatenate([wsa, wsb, mixed.reshape(n * n, nl, -1)], 0)
    imgs = g_model.apply(params, ws, lg, 1.0, method="synthesize",
                         rngs={"noise": jax.random.PRNGKey(0)})
    imgs = np.asarray(jnp.clip(imgs, -1.0, 1.0))
    a_imgs, b_imgs = imgs[:n], imgs[n:2 * n]
    cells = imgs[2 * n:].reshape(n, n, *imgs.shape[1:])
    rows = [np.stack([np.ones_like(imgs[0])] + list(b_imgs))]
    for i in range(n):
        rows.append(np.stack([a_imgs[i]] + list(cells[i])))
    return np.concatenate(rows, 0)


@pytest.mark.parametrize("crossover", [2, 5])
def test_mixgrid_matches_jax_composition(crossover):
    jcfg = jax_get_config("stylegan-256", **SMALL)
    jg, _ = jax_build_models(jcfg.model)
    rs = np.random.RandomState(2)

    def perturb(path, leaf):
        a = np.asarray(leaf, np.float32)
        if "noise" in jax.tree_util.keystr(path):
            return np.zeros_like(a)
        return (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        perturb, jax.tree_util.tree_map(
            np.asarray, jg.init_all(jax.random.PRNGKey(0))))
    za, zb = (rs.randn(3, 8).astype(np.float32) for _ in range(2))
    w_avg = rs.randn(8).astype(np.float32)
    cfg = get_config("stylegan-256", **SMALL)
    want = _jax_mixgrid(jg, params, jnp.asarray(w_avg), jnp.asarray(za),
                        jnp.asarray(zb), crossover, 0.7, 4,
                        cfg.model.truncation_cutoff)
    tg = build_generator(cfg.model)
    tg.load_state_dict(from_flax(params))
    with torch.inference_mode():
        got = cli.mixgrid_images(
            tg, torch.from_numpy(w_avg), torch.from_numpy(za),
            torch.from_numpy(zb), crossover=crossover, psi=0.7, res_log2=4,
            cutoff=cfg.model.truncation_cutoff)
    assert got.shape == (16, 3, 16, 16)
    assert torch.equal(got[0], torch.ones_like(got[0]))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """cli prepare-data on a folder of PNGs, then a few steps of cli train
    on the shards."""
    root = tmp_path_factory.mktemp("cli")
    src = root / "imgs"
    src.mkdir()
    rs = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rs.randint(0, 256, (20 + i, 24, 3)).astype(
            np.uint8)).save(src / f"{i}.png")
    assert cli.main(["prepare-data", "--src", str(src), "--out",
                     str(root / "npy"), "--max-res", "16"]) == 0
    assert sorted(p.name for p in (root / "npy").iterdir()) == [
        "images_16.npy", "images_4.npy", "images_8.npy"]
    wd = str(root / "run")
    args = ["train", "--preset", "stylegan-256", "--workdir", wd,
            "--device", "cpu", "--max-steps", "3"]
    for k, v in dict(SMALL, **{"data.dataset": "npy",
                               "data.data_dir": str(root / "npy"),
                               "schedule.batch_schedule": {8: 2, 16: 2}
                               }).items():
        args += ["--set", f"{k}={v}"]
    assert cli.main(args) == 0
    return wd


def test_cli_interpolate_and_mixgrid(workdir):
    assert cli.main(["interpolate", "--workdir", workdir, "--device", "cpu",
                     "--anchors", "2", "--steps", "3"]) == 0
    img = np.asarray(Image.open(f"{workdir}/samples/interpolation.png"))
    assert img.shape == make_grid(np.zeros((6, 16, 16, 3), np.uint8),
                                  3).shape
    assert cli.main(["mixgrid", "--workdir", workdir, "--device", "cpu",
                     "--num", "2", "--crossover", "3"]) == 0
    img = np.asarray(Image.open(f"{workdir}/samples/mixgrid.png"))
    assert img.shape == make_grid(np.zeros((9, 16, 16, 3), np.uint8),
                                  3).shape
    assert (img[:16, :16] == 255).all()                 # the blank corner


def test_tensorboard_event_files(tmp_path):
    logger = MetricLogger(str(tmp_path), tensorboard=True)
    logger.log(1, {"d_loss": 0.5, "res": 8}, echo=False)
    logger.log(2, {"d_loss": 0.25}, echo=False)
    logger.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    # every float of a row but its time, as the JAX logger writes (ints
    # such as res become floats in the row)
    assert sorted(acc.Tags()["scalars"]) == ["d_loss", "res"]
    assert [(e.step, e.value) for e in acc.Scalars("d_loss")] == [
        (1, 0.5), (2, 0.25)]
    rows = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    assert [r["d_loss"] for r in rows] == [0.5, 0.25]


def test_tensorboard_absent_keeps_the_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricLogger(str(tmp_path), tensorboard=True)
    logger.log(1, {"g_loss": 1.0}, echo=False)
    logger.close()
    assert not (tmp_path / "tb").exists()
    assert json.loads(open(tmp_path / "train.jsonl").read())["g_loss"] == 1.0

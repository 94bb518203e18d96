"""The port's evaluation vs ``ganlab_tpu.eval`` and the JAX trainer's eval.

* FID, KID, precision and recall on the same features: 1e-6 relative
  (both packages run the same numpy float64 code).
* ``RandomConvExtractor``: the JAX package's numpy-seeded weights, its
  "SAME" padding on even and odd sizes; features within 1e-5 of their
  scale (float32 convolutions in another order).
* ``InceptionExtractor`` on a random state dict with non-trivial batch
  norms (``tests/torch_inception_oracle.py``), 2 images of 64x64 resized
  to 299: against the JAX ``inception_pool3`` and against the torch
  oracle, 1e-4 of the feature scale (float32 through ~95 layers).
* ``Trainer.run_eval`` (``run.eval_kimg``) logs the JAX trainer's keys to
  ``train.jsonl``; ``cli eval-fid --metrics fid,kid,pr`` on a tiny trained
  workdir caches the real features under the JAX package's key.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.eval import fid as jax_fid
from ganlab_tpu.eval.inception import (
    inception_pool3,
    load_torch_state_dict,
    preprocess,
)
from ganlab_tpu_torch import cli
from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.eval import (
    InceptionExtractor,
    RandomConvExtractor,
    compute_fid,
    compute_kid,
    compute_precision_recall,
    get_extractor,
)
from ganlab_tpu_torch.eval import fid as port_fid
from ganlab_tpu_torch.train import Trainer
from tests.torch_inception_oracle import (
    random_state_dict,
    torch_pool3,
    torch_resize_299,
)

torch.set_num_threads(1)

TINY = {"model.resolution": 16, "model.fmap_base": 64, "model.fmap_max": 8,
        "model.latent_dim": 8, "model.mapping_layers": 1,
        "run.compute_dtype": "float32", "data.dataset": "synthetic",
        "schedule.fade_kimg": 0.016, "schedule.stabilize_kimg": 0.016,
        "schedule.batch_schedule": {8: 4, 16: 4}, "run.log_every": 1,
        "run.eval_samples": 12, "run.eval_extractor": "randconv"}
# the keys of ganlab_tpu/train/loop.py::Trainer.run_eval's row
EVAL_KEYS = {"step", "time", "eval_fid", "eval_kid", "eval_extractor",
             "eval_samples", "res", "kind", "shown_imgs"}


def _feats(seed, n=40, d=16, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) + shift).astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 0.7])
def test_metrics_match_jax(shift):
    real, fake = _feats(0), _feats(1, n=36, shift=shift)
    np.testing.assert_allclose(compute_fid(real, fake),
                               jax_fid.compute_fid(real, fake), rtol=1e-6)
    np.testing.assert_allclose(
        compute_kid(real, fake, subset_size=20),
        jax_fid.compute_kid(real, fake, subset_size=20), rtol=1e-6)
    np.testing.assert_allclose(
        compute_precision_recall(real, fake, k=3),
        jax_fid.compute_precision_recall(real, fake, k=3), rtol=1e-6)


@pytest.mark.parametrize("hw", [(32, 32), (33, 30)])
def test_random_conv_extractor_matches_jax(hw):
    x = np.random.RandomState(2).uniform(-1, 1, (3, *hw, 3)) \
        .astype(np.float32)
    want = jax_fid.RandomConvExtractor()(x)
    with torch.inference_mode():
        got = RandomConvExtractor()(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_inception_matches_jax_and_oracle(tmp_path):
    sd = random_state_dict(seed=11)
    path = tmp_path / "inception.pth"
    torch.save(sd, path)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    net = InceptionExtractor(weights_path=str(path))
    assert net.pretrained
    with torch.inference_mode():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    want = np.asarray(inception_pool3(load_torch_state_dict(str(path)),
                                      preprocess(jnp.asarray(x))))
    oracle = torch_pool3(sd, torch_resize_299(x))
    assert got.shape == (2, 2048)
    for ref in (want, oracle):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_extractor_choice(tmp_path, monkeypatch):
    monkeypatch.delenv(port_fid.WEIGHTS_ENV, raising=False)
    assert isinstance(get_extractor(), RandomConvExtractor)
    path = tmp_path / "w.pth"
    torch.save(InceptionExtractor().state_dict(), path)
    monkeypatch.setenv(port_fid.WEIGHTS_ENV, str(path))
    ext = get_extractor()
    assert isinstance(ext, InceptionExtractor) and ext.pretrained
    assert not InceptionExtractor().pretrained


def test_real_cache_key_is_the_jax_key():
    over = {"data.dataset": "npy", "data.data_dir": "/data/x",
            "model.resolution": 64}
    assert RandomConvExtractor.name == jax_fid.RandomConvExtractor.name
    for ext in (RandomConvExtractor(), InceptionExtractor()):
        a = port_fid._real_cache_path(get_config("stylegan-256", **over),
                                      "wd", ext, 500)
        b = jax_fid._real_cache_path(jax_get_config("stylegan-256", **over),
                                     "wd", ext, 500)
        assert a == b and "_64_n500_s0" in a


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny run through 8x8 and the 16x16 fade, FID every 16 images."""
    wd = str(tmp_path_factory.mktemp("run"))
    cfg = get_config("stylegan-256", **dict(TINY, **{"run.eval_kimg": 0.016}))
    trainer = Trainer(cfg, wd, device="cpu")
    try:
        trainer.train(max_steps=8)
    finally:
        trainer.close()
    return wd


def test_run_eval_rows(workdir):
    with open(f"{workdir}/train.jsonl") as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if "eval_fid" in r]
    # 8 steps of 4 images, an evaluation every 16
    assert [r["step"] for r in evals] == [4, 8]
    for r in evals:
        assert set(r) == EVAL_KEYS
        assert r["eval_extractor"] == "random_conv"
        assert r["eval_samples"] == 12 and np.isfinite(r["eval_fid"])
        assert np.isfinite(r["eval_kid"])
    assert [(r["res"], r["kind"]) for r in evals] == [(8, "stabilize"),
                                                       (16, "fade")]


def test_cli_eval_fid(workdir, capsys):
    args = ["eval-fid", "--workdir", workdir, "--device", "cpu",
            "--num-samples", "10", "--metrics", "fid,kid,pr"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    for key in ("FID:", "KID:", "PRECISION:", "RECALL:"):
        assert key in out
    assert cli.main(args) == 0
    assert "real-feature cache hit" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A.2"):
        cli.main(["eval-fid", "--workdir", workdir, "--device", "cpu",
                  "--metrics", "fid,ppl"])

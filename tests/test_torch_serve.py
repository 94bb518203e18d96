"""The port's BatchSampler (ganlab_tpu_torch/serve.py), on the CPU.

Parity: with the noise scales at 0 (so the two packages' RNG streams do
not matter) the port's ``generate_from_z`` and the JAX package's give the
same uint8 images within 1 level. Contract (as tests/test_serve.py holds
it for the JAX sampler): shapes and dtype, index-stable prefixes,
repeatability, truncation, interpolation endpoints. The result path (uint8
made on the device, one copy to the host) gives the bits of the float32
host path: ``utils.image.to_uint8`` of the trimmed, concatenated float32
images of ``build_sample_fn`` on the same padded latents and noise seeds.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu.config import get_config as jax_get_config
from ganlab_tpu.models import build_models
from ganlab_tpu.serve import BatchSampler as JaxBatchSampler
from ganlab_tpu_torch import BatchSampler, build_generator, get_config
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.serve import _NOISE_STREAM
from ganlab_tpu_torch.utils.image import to_uint8
from ganlab_tpu_torch.utils.latents import stream_latents, stream_seed

SMALL = {"model.resolution": 16, "model.fmap_base": 128,
         "model.fmap_max": 16, "model.latent_dim": 16,
         "model.mapping_layers": 2, "run.compute_dtype": "float32"}


def test_generate_from_z_matches_jax():
    jcfg = jax_get_config("stylegan-256", **SMALL)
    jg, _ = build_models(jcfg.model)
    rs = np.random.RandomState(0)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        if "noise" in jax.tree_util.keystr(path):
            return np.zeros_like(a)
        return (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        f, jax.tree_util.tree_map(np.asarray,
                                  jg.init_all(jax.random.PRNGKey(0))))
    w_avg = rs.randn(16).astype(np.float32)
    z = rs.randn(6, 16).astype(np.float32)
    want = JaxBatchSampler(
        jcfg, state=SimpleNamespace(params_ema=params,
                                    w_avg=jnp.asarray(w_avg)),
        batch_size=4).generate_from_z(z)
    got = BatchSampler(get_config("stylegan-256", **SMALL), params=params,
                       w_avg=w_avg, batch_size=4,
                       device="cpu").generate_from_z(z)
    assert got.shape == want.shape == (6, 16, 16, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


@pytest.fixture(scope="module")
def sampler():
    cfg = get_config("stylegan-256", **SMALL)
    torch.manual_seed(0)
    sd = build_generator(cfg.model).state_dict()
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith(("noise.scale", ".bias", ".b")):
            v += 0.3 * torch.randn(v.shape, generator=gen)
    return BatchSampler(cfg, params=sd, w_avg=torch.zeros(16),
                        batch_size=4, device="cpu").warmup()


def test_generate_shapes_and_dtype(sampler):
    imgs = sampler.generate(6, seed=0)
    assert imgs.shape == (6, 16, 16, 3)
    assert imgs.dtype == np.uint8


def test_index_stable_determinism(sampler):
    a = sampler.generate(3, seed=7)
    b = sampler.generate(6, seed=7)
    np.testing.assert_array_equal(a, b[:3])
    np.testing.assert_array_equal(b, sampler.generate(6, seed=7))
    assert not np.array_equal(b, sampler.generate(6, seed=8))


def test_latents_index_stable(sampler):
    z = sampler.latents(4, seed=3)
    assert z.shape == (4, 16) and z.dtype == np.float32
    np.testing.assert_array_equal(z[1:3], sampler.latents(2, seed=3, start=1))


def test_truncation_psi_changes_output(sampler):
    a = sampler.generate(4, seed=0, psi=1.0)
    b = sampler.generate(4, seed=0, psi=0.2)
    assert not np.array_equal(a, b)


def test_interpolate_endpoints(sampler):
    frames = sampler.interpolate(seed_a=0, seed_b=1, steps=5)
    assert frames.shape == (5, 16, 16, 3)
    ends = sampler.generate_from_z(sampler.latents(1, seed=0))
    np.testing.assert_array_equal(frames[0], ends[0])


def test_save_grid(sampler, tmp_path):
    p = sampler.save_grid(str(tmp_path / "g.png"), n=4)
    assert (tmp_path / "g.png").exists() and p.endswith("g.png")


def _float_host_images(sampler, zs, noise_seeds, psi, n):
    """``to_uint8`` on the host of the float32 NHWC images that
    ``build_sample_fn`` makes for each padded batch of ``zs`` with its
    noise generator seeded from ``noise_seeds``, concatenated and trimmed
    to ``n``."""
    sample = build_sample_fn(sampler.cfg, sampler.res_log2)
    out = []
    with torch.inference_mode():
        for z, noise_seed in zip(zs, noise_seeds):
            gen = torch.Generator().manual_seed(noise_seed)
            img = sample(sampler.g, sampler.w_avg, torch.from_numpy(z), gen,
                         psi, 1.0)
            out.append(img.permute(0, 2, 3, 1).numpy())
    return to_uint8(np.concatenate(out, axis=0)[:n])


@pytest.mark.parametrize("n", [3, 4, 7])
def test_uint8_on_the_device_equals_the_float_host_path(sampler, n):
    """For n of batch - 1, batch and 2 batch - 1 (batch 4), ``generate``
    (psi 0.6) and ``generate_from_z`` (the default psi) bit-equal to the
    float32 host path."""
    B, nb = sampler.batch_size, -(-n // sampler.batch_size)
    zs = [stream_latents(B, 16, seed=2, start=b * B) for b in range(nb)]
    np.testing.assert_array_equal(
        sampler.generate(n, seed=2, psi=0.6),
        _float_host_images(sampler, zs,
                           [stream_seed(2, _NOISE_STREAM, b)
                            for b in range(nb)], 0.6, n))
    z = np.random.RandomState(n).randn(n, 16).astype(np.float32)
    padded = np.zeros((nb * B, 16), np.float32)
    padded[:n] = z
    np.testing.assert_array_equal(
        sampler.generate_from_z(z, noise_seed=5),
        _float_host_images(sampler, list(padded.reshape(nb, B, 16)),
                           [stream_seed(5, b) for b in range(nb)],
                           sampler._default_psi, n))

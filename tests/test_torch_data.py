"""The port's data sources and prefetcher vs ``ganlab_tpu.data``.

The sources are numpy only in both packages, so the same seed, batch size
and resolution must give the same uint8 bytes: compared with
``assert_array_equal`` (no tolerance). The JAX package's optional native
gather library is bit-identical to its numpy path by its own tests, so
the comparison holds whether or not it is built.
"""

import threading

import numpy as np
import pytest
import torch

from ganlab_tpu.config import DataConfig as JaxDataConfig
from ganlab_tpu.data import pipeline as jax_data
from ganlab_tpu_torch.config import DataConfig
from ganlab_tpu_torch.data import (
    ArraySource,
    EllipsesSource,
    NpySource,
    Prefetcher,
    SyntheticSource,
    box_downsample,
    device_placer,
    make_source,
)


def _pool(seed=0, n=24, res=32):
    return np.random.RandomState(seed).randint(
        0, 256, (n, res, res, 3)).astype(np.uint8)


@pytest.mark.parametrize("res", [32, 16, 8])
@pytest.mark.parametrize("name", ["synthetic", "ellipses"])
def test_procedural_sources_match_jax_bytes(name, res):
    ours = make_source(DataConfig(dataset=name), 32, seed=5)
    theirs = jax_data.make_source(JaxDataConfig(dataset=name), 32, seed=5)
    assert type(ours).__name__ == type(theirs).__name__
    for batch in (4, 7):
        a, b = ours.batch(batch, res), theirs.batch(batch, res)
        assert a.dtype == np.uint8 and a.shape == (batch, res, res, 3)
        np.testing.assert_array_equal(a, b)


def test_source_pool_size_follows_config():
    ours = make_source(DataConfig(dataset="synthetic", num_images=8), 16, 1)
    theirs = jax_data.make_source(
        JaxDataConfig(dataset="synthetic", num_images=8), 16, 1)
    assert ours.num_images == theirs.num_images == 8
    np.testing.assert_array_equal(ours.batch(6, 8), theirs.batch(6, 8))
    ours = make_source(DataConfig(dataset="ellipses", num_images=5), 16, 2)
    theirs = jax_data.make_source(
        JaxDataConfig(dataset="ellipses", num_images=5), 16, 2)
    np.testing.assert_array_equal(ours.batch(9, 16), theirs.batch(9, 16))


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_box_downsample_and_array_source_match_jax(factor):
    pool = _pool()
    np.testing.assert_array_equal(box_downsample(pool, factor),
                                  jax_data.box_downsample(pool, factor))
    ours, theirs = ArraySource(pool, seed=3), jax_data.ArraySource(pool, 3)
    np.testing.assert_array_equal(ours.batch(5, 32 // factor),
                                  theirs.batch(5, 32 // factor))


def test_npy_source_matches_jax(tmp_path):
    pool = _pool(1)
    np.save(tmp_path / "images_32.npy", pool)
    np.save(tmp_path / "images_16.npy", box_downsample(pool, 2))
    ours = make_source(DataConfig(dataset="npy", data_dir=str(tmp_path)),
                       32, seed=4)
    theirs = jax_data.NpySource(str(tmp_path), seed=4)
    assert isinstance(ours, NpySource)
    for res in (32, 16, 8):      # exact shards, then a downsampled one
        np.testing.assert_array_equal(ours.batch(6, res),
                                      theirs.batch(6, res))


def test_npy_source_without_shards_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="images_<res>.npy"):
        NpySource(str(tmp_path))


@pytest.mark.parametrize("name", ["cifar10", "image_folder",
                                  "image_folder_stream"])
def test_unported_sources_raise(name, tmp_path):
    """These sources are ported (tests/test_torch_sources.py): they now
    raise only where the data is missing, as the JAX package's do."""
    with pytest.raises(FileNotFoundError):
        make_source(DataConfig(dataset=name, data_dir=str(tmp_path)), 32)
    with pytest.raises(FileNotFoundError):
        jax_data.make_source(JaxDataConfig(dataset=name,
                                           data_dir=str(tmp_path)), 32)


def test_make_source_rejects_unknown_and_too_small():
    with pytest.raises(ValueError, match="unknown dataset"):
        make_source(DataConfig(dataset="nope"), 32)
    with pytest.raises(ValueError):
        make_source(DataConfig(dataset="synthetic"), 48)  # no power of two


class _Counting:
    """A source whose batch k is filled with k."""

    def __init__(self):
        self.k = 0

    def batch(self, batch_size, res):
        out = np.full((batch_size, res, res, 3), self.k % 256, np.uint8)
        self.k += 1
        return out


def test_prefetcher_order_placement_and_shutdown():
    before = threading.active_count()
    with Prefetcher(_Counting(), 2, 4, place=device_placer("cpu"),
                    depth=2) as pf:
        got = [pf.next() for _ in range(6)]
        thread = pf._thread
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.uint8
               and b.shape == (2, 4, 4, 3) for b in got)
    assert [int(b[0, 0, 0, 0]) for b in got] == list(range(6))
    assert not thread.is_alive()
    assert threading.active_count() == before


def test_prefetcher_matches_direct_batches():
    direct = SyntheticSource(16, num_images=16, seed=9)
    want = [direct.batch(3, 8) for _ in range(4)]
    with Prefetcher(SyntheticSource(16, num_images=16, seed=9), 3, 8) as pf:
        for w in want:
            np.testing.assert_array_equal(pf.next(), w)


def test_prefetcher_surfaces_worker_errors():
    class Broken:
        def batch(self, batch_size, res):
            raise OSError("disk gone")

    with Prefetcher(Broken(), 2, 4) as pf:
        with pytest.raises(RuntimeError, match="worker failed"):
            pf.next()


def test_ellipses_render_is_a_function_of_seed_and_index():
    a = EllipsesSource(32, seed=1).render(np.arange(5), 16)
    b = jax_data.EllipsesSource(32, seed=1).render(np.arange(5), 16)
    c = EllipsesSource(32, seed=2).render(np.arange(5), 16)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)

"""The port's dataset sources, shards and native gather vs ``ganlab_tpu.data``.

Same files and seed, same bytes: CIFAR-10 pickle batches, an image folder
of PNG and JPEG files of mixed, non-square sizes (PIL decode, centre crop,
LANCZOS), the ``images_<res>.npy`` shards of ``prepare_dataset`` (file
bytes), and the native gather at factors 1, 2, 4 and 8 against the numpy
path (``assert_array_equal``, no tolerance). The streaming source cannot
follow grain's shuffle order: each image it serves must be the JAX
package's ``_DecodeResize`` of its file, and an epoch must serve every
file exactly once, also from worker processes.
"""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from ganlab_tpu.config import DataConfig as JaxDataConfig
from ganlab_tpu.data import native as jax_native
from ganlab_tpu.data import pipeline as jax_data
from ganlab_tpu.data.grain_source import _DecodeResize
from ganlab_tpu.data.prepare import prepare_dataset as jax_prepare
from ganlab_tpu_torch.config import DataConfig
from ganlab_tpu_torch.data import (
    Cifar10Source,
    ImageFolderSource,
    NpySource,
    box_downsample,
    make_source,
    native,
    prepare_dataset,
)
from ganlab_tpu_torch.data import pipeline as port_data
from ganlab_tpu_torch.data.stream_source import StreamingImageFolderSource

torch.set_num_threads(1)

SIZES = [(40, 40), (52, 36), (30, 47), (64, 64), (33, 45), (47, 29)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Smooth random images of mixed sizes, PNG and JPEG, plus a file the
    sources must skip."""
    d = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for i, (w, h) in enumerate(SIZES):
        low = rs.randint(0, 256, (4, 4, 3)).astype(np.uint8)
        img = Image.fromarray(low).resize((w, h), Image.BILINEAR)
        img.save(d / f"im{i}.{'jpg' if i % 2 else 'png'}")
    (d / "notes.txt").write_text("not an image")
    return str(d)


def _cifar_dir(root, n=6, seed=0):
    rs = np.random.RandomState(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rs.randint(0, 256, (n, 3072)).astype(np.uint8)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": [0] * n}, f)
    return str(root)


def test_cifar10_matches_jax(tmp_path, monkeypatch):
    """Held to the JAX package's numpy path: its native gather reads
    CIFAR's transposed (not C-contiguous) array as if it were contiguous
    and serves other bytes; the port makes the array contiguous."""
    monkeypatch.setattr(jax_native, "gather", lambda *a: None)
    root = _cifar_dir(tmp_path)
    ours = make_source(DataConfig(dataset="cifar10", data_dir=root), 32, 4)
    theirs = jax_data.make_source(
        JaxDataConfig(dataset="cifar10", data_dir=root), 32, 4)
    assert isinstance(ours, Cifar10Source) and ours.num_images == 30
    np.testing.assert_array_equal(ours._images, theirs._images)
    for res in (32, 8):
        np.testing.assert_array_equal(ours.batch(5, res),
                                      theirs.batch(5, res))
    test = Cifar10Source(root, train=False)
    np.testing.assert_array_equal(
        test._images, jax_data.Cifar10Source(root, train=False)._images)
    with pytest.raises(ValueError, match="data_dir"):
        make_source(DataConfig(dataset="cifar10"), 32)


def test_image_folder_matches_jax(folder):
    ours = make_source(DataConfig(dataset="image_folder", data_dir=folder),
                       32, seed=2)
    theirs = jax_data.make_source(
        JaxDataConfig(dataset="image_folder", data_dir=folder), 32, seed=2)
    assert isinstance(ours, ImageFolderSource)
    assert ours._images.shape == (len(SIZES), 32, 32, 3)
    np.testing.assert_array_equal(ours._images, theirs._images)
    for res in (32, 16, 4):
        np.testing.assert_array_equal(ours.batch(7, res),
                                      theirs.batch(7, res))
    limited = ImageFolderSource(folder, 16, limit=2)
    np.testing.assert_array_equal(
        limited._images, jax_data.ImageFolderSource(folder, 16,
                                                    limit=2)._images)


def test_prepare_dataset_writes_jax_shards(folder, tmp_path):
    ours = prepare_dataset(folder, str(tmp_path / "ours"), 32)
    theirs = jax_prepare(folder, str(tmp_path / "theirs"), 32)
    assert sorted(ours) == sorted(theirs) == [4, 8, 16, 32]
    for res in ours:
        with open(ours[res], "rb") as a, open(theirs[res], "rb") as b:
            assert a.read() == b.read(), res
    src = NpySource(str(tmp_path / "ours"), seed=1)
    want = jax_data.NpySource(str(tmp_path / "theirs"), seed=1)
    for res in (32, 8, 2):
        np.testing.assert_array_equal(src.batch(6, res), want.batch(6, res))


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_native_gather_bit_equal_to_numpy(factor):
    assert native.available(), "g++ builds the native library here"
    rs = np.random.RandomState(factor)
    src = rs.randint(0, 256, (12, 32, 32, 3)).astype(np.uint8)
    idx = rs.randint(0, 12, 9).astype(np.int64)
    want = box_downsample(np.ascontiguousarray(src[idx]), factor)
    got = native.gather(src, idx, factor)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_data.box_downsample(np.ascontiguousarray(src[idx]),
                                     factor))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.gather(src, idx,
                                                             factor))
    np.testing.assert_array_equal(port_data._gather(src, idx, factor), want)


def test_native_gather_rejects_bad_input():
    src = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(IndexError):
        native.gather(src, np.array([4]), 1)
    with pytest.raises(ValueError):
        native.gather(src, np.array([0]), 3)
    with pytest.raises(ValueError):
        native.gather(src.astype(np.float32), np.array([0]), 1)


def test_numpy_fallback_is_logged_once(monkeypatch, capsys):
    """Without a compiler the sources take the numpy path, with the same
    bytes, and say so once on stderr."""
    monkeypatch.setattr(native, "_state", native._Native())

    def no_compiler():
        raise OSError("g++ not found on PATH")

    monkeypatch.setattr(native, "_build", no_compiler)
    src = np.random.RandomState(3).randint(0, 256, (5, 16, 16, 3)) \
        .astype(np.uint8)
    idx = np.array([4, 0, 2])
    for _ in range(2):
        assert native.gather(src, idx, 2) is None
        np.testing.assert_array_equal(
            port_data._gather(src, idx, 2),
            box_downsample(np.ascontiguousarray(src[idx]), 2))
    err = capsys.readouterr().err
    assert err.count("numpy") == 1 and "g++ not found" in err


def test_stream_images_are_the_jax_decode(folder):
    src = StreamingImageFolderSource(folder, 32, seed=0, num_workers=0)
    try:
        files = port_data.list_images(folder)
        want = {f: _DecodeResize(16).map(f) for f in files}
        got = src.batch(len(files), 16)
        assert got.dtype == np.uint8 and got.shape == (len(files), 16, 16, 3)
        # one epoch = every file once, each the JAX decode's bytes
        matched = sorted(next(f for f, w in want.items()
                              if np.array_equal(w, img)) for img in got)
        assert matched == sorted(files)
        with pytest.raises(ValueError):
            src.batch(2, 64)
    finally:
        src.close()


def test_stream_epochs_from_workers(folder):
    """Two worker processes: two epochs of batches cover every file once
    each, the epochs in other orders; a new (batch, res) replaces the
    loader and its workers."""
    src = make_source(DataConfig(dataset="image_folder_stream",
                                 data_dir=folder, num_workers=2), 32, 5)
    assert isinstance(src, StreamingImageFolderSource)
    ref = ImageFolderSource(folder, 8)._images
    n = len(SIZES)
    try:
        epochs = []
        for _ in range(2):
            imgs = np.concatenate([src.batch(3, 8) for _ in range(n // 3)])
            order = [next(i for i in range(n) if np.array_equal(ref[i], im))
                     for im in imgs]
            assert sorted(order) == list(range(n))
            epochs.append(order)
        assert epochs[0] != epochs[1]
        workers = list(src._iter._workers)
        assert len(workers) == 2 and all(w.is_alive() for w in workers)
        assert src.batch(2, 4).shape == (2, 4, 4, 3)
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
    finally:
        src.close()


def test_formerly_unported_names_and_tfrecords(tmp_path):
    with pytest.raises(ValueError, match="npy"):
        make_source(DataConfig(dataset="tfrecords", data_dir="."), 32)
    for name in ("image_folder", "image_folder_stream"):
        with pytest.raises(FileNotFoundError, match="no images"):
            make_source(DataConfig(dataset=name, data_dir=str(tmp_path)), 32)

"""Data sources and the device prefetcher of the training loop.

Port of ``ganlab_tpu/data/pipeline.py``, numpy and PIL, so the same seed
and files give the same bytes as the JAX package's sources. The host
serves raw uint8 NHWC batches per resolution; normalization and the
horizontal flip happen on the device inside the training step
(``train/steps._preprocess``). Sources: the procedural ``synthetic`` and
``ellipses``, in-memory arrays, memory-mapped ``.npy`` shards (written by
``data/prepare.py``), CIFAR-10's python pickle batches, an image folder
decoded once at startup, and an image folder streamed through
``DataLoader`` workers (``data/stream_source.py``). Batches of the indexed
sources are gathered by the native library (``data/native.py``) or, where
it cannot be built, by numpy with the same bytes.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ganlab_tpu_torch.config import DataConfig, res_to_log2

def box_downsample(x: np.ndarray, factor: int) -> np.ndarray:
    """Exact mean-pool downsample of uint8 NHWC by a power-of-two factor."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return (x.astype(np.float32).mean(axis=(2, 4)) + 0.5).astype(np.uint8)

def _gather(images: np.ndarray, idx: np.ndarray, factor: int) -> np.ndarray:
    """Batch gather + optional downsample; the native C++ library when it
    is built (``data/native.py``), numpy otherwise (bit-identical)."""
    from ganlab_tpu_torch.data import native

    out = native.gather(images, idx, factor)
    if out is not None:
        return out
    imgs = np.ascontiguousarray(images[idx])
    return box_downsample(imgs, factor)


class _IndexedSource:
    """Base: subclasses hold a (N, R, R, C) uint8 array (possibly memmap) at
    max resolution and serve per-resolution random batches."""

    def __init__(self, images: np.ndarray, seed: int = 0):
        assert images.dtype == np.uint8 and images.ndim == 4, images.shape
        # the native gather reads rows of a C-contiguous array (CIFAR's
        # transposed batches are not; a contiguous memmap is not copied)
        self._images = np.ascontiguousarray(images)
        self._rng = np.random.default_rng(seed)
        self.resolution = images.shape[1]
        self.num_images = images.shape[0]

    def batch(self, batch_size: int, res: int) -> np.ndarray:
        assert res <= self.resolution, (res, self.resolution)
        idx = self._rng.integers(0, self.num_images, size=batch_size)
        return _gather(self._images, idx, self.resolution // res)

    def iterator(self, batch_size: int, res: int) -> Iterator[np.ndarray]:
        while True:
            yield self.batch(batch_size, res)


class SyntheticSource(_IndexedSource):
    """A fixed pool of random images — deterministic, network-free; used by
    tests, smoke configs, and the bench harness."""

    def __init__(self, resolution: int, num_images: int = 256,
                 channels: int = 3, seed: int = 0):
        rng = np.random.default_rng(seed)
        # Smooth random blobs (pure noise makes GP/critic stats degenerate):
        # random low-res fields upsampled to the target resolution.
        low = rng.integers(0, 256, size=(num_images, 8, 8, channels))
        reps = resolution // 8 if resolution >= 8 else 1
        imgs = np.repeat(np.repeat(low, reps, axis=1), reps, axis=2)
        imgs = imgs[:, :resolution, :resolution, :].astype(np.uint8)
        super().__init__(imgs, seed)


class EllipsesSource:
    """Procedural structured distribution: a flat background plus 1-3
    anti-aliased colored ellipses with random center/axes/angle/color.

    Unlike :class:`SyntheticSource` (a fixed pool the discriminator can
    memorize — measured r3: FID rises after an early peak on the
    256-image pool, the classic small-dataset D-overfitting signature),
    this source is effectively infinite: image ``i`` is a pure function
    of ``(seed, i)`` via a counter-based hash, with a virtual pool of
    ``num_images`` (default 2**30). Set ``num_images`` small to study
    overfitting / adaptive-augmentation behavior deliberately.

    The underlying manifold is low-dimensional (≈13 parameters), so a
    GAN can genuinely cover it and FID falls monotonically with
    training — the property that makes relative FID A/Bs sensitive.
    Rendering is resolution-independent (drawn at the requested res with
    a ~1px soft edge), so every progressive phase sees the same
    distribution.
    """

    def __init__(self, resolution: int, num_images: int = 1 << 30,
                 seed: int = 0, max_ellipses: int = 3):
        self.resolution = resolution
        self.num_images = num_images
        self.max_ellipses = max_ellipses
        self._seed = np.uint64(seed)
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _hash(x: np.ndarray) -> np.ndarray:
        """splitmix64 finalizer — vectorized uint64 -> uint64."""
        m = np.uint64(0xFFFFFFFFFFFFFFFF)
        with np.errstate(over="ignore"):   # uint64 wraparound is the point
            x = (x + np.uint64(0x9E3779B97F4A7C15)) & m
            x = ((x ^ (x >> np.uint64(30)))
                 * np.uint64(0xBF58476D1CE4E5B9)) & m
            x = ((x ^ (x >> np.uint64(27)))
                 * np.uint64(0x94D049BB133111EB)) & m
            return x ^ (x >> np.uint64(31))

    def _uniform(self, idx: np.ndarray, salt: int) -> np.ndarray:
        """Deterministic U[0,1) per (seed, idx, salt), vectorized."""
        h = self._hash(idx.astype(np.uint64)
                       ^ self._hash(self._seed + np.uint64(salt)))
        return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)

    def render(self, idx: np.ndarray, res: int) -> np.ndarray:
        """Render images for explicit indices at ``res`` (uint8 NHWC)."""
        b, k = idx.shape[0], self.max_ellipses
        u = np.stack([self._uniform(idx, s) for s in range(4 + 7 * k)],
                     axis=1)                      # (B, 4+7K) param sheet
        bg = (u[:, 0:3] * 120.0)                  # dark background RGB
        n_active = 1 + (u[:, 3] * k).astype(np.int64)  # 1..K ellipses
        p = u[:, 4:].reshape(b, k, 7)
        cx, cy = 0.15 + 0.7 * p[..., 0], 0.15 + 0.7 * p[..., 1]
        ax, ay = 0.08 + 0.22 * p[..., 2], 0.08 + 0.22 * p[..., 3]
        ang = np.pi * p[..., 4]
        col = 80.0 + 175.0 * np.stack(
            [p[..., 5], p[..., 6], (p[..., 5] + p[..., 6]) % 1.0], axis=-1)
        cos, sin = np.cos(ang), np.sin(ang)

        g = (np.arange(res, dtype=np.float32) + 0.5) / res
        ys, xs = g[:, None], g[None, :]           # (R,1), (1,R)
        img = np.broadcast_to(
            bg[:, None, None, :].astype(np.float32), (b, res, res, 3)).copy()
        for j in range(k):                        # K is small and static
            dx = xs - cx[:, j, None, None]
            dy = ys - cy[:, j, None, None]
            rx = (dx * cos[:, j, None, None] + dy * sin[:, j, None, None]) \
                / ax[:, j, None, None]
            ry = (-dx * sin[:, j, None, None] + dy * cos[:, j, None, None]) \
                / ay[:, j, None, None]
            q = rx * rx + ry * ry
            alpha = np.clip((1.0 - q) * (0.25 * res) + 0.5, 0.0, 1.0)
            alpha *= (j < n_active)[:, None, None].astype(np.float32)
            img = img * (1.0 - alpha[..., None]) \
                + col[:, j][:, None, None, :] * alpha[..., None]
        return (img + 0.5).astype(np.uint8)

    def batch(self, batch_size: int, res: int) -> np.ndarray:
        assert res <= self.resolution, (res, self.resolution)
        idx = self._rng.integers(0, self.num_images, size=batch_size)
        return self.render(idx, res)

    def iterator(self, batch_size: int, res: int) -> Iterator[np.ndarray]:
        while True:
            yield self.batch(batch_size, res)


class ArraySource(_IndexedSource):
    """Wrap an in-memory uint8 array (N, R, R, C)."""


class NpySource(_IndexedSource):
    """Memory-mapped ``.npy`` shards written by ``cli prepare-data``.

    Layout: ``<data_dir>/images_<res>.npy`` per resolution; serving prefers
    the exact-resolution file and falls back to downsampling the smallest
    file that is >= the requested resolution.
    """

    def __init__(self, data_dir: str, seed: int = 0):
        self._dir = data_dir
        self._files: dict[int, np.ndarray] = {}
        for name in sorted(os.listdir(data_dir)):
            if name.startswith("images_") and name.endswith(".npy"):
                res = int(name[len("images_"):-len(".npy")])
                self._files[res] = np.load(os.path.join(data_dir, name),
                                           mmap_mode="r")
        if not self._files:
            raise FileNotFoundError(
                f"no images_<res>.npy shards in {data_dir}; "
                "run `python -m ganlab_tpu_torch.cli prepare-data` first")
        max_res = max(self._files)
        super().__init__(self._files[max_res], seed)

    def batch(self, batch_size: int, res: int) -> np.ndarray:
        # Prefer an exact-resolution shard (no resampling work at all).
        src_res = min((r for r in self._files if r >= res), default=None)
        if src_res is None:
            raise ValueError(f"no shard >= resolution {res}")
        arr = self._files[src_res]
        idx = self._rng.integers(0, arr.shape[0], size=batch_size)
        return _gather(arr, idx, src_res // res)


class Cifar10Source(_IndexedSource):
    """CIFAR-10 from the standard python pickle batches in ``data_dir``
    (or its ``cifar-10-batches-py/``). Nothing is downloaded. The pickles
    are unpickled: read only files of the dataset itself."""

    def __init__(self, data_dir: str, train: bool = True, seed: int = 0):
        batch_dir = data_dir
        if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")):
            batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        chunks = []
        for name in names:
            with open(os.path.join(batch_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            chunks.append(data)
        super().__init__(np.concatenate(chunks).astype(np.uint8), seed)


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(data_dir: str) -> list[str]:
    """The image files of a folder, sorted by name (not recursive)."""
    paths = [os.path.join(data_dir, n) for n in sorted(os.listdir(data_dir))
             if n.lower().endswith(IMAGE_EXTS)]
    if not paths:
        raise FileNotFoundError(f"no images in {data_dir}")
    return paths


def _center_crop_square(img):
    w, h = img.size
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    return img.crop((left, top, left + s, top + s))


def decode_image(path: str, resolution: int) -> np.ndarray:
    """One file -> (resolution, resolution, 3) uint8: RGB, centre crop to
    a square, LANCZOS resize (the JAX package's ``_decode_one`` and
    ``grain_source._DecodeResize``)."""
    from PIL import Image

    with Image.open(path) as f:
        img = f.convert("RGB")
    img = _center_crop_square(img)
    img = img.resize((resolution, resolution), Image.LANCZOS)
    return np.asarray(img, np.uint8)


class ImageFolderSource(_IndexedSource):
    """Decode a directory of images to a fixed resolution at startup,
    with a thread pool (PIL decode/resize release the GIL).

    For small datasets / smoke runs. Large datasets should go through
    ``prepare-data`` -> ``NpySource`` or stream (``image_folder_stream``).
    """

    def __init__(self, data_dir: str, resolution: int, seed: int = 0,
                 limit: int | None = None, num_workers: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        paths = list_images(data_dir)
        if limit:
            paths = paths[:limit]
        out = np.empty((len(paths), resolution, resolution, 3), np.uint8)
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for i, arr in enumerate(pool.map(
                    decode_image, paths, [resolution] * len(paths))):
                out[i] = arr
        super().__init__(out, seed)


def make_source(data_cfg: DataConfig, resolution: int, seed: int = 0):
    """Data-source factory keyed by the config's dataset selector.

    Validates up front that the source can serve the model's resolution
    (fail fast at startup, not inside the prefetch worker)."""
    res_to_log2(resolution)  # validate
    src = _make_source(data_cfg, resolution, seed)
    if getattr(src, "resolution", resolution) < resolution:
        raise ValueError(
            f"dataset {data_cfg.dataset!r} serves up to "
            f"{src.resolution}px but the model needs {resolution}px")
    return src


def _make_source(data_cfg: DataConfig, resolution: int, seed: int):
    name = data_cfg.dataset
    if name == "synthetic":
        return SyntheticSource(resolution, seed=seed,
                               num_images=data_cfg.num_images or 256)
    if name == "ellipses":
        return EllipsesSource(resolution, seed=seed,
                              num_images=data_cfg.num_images or (1 << 30))
    if name == "cifar10":
        if not data_cfg.data_dir:
            raise ValueError("cifar10 needs data.data_dir with the python "
                             "pickle batches (nothing is downloaded)")
        return Cifar10Source(data_cfg.data_dir, seed=seed)
    if name == "image_folder":
        return ImageFolderSource(data_cfg.data_dir, resolution, seed=seed)
    if name == "image_folder_stream":
        from ganlab_tpu_torch.data.stream_source import (
            StreamingImageFolderSource,
        )

        return StreamingImageFolderSource(data_cfg.data_dir, resolution,
                                          seed=seed,
                                          num_workers=data_cfg.num_workers)
    if name == "npy":
        return NpySource(data_cfg.data_dir, seed=seed)
    if name == "tfrecords":
        raise ValueError(
            "dataset='tfrecords' was a misnomer for the npy shard format "
            "and has been removed; use dataset='npy' with the shards "
            "written by `prepare-data`")
    raise ValueError(f"unknown dataset {name!r}")


def device_placer(device: str | torch.device) -> Callable:
    """``place`` for :class:`Prefetcher`: a uint8 numpy batch -> a tensor on
    ``device``. For a CUDA device the batch goes through pinned host memory
    and a ``non_blocking`` copy on a stream of the worker's own, so that the
    transfer overlaps the previous step; the copy is complete before the
    tensor is handed over."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: torch.from_numpy(np.ascontiguousarray(batch))
    stream = torch.cuda.Stream(device)

    def place(batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        with torch.cuda.stream(stream):
            out = host.to(device, non_blocking=True)
        stream.synchronize()
        return out

    return place


class Prefetcher:
    """Background-thread batch producer with optional device placement.

    ``place`` is typically ``device_placer(device)``: running it in the
    worker thread overlaps the host-to-device transfer with the previous
    step's compute. Batches come out in the order the source made them.
    """

    def __init__(self, source, batch_size: int, res: int,
                 place: Callable | None = None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._place = place or (lambda x: x)
        self._thread = threading.Thread(
            target=self._worker, args=(source, batch_size, res), daemon=True)
        self._thread.start()

    def _worker(self, source, batch_size, res):
        try:
            while not self._stop.is_set():
                batch = self._place(source.batch(batch_size, res))
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised in next()
            self._error = e
            self._stop.set()

    def next(self):
        # Poll so a dead worker surfaces its exception instead of a hang.
        while True:
            if self._error is not None:
                raise RuntimeError("data pipeline worker failed") \
                    from self._error
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                continue

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

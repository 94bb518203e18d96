"""Data sources and the device prefetcher of the training loop.

Port of ``ganlab_tpu/data/pipeline.py``, numpy only, so the same seed
gives the same bytes as the JAX package's sources. The host serves raw
uint8 NHWC batches per resolution; normalization and the horizontal flip
happen on the device inside the training step (``train/steps._preprocess``).
Ported: the procedural sources (``synthetic``, ``ellipses``), in-memory
arrays and memory-mapped ``.npy`` shards. The sources that decode a
dataset (``cifar10``, ``image_folder``, ``image_folder_stream``), the
native gather library and ``prepare-data`` are not ported yet (ROADMAP.md
A.5): ``make_source`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ganlab_tpu_torch.config import DataConfig, res_to_log2

_UNPORTED = ("cifar10", "image_folder", "image_folder_stream")


def box_downsample(x: np.ndarray, factor: int) -> np.ndarray:
    """Exact mean-pool downsample of uint8 NHWC by a power-of-two factor."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return (x.astype(np.float32).mean(axis=(2, 4)) + 0.5).astype(np.uint8)



def _gather(images: np.ndarray, idx: np.ndarray, factor: int) -> np.ndarray:
    """Batch gather + optional downsample (the JAX package's numpy path;
    its optional native library gives the same bytes)."""
    imgs = np.ascontiguousarray(images[idx])
    return box_downsample(imgs, factor)


class _IndexedSource:
    """Base: subclasses hold a (N, R, R, C) uint8 array (possibly memmap) at
    max resolution and serve per-resolution random batches."""

    def __init__(self, images: np.ndarray, seed: int = 0):
        assert images.dtype == np.uint8 and images.ndim == 4, images.shape
        self._images = images
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
    """Memory-mapped ``.npy`` shards written by ``ganlab prepare-data``.

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
                "run `ganlab prepare-data` first")
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
    if name == "npy":
        return NpySource(data_cfg.data_dir, seed=seed)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to PyTorch yet (ROADMAP.md "
            "A.5: the sources that decode a dataset wait until such files "
            "are at hand); use 'synthetic', 'ellipses' or 'npy'")
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

"""Streaming image-folder source: decode on the fly in worker processes.

The port's counterpart of ``ganlab_tpu/data/grain_source.py`` (dataset
``image_folder_stream``), in PyTorch's idiom. For datasets too large to
decode up front (``ImageFolderSource``) or to prepare as shards
(``NpySource``), a ``torch.utils.data.DataLoader`` over the sorted file
list decodes, centre-crops and LANCZOS-resizes each image
(``pipeline.decode_image``, the JAX package's ``_DecodeResize``) in
``data.num_workers`` worker processes, started with ``spawn`` (the
training process runs threads, where ``fork`` is unsafe). The sampler
walks endless epochs, each a fresh permutation of the files drawn from a
``torch.Generator`` seeded by ``seed``: an epoch serves every file once.
The order cannot match grain's shuffle.

It serves the sources' ``batch(batch_size, res)``. One loader lives at a
time, built at the first request of a (batch size, resolution) and shut
down, with its workers, when a request of another pair (the next
progressive phase) supersedes it, or at ``close``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from ganlab_tpu_torch.data.pipeline import decode_image, list_images


class _DecodedFolder(Dataset):
    """Item i = file i decoded to (res, res, 3) uint8."""

    def __init__(self, paths: list[str], resolution: int):
        self.paths = paths
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> torch.Tensor:
        # PIL hands over a read-only array
        return torch.from_numpy(decode_image(self.paths[i],
                                             self.resolution).copy())


class EpochSampler(Sampler):
    """Endless epochs over ``n`` items, each a permutation drawn from a
    ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.generator = torch.Generator().manual_seed(seed)

    def __iter__(self):
        while True:
            yield from torch.randperm(self.n, generator=self.generator) \
                .tolist()


class StreamingImageFolderSource:
    """Streaming folder source with parallel decode workers."""

    def __init__(self, data_dir: str, resolution: int, seed: int = 0,
                 num_workers: int = 8):
        self._paths = list_images(data_dir)
        self.resolution = resolution
        self.num_images = len(self._paths)
        self._seed = seed
        self._workers = num_workers
        self._key: tuple[int, int] | None = None
        self._iter = None

    def _make_iter(self, batch_size: int, res: int):
        workers = self._workers if self._workers > 1 else 0
        loader = DataLoader(
            _DecodedFolder(self._paths, res), batch_size=batch_size,
            sampler=EpochSampler(self.num_images, self._seed),
            num_workers=workers,
            multiprocessing_context="spawn" if workers else None)
        return iter(loader)

    def batch(self, batch_size: int, res: int) -> np.ndarray:
        if res > self.resolution:
            raise ValueError(f"resolution {res} above the source's "
                             f"{self.resolution}")
        key = (batch_size, res)
        if key != self._key:
            self.close()
            self._iter, self._key = self._make_iter(batch_size, res), key
        return next(self._iter).numpy()

    def close(self) -> None:
        """Shut down the live loader's worker processes."""
        it, self._iter, self._key = self._iter, None, None
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()

"""Dataset preparation: an image folder -> per-resolution ``.npy`` shards.

Port of ``ganlab_tpu/data/prepare.py`` (same shards byte for byte).
``prepare_dataset`` decodes an image folder once (``ImageFolderSource``:
centre crop to a square, LANCZOS resize to the maximum resolution) and
writes uint8 ``images_<res>.npy`` shards, each exactly 2x box-downsampled
from the previous, so the training pipeline serves every progressive phase
from a memory-mapped exact-resolution file (``NpySource``) with no
per-batch resampling.
"""

from __future__ import annotations

import os

import numpy as np

from ganlab_tpu_torch.config import res_to_log2
from ganlab_tpu_torch.data.pipeline import ImageFolderSource, box_downsample


def prepare_dataset(src_dir: str, out_dir: str, max_res: int,
                    min_res: int = 4, limit: int | None = None) -> dict:
    """Returns {resolution: path} of the written shards."""
    res_to_log2(max_res)
    os.makedirs(out_dir, exist_ok=True)
    imgs = ImageFolderSource(src_dir, max_res, limit=limit)._images

    written = {}
    res = max_res
    cur = imgs
    while res >= min_res:
        path = os.path.join(out_dir, f"images_{res}.npy")
        np.save(path, cur)
        written[res] = path
        res //= 2
        if res >= min_res:
            cur = _bulk_downsample_2x(cur)
    return written


def _bulk_downsample_2x(imgs: np.ndarray) -> np.ndarray:
    """2x box-downsample the whole array: the threaded native library when
    built (identity gather + fused downsample), numpy otherwise."""
    from ganlab_tpu_torch.data import native

    idx = np.arange(imgs.shape[0], dtype=np.int64)
    out = native.gather(imgs, idx, 2)
    return out if out is not None else box_downsample(imgs, 2)

"""Sample-grid output (reference: torchvision.utils.save_image; SURVEY.md 2.2)."""

from __future__ import annotations

import math
import os

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """float [-1, 1] NHWC -> uint8."""
    x = np.asarray(images, np.float32)
    x = np.clip((x + 1.0) * 127.5, 0.0, 255.0)
    return x.astype(np.uint8)


def make_grid(images: np.ndarray, ncol: int | None = None,
              pad: int = 2) -> np.ndarray:
    """Tile (N, H, W, C) uint8 images into one grid image."""
    n, h, w, c = images.shape
    ncol = ncol or int(math.ceil(math.sqrt(n)))
    nrow = int(math.ceil(n / ncol))
    grid = np.zeros((nrow * (h + pad) - pad, ncol * (w + pad) - pad, c),
                    np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = images[i]
    return grid


def save_image_grid(images, path: str, ncol: int | None = None) -> str:
    """Save float [-1,1] images as a PNG grid; returns the path."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = make_grid(to_uint8(np.asarray(images)), ncol)
    Image.fromarray(grid.squeeze() if grid.shape[-1] == 1 else grid).save(path)
    return path

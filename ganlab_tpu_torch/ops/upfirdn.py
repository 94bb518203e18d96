"""Resampling ops of the StyleGAN generator, NCHW.

Port of the generator half of ``ganlab_tpu/ops/upfirdn.py``:
``upsample_nearest_2x`` and ``upsample_blur_2x`` (nearest 2x up followed by
the normalized [1,2,1] binomial blur, Karras et al. 2018 app. C). A CPU
tensor goes to the plain version, any other tensor to the CUDA kernel
``csrc/resample.cu``, which launches or raises.
"""

from __future__ import annotations

import torch

from ganlab_tpu_torch.ops.kernels.resample import (
    upsample_blur_2x_cuda,
    upsample_blur_2x_ref,
)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (ProGAN G path)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2) \
        .reshape(n, c, 2 * h, 2 * w)


def upsample_blur_2x(x: torch.Tensor) -> torch.Tensor:
    """blur([1,2,1]) of nearest_up_2x(x), with zero padding at the border."""
    if x.device.type == "cpu":
        return upsample_blur_2x_ref(x)
    return upsample_blur_2x_cuda(x)


def fade_in(alpha: float, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """lerp: old + alpha * (new - old) (progressive-growing fade)."""
    return old + alpha * (new - old)

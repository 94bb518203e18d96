"""LPIPS-style perceptual distance (Zhang et al. 2018) on a VGG16: the
distance PPL is defined over (``eval/ppl.py``).

Port of ``ganlab_tpu/eval/lpips.py``. Pretrained weights come from
``$GANLAB_LPIPS_WEIGHTS`` (a torchvision ``vgg16`` state dict: the
``features.N.{weight,bias}`` convs) when it names a file; otherwise a
deterministic random VGG16, drawn with the same ``np.random.default_rng``
calls as the JAX package's ``_random_vgg_params``, so both packages hold
the same weights (relative comparisons only, as with FID's fallback).

Distance: taps after relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 of inputs shifted and
scaled as the official LPIPS does; each tap's channels are unit-normalized,
the squared difference averaged over channels (uniform 1/C weights: the
"baseline" LPIPS, the learned "lin" weights are not available) and over
space, then summed over the taps. Inputs below 32 px (VGG16's five pools
need 32) are first resized bilinearly to 32 (``F.interpolate``,
``align_corners=False``, which is ``jax.image.resize``'s bilinear up to
rounding). NCHW images in [-1, 1]; the convs are ``F.conv2d`` (cuDNN on
the card, as the JAX package leaves them to XLA).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

LPIPS_WEIGHTS_ENV = "GANLAB_LPIPS_WEIGHTS"

# torchvision vgg16.features: conv widths, 'M' = 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]
_TAP_CONVS = (1, 3, 6, 9, 12)     # taps after these convs' relu (of 13)
_TORCH_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SHIFT = (-0.030, -0.088, -0.188)  # the official LPIPS input scaling
_SCALE = (0.458, 0.448, 0.450)


def random_vgg_params(seed: int = 0) -> dict[str, torch.Tensor]:
    """Deterministic He-initialized VGG16 conv stack (OIHW): the JAX
    package's ``_random_vgg_params(seed)``, transposed from HWIO."""
    rng = np.random.default_rng(seed)
    params, cin, i = {}, 3, 0
    for v in _VGG_CFG:
        if v == "M":
            continue
        w = rng.standard_normal((3, 3, cin, v)).astype(np.float32)
        # the product rounded to float32, as jnp.asarray rounds it
        w = (w * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        params[f"w{i}"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        params[f"b{i}"] = torch.zeros(v)
        cin, i = v, i + 1
    return params


def load_torch_vgg16(path: str) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict -> the conv stack's parameters."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for i, ti in enumerate(_TORCH_IDX):
        params[f"w{i}"] = sd[f"features.{ti}.weight"].float().contiguous()
        params[f"b{i}"] = sd[f"features.{ti}.bias"].float().contiguous()
    return params


def vgg_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """Tap activations of NCHW images in [-1, 1] (float32, >= 32 px)."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats, i = [], 0
    for v in _VGG_CFG:
        if v == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(F.conv2d(h, params[f"w{i}"], params[f"b{i}"],
                            padding=1))
        if i in _TAP_CONVS:
            feats.append(h)
        i += 1
    return feats


def lpips_distance(params: dict, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """(B,) perceptual distances between NCHW image batches in [-1, 1]."""
    x, y = x.float(), y.float()
    if x.shape[2] < 32:
        x = F.interpolate(x, size=(32, 32), mode="bilinear",
                          align_corners=False)
        y = F.interpolate(y, size=(32, 32), mode="bilinear",
                          align_corners=False)
    total = 0.0
    for a, b in zip(vgg_features(params, x), vgg_features(params, y)):
        na = a * torch.rsqrt(a.square().sum(1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt(b.square().sum(1, keepdim=True) + 1e-10)
        total = total + (na - nb).square().mean(dim=(1, 2, 3))
    return total


class LPIPSDistance:
    """Callable (x, y) -> numpy (B,) distances of NCHW image batches, on
    ``device`` (the GPU unless the caller asks for the CPU)."""

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        path = weights_path or os.environ.get(LPIPS_WEIGHTS_ENV)
        self.pretrained = bool(path and os.path.exists(path))
        params = load_torch_vgg16(path) if self.pretrained \
            else random_vgg_params(seed)
        self.device = torch.device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.name = "lpips_vgg16" if self.pretrained \
            else "lpips_vgg16_random"

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            d = lpips_distance(self.params, x.to(self.device),
                               y.to(self.device))
        return d.cpu().numpy()

"""InceptionV3 (the FID pool3 variant) as a PyTorch module.

Port of ``ganlab_tpu/eval/inception.py``: pytorch-fid's ``FIDInception*``
blocks (torchvision's inception_v3 with TF's pooling: average pools that
exclude the padding in the A, C and E blocks, a max pool for Mixed_7c's
branch pool). Submodules carry torchvision's ``state_dict`` names
(``Mixed_5b.branch1x1.conv.weight``, ``....bn.running_var``), so a
torchvision or pytorch-fid weights file loads by name. Inference only:
the batch norms apply their stored statistics (eps 1e-3).

Without weights the network is built with the JAX package's random init
(numpy He-normal from seed 0, identity batch norms), the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# convs without padding; every other conv pads (kh // 2, kw // 2)
_VALID = {"Conv2d_1a_3x3": 2, "Conv2d_2a_3x3": 1, "Conv2d_4a_3x3": 1,
          "Mixed_6a.branch3x3": 2, "Mixed_6a.branch3x3dbl_3": 2,
          "Mixed_7a.branch3x3_2": 2, "Mixed_7a.branch7x7x3_4": 2}


def inception_spec() -> list[tuple[str, int, int, int, int]]:
    """(name, in_ch, out_ch, kh, kw) of every BasicConv2d, in order."""
    spec = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]

    def a(prefix, cin, pool):
        return [
            (f"{prefix}.branch1x1", cin, 64, 1, 1),
            (f"{prefix}.branch5x5_1", cin, 48, 1, 1),
            (f"{prefix}.branch5x5_2", 48, 64, 5, 5),
            (f"{prefix}.branch3x3dbl_1", cin, 64, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{prefix}.branch_pool", cin, pool, 1, 1),
        ]

    def c(prefix, c7):
        return [
            (f"{prefix}.branch1x1", 768, 192, 1, 1),
            (f"{prefix}.branch7x7_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7_2", c7, c7, 1, 7),
            (f"{prefix}.branch7x7_3", c7, 192, 7, 1),
            (f"{prefix}.branch7x7dbl_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_5", c7, 192, 1, 7),
            (f"{prefix}.branch_pool", 768, 192, 1, 1),
        ]

    def e(prefix, cin):
        return [
            (f"{prefix}.branch1x1", cin, 320, 1, 1),
            (f"{prefix}.branch3x3_1", cin, 384, 1, 1),
            (f"{prefix}.branch3x3_2a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3_2b", 384, 384, 3, 1),
            (f"{prefix}.branch3x3dbl_1", cin, 448, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 448, 384, 3, 3),
            (f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{prefix}.branch_pool", cin, 192, 1, 1),
        ]

    spec += a("Mixed_5b", 192, 32)
    spec += a("Mixed_5c", 256, 64)
    spec += a("Mixed_5d", 288, 64)
    spec += [
        ("Mixed_6a.branch3x3", 288, 384, 3, 3),
        ("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1),
        ("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3),
    ]
    spec += c("Mixed_6b", 128) + c("Mixed_6c", 160)
    spec += c("Mixed_6d", 160) + c("Mixed_6e", 192)
    spec += [
        ("Mixed_7a.branch3x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch3x3_2", 192, 320, 3, 3),
        ("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
        ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
        ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3),
    ]
    spec += e("Mixed_7b", 1280) + e("Mixed_7c", 2048)
    return spec


class BasicConv2d(nn.Module):
    """conv (no bias) -> frozen batch norm (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int, stride: int,
                 padding: tuple[int, int]):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_excl(x):
    """3x3 SAME average pool dividing by the window inside the image."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """NCHW in [-1, 1] at any size -> (N, 3, 299, 299): one channel
    repeated to three, bilinear resize with half-pixel centres and no
    antialiasing (pytorch-fid's ``F.interpolate``; the JAX package's
    ``jax.image.resize(antialias=False)``)."""
    x = images.float()
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    if x.shape[2:] != (299, 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False)
    return x


class InceptionExtractor(nn.Module):
    """Pool3 features: NCHW in [-1, 1] -> (N, 2048) float32."""

    name = "inception_v3_pool3"
    dim = 2048

    def __init__(self, weights_path: str | None = None,
                 state_dict: dict | None = None):
        super().__init__()
        for name, cin, cout, kh, kw in inception_spec():
            stride = _VALID.get(name)
            layer = BasicConv2d(cin, cout, kh, kw, stride or 1,
                                (0, 0) if stride else (kh // 2, kw // 2))
            *parents, leaf = name.split(".")
            node = self
            for p in parents:
                if not hasattr(node, p):
                    node.add_module(p, nn.Module())
                node = getattr(node, p)
            node.add_module(leaf, layer)
        if weights_path:
            state_dict = torch.load(weights_path, map_location="cpu",
                                    weights_only=True)
            if "state_dict" in state_dict:
                state_dict = state_dict["state_dict"]
        self.pretrained = state_dict is not None
        if state_dict is None:
            self._random_init()
        else:
            self._load(state_dict)
        self.eval()

    def _random_init(self, seed: int = 0) -> None:
        """The JAX package's ``init_inception_params``: He-normal weights
        from numpy's generator, identity batch norms."""
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for name, cin, cout, kh, kw in inception_spec():
                w = rng.standard_normal((kh, kw, cin, cout)) \
                    .astype(np.float32) * np.sqrt(2.0 / (cin * kh * kw))
                layer = self.get_submodule(name)
                layer.conv.weight.copy_(torch.from_numpy(
                    w.transpose(3, 2, 0, 1).copy()))
                layer.bn.reset_parameters()

    def _load(self, sd: dict) -> None:
        """Take each BasicConv2d's tensors from a torchvision / pytorch-fid
        state dict by name; other keys (the classifier) are ignored."""
        with torch.no_grad():
            for name, cin, cout, kh, kw in inception_spec():
                layer = self.get_submodule(name)
                w = sd[f"{name}.conv.weight"]
                if tuple(w.shape) != (cout, cin, kh, kw):
                    raise ValueError(f"{name}.conv.weight has shape "
                                     f"{tuple(w.shape)}")
                layer.conv.weight.copy_(w)
                for key in ("weight", "bias", "running_mean", "running_var"):
                    getattr(layer.bn, key).copy_(sd[f"{name}.bn.{key}"])

    def _block_a(self, m, x):
        b1 = m.branch1x1(x)
        b5 = m.branch5x5_2(m.branch5x5_1(x))
        b3 = m.branch3x3dbl_3(m.branch3x3dbl_2(m.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, b3, m.branch_pool(_avg_excl(x))], 1)

    def _block_b(self, m, x):
        b3 = m.branch3x3(x)
        bd = m.branch3x3dbl_3(m.branch3x3dbl_2(m.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)

    def _block_c(self, m, x):
        b1 = m.branch1x1(x)
        b7 = m.branch7x7_3(m.branch7x7_2(m.branch7x7_1(x)))
        bd = m.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(m, f"branch7x7dbl_{i}")(bd)
        return torch.cat([b1, b7, bd, m.branch_pool(_avg_excl(x))], 1)

    def _block_d(self, m, x):
        b3 = m.branch3x3_2(m.branch3x3_1(x))
        b7 = m.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(m, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)

    def _block_e(self, m, x, pool: str):
        b1 = m.branch1x1(x)
        b3 = m.branch3x3_1(x)
        b3 = torch.cat([m.branch3x3_2a(b3), m.branch3x3_2b(b3)], 1)
        bd = m.branch3x3dbl_2(m.branch3x3dbl_1(x))
        bd = torch.cat([m.branch3x3dbl_3a(bd), m.branch3x3dbl_3b(bd)], 1)
        # pytorch-fid's FIDInceptionE_2 (Mixed_7c): TF max-pools here
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if pool == "max" \
            else _avg_excl(x)
        return torch.cat([b1, b3, bd, m.branch_pool(bp)], 1)

    def pool3(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) already preprocessed -> (N, 2048)."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(getattr(self, name), x)
        x = self._block_b(self.Mixed_6a, x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(getattr(self, name), x)
        x = self._block_d(self.Mixed_7a, x)
        x = self._block_e(self.Mixed_7b, x, pool="avg")
        x = self._block_e(self.Mixed_7c, x, pool="max")
        return x.mean(dim=(2, 3))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NCHW in [-1, 1] at any size -> (N, 2048) float32."""
        return self.pool3(preprocess(images))

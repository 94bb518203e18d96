"""Convert a flax parameter tree of the JAX package into a port state_dict.

``from_flax(params)`` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` gives (with or without the
top-level ``"params"`` key) and returns the ``state_dict`` of the port's
module with the same names: ``"a/b/c"`` becomes ``"a.b.c"``. It covers the
StyleGAN generator and the ProGAN discriminator. Layouts:

* conv weights HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw);
* the constant input (1, H, W, C) -> (1, C, H, W);
* dense weights (in, out) and every 1-d leaf stay as they are (the D's
  output block flattens its 4x4 map in the JAX package's (h, w, c) order,
  so ``block4_out.dense.w`` needs no reordering).

Values are float32 (parameters stay float32 in both packages).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, v


def from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax tree -> the port's ``state_dict`` (see module docstring)."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for name, leaf in _flatten(params):
        a = np.asarray(leaf, dtype=np.float32)
        last = name.rsplit(".", 1)[-1]
        if a.ndim == 4 and last == "w":
            a = a.transpose(3, 2, 0, 1)            # HWIO -> OIHW
        elif a.ndim == 4 and last == "const":
            a = a.transpose(0, 3, 1, 2)            # NHWC -> NCHW
        elif a.ndim not in (1, 2):
            raise ValueError(f"unexpected leaf {name} of shape {a.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def is_flax_tree(params: Mapping[str, Any]) -> bool:
    """True for a nested (flax-style) tree, False for a flat state_dict."""
    return any(isinstance(v, Mapping) for v in params.values())

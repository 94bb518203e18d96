"""Convert a flax parameter tree of the JAX package into a port state_dict.

``from_flax(params)`` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` gives (with or without the
top-level ``"params"`` key) and returns the ``state_dict`` of the port's
module with the same names: ``"a/b/c"`` becomes ``"a.b.c"``. It covers the
StyleGAN, StyleGAN2 and ProGAN generators, the ProGAN discriminator (with
residual blocks too) and both ResNet-GAN nets. Layouts:

* conv weights HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw);
* the constant input (1, H, W, C) -> (1, C, H, W);
* dense weights (in, out) and every 1-d leaf stay as they are: the ProGAN
  D's output block flattens its 4x4 map in the JAX package's (h, w, c)
  order, and the ProGAN G's ``block4.dense`` and the ResNet G's ``dense``
  reshape their output in that order before the permute to NCHW, so no
  dense weight needs reordering.

Values are float32 (parameters stay float32 in both packages).

``load_jax_train_state(state, arrays, cfg)`` carries a whole JAX ``TrainState``
(parameters of G, D and G-EMA, both Adam states, w-average, counters) into
the port's ``TrainState``. ``aug_params_from_arrays(arrays)`` turns the JAX
``sample_params`` output into the port's ``AugParams``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ganlab_tpu_torch.train.state import step_count


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


def load_jax_train_state(state, arrays: Mapping[str, Any], cfg):
    """Fill the port's ``TrainState`` from a JAX ``TrainState`` given as
    numpy arrays; returns ``state``.

    ``arrays`` holds ``params_g`` / ``params_d`` / ``params_ema`` (flax
    trees), ``opt_g`` / ``opt_d`` (each ``{"count", "mu", "nu"}``: optax's
    Adam step count and its two moment trees, shaped like the parameters),
    ``w_avg``, ``step`` and ``shown_imgs``, and ``pl_mean`` / ``ada_p``
    where the JAX state has them (path-length regularization, adaptive
    augmentation). optax keeps one count and a
    moment for every leaf; the same is written for every parameter here,
    so the next Adam update of the two packages agrees. The JAX PRNG key is
    not carried: torch's streams are not JAX's. A port state with a
    ``pl_mean`` takes the JAX one, or a fresh 0 where the JAX state has
    none, as the JAX package's checkpoint migration does; one with an
    ``ada_p`` takes the JAX one, or keeps its own where the JAX state has
    none.

    ``opt_step0`` (the step at which the moments began) follows from D's
    Adam count and the run's ``cfg``: step - count, or under
    ``loss.reg_separate``, whose count also holds the penalty steps since
    then (two D updates on each), the start s0 with
    (step - s0) + ``penalty_ticks(cfg, s0, step)`` = count.
    """
    for module, key in ((state.g, "params_g"), (state.d, "params_d"),
                        (state.g_ema, "params_ema")):
        module.load_state_dict(from_flax(arrays[key]))
    for opt, module, key in ((state.opt_g, state.g, "opt_g"),
                             (state.opt_d, state.d, "opt_d")):
        saved = arrays[key]
        mu, nu = from_flax(saved["mu"]), from_flax(saved["nu"])
        opt.state.clear()
        for name, p in module.named_parameters():
            opt.state[p] = {
                "step": step_count(opt, p, int(saved["count"])),
                "exp_avg": mu[name].to(p.device),
                "exp_avg_sq": nu[name].to(p.device)}
    with torch.no_grad():
        state.w_avg.copy_(torch.from_numpy(
            np.asarray(arrays["w_avg"], dtype=np.float32)))
        if state.pl_mean is not None:
            saved = arrays.get("pl_mean")
            state.pl_mean.fill_(0.0 if saved is None else float(
                np.asarray(saved, dtype=np.float32)))
        if state.ada_p is not None and arrays.get("ada_p") is not None:
            state.ada_p.fill_(float(np.asarray(arrays["ada_p"],
                                               dtype=np.float32)))
    state.step = int(arrays["step"])
    state.shown_imgs = int(arrays["shown_imgs"])
    # the moments' count and the step counter start together in a JAX
    # run; D's Adam steps every step (G's only every n-th with n-critic)
    state.opt_step0 = _moments_start(state.step,
                                     int(arrays["opt_d"]["count"]), cfg)
    return state


def _moments_start(step: int, count: int, cfg) -> int:
    """The step s0 at which D's moments began, from D's Adam ``count`` at
    ``step``. Under ``loss.reg_separate`` with penalty_every k the count is
    (step - s0) + ceil(step/k) - ceil(s0/k), so s0 + ceil(s0/k) = T for
    T = step + ceil(step/k) - count; s0 + ceil(s0/k) takes the value
    q(k + 1) at s0 = qk and q(k + 1) + r + 1 at s0 = qk + r (0 < r < k),
    and never q(k + 1) + 1."""
    lc = cfg.loss
    if not (lc.reg_separate and lc.penalty in ("wgan-gp", "r1")):
        return step - count
    k = max(lc.penalty_every, 1)
    q, m = divmod(step - (-step // k) - count, k + 1)
    if m == 1:
        raise ValueError(f"load_jax_train_state: D's Adam count {count} at "
                         f"step {step} fits no start of the moments under "
                         f"loss.reg_separate")
    return q * k + max(m - 1, 0)


def aug_params_from_arrays(arrays: Mapping[str, Any]):
    """The port's ``AugParams`` of the JAX ``sample_params`` output given as
    a mapping of numpy arrays (``params._asdict()``): the same transforms,
    integers as int64, the noise field from NHWC to NCHW. jax.random and
    torch streams cannot match, so this is how both packages are fed the
    same augmentation."""
    from ganlab_tpu_torch.ops.augment import AugParams

    out = {}
    for f in dataclasses.fields(AugParams):
        v = arrays.get(f.name)
        if v is not None:
            a = np.asarray(v)
            if f.name == "noise":
                a = a.transpose(0, 3, 1, 2)           # NHWC -> NCHW
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            v = torch.from_numpy(np.array(a))
        out[f.name] = v
    return AugParams(**out)


def is_flax_tree(params: Mapping[str, Any]) -> bool:
    """True for a nested (flax-style) tree, False for a flat state_dict."""
    return any(isinstance(v, Mapping) for v in params.values())

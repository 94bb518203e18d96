"""Crash-safe checkpoint and bitwise resume of the training state.

Port of ``ganlab_tpu/train/checkpoint.py`` (orbax there) on ``torch.save``.
One file per step, ``<directory>/ckpt_<step:08d>.pt``, holds plain tensors
and numbers only: the state dicts of G, D and G-EMA, both Adam states, the
w-average, the path-length mean and the augmentation strength where the
state has them (``pl_mean``, ``ada_p``), the counters (``step``,
``shown_imgs``, ``opt_step0``) and the state of the generator that makes
a step's random draws. The schedule position is not stored: phase and
fade-in alpha derive from ``shown_imgs`` and the lazy-regularization
cadence from ``step``, so a restored state continues bit for bit
(``tests/test_torch_checkpoint.py``).

A save is synchronous (``wait`` is a no-op: when ``save`` returns the file
is complete): the payload is written to a temporary name in the same
directory and ``os.replace``d, so a reader sees a whole checkpoint or none,
and a leftover temporary file of a crashed save is ignored. The newest
``keep`` steps stay. ``restore`` loads with ``weights_only=True`` onto the
host and copies into the state it fills, wherever that lies, so a
checkpoint written on the card loads on the CPU and back (Adam's step
counts land where the optimizer wants them: on the card where it is
``capturable``, on the host otherwise, the flag kept as the state was
made; ``train/state.py::fit_optimizer``). A
``torch.Generator``'s state belongs to its device type: restored onto the
other type, the draws continue from a generator seeded from the saved seed
and step instead (deterministic, but another stream).

``pl_mean`` and ``ada_p`` migrate as in the JAX package: a checkpoint
without ``pl_mean`` resumes into a path-length configuration with a fresh
0, one without ``ada_p`` into an ADA configuration with the state's own
value (``aug.p_init`` in a state fresh from ``create_train_state``, the
JAX package's template value), and a checkpoint with either resumes into a
configuration without the feature by dropping it.
"""

from __future__ import annotations

import os
import re

import torch

from ganlab_tpu_torch.train.state import TrainState, fit_optimizer

_NAME = re.compile(r"^ckpt_(\d{8,})\.pt$")
_FORMAT = 1
_MODULES = ("g", "d", "g_ema")
_OPTIMIZERS = ("opt_g", "opt_d")


def state_payload(state: TrainState) -> dict:
    """The checkpoint's content: plain tensors (on the state's device: they
    are not copied) and numbers."""
    gen = state.generator
    # pl_mean and ada_p only where the state has them, as the JAX
    # package's None leaves
    optional = {k: getattr(state, k) for k in ("pl_mean", "ada_p")
                if getattr(state, k) is not None}
    return {
        "format": _FORMAT,
        **{k: getattr(state, k).state_dict() for k in _MODULES + _OPTIMIZERS},
        "w_avg": state.w_avg,
        **optional,
        "step": int(state.step),
        "shown_imgs": int(state.shown_imgs),
        "opt_step0": int(state.opt_step0),
        "generator": {"device": gen.device.type,
                      "seed": int(gen.initial_seed()),
                      "state": gen.get_state()},
    }


def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Fill ``state`` in place from a payload; returns it."""
    if payload.get("format") != _FORMAT:
        raise ValueError(f"checkpoint format {payload.get('format')!r}, "
                         f"expected {_FORMAT}")
    for k in _MODULES:
        getattr(state, k).load_state_dict(payload[k])
    for k in _OPTIMIZERS:
        opt = getattr(state, k)
        capturable = opt.param_groups[0]["capturable"]
        opt.state.clear()       # load_state_dict keeps nothing of the old
        opt.load_state_dict(payload[k])
        fit_optimizer(opt, capturable)
    with torch.no_grad():
        state.w_avg.copy_(payload["w_avg"])
        saved_pl = payload.get("pl_mean")
        if state.pl_mean is not None and saved_pl is None:
            state.pl_mean.zero_()
        elif state.pl_mean is not None:
            state.pl_mean.copy_(saved_pl)
        if state.ada_p is not None and payload.get("ada_p") is not None:
            state.ada_p.copy_(payload["ada_p"])
    state.step = int(payload["step"])
    state.shown_imgs = int(payload["shown_imgs"])
    state.opt_step0 = int(payload["opt_step0"])
    saved = payload["generator"]
    if saved["device"] == state.generator.device.type:
        state.generator.set_state(saved["state"].cpu())
    else:
        state.generator.manual_seed(
            (saved["seed"] + 0x9E3779B9 * (state.step + 1)) % (2 ** 63))
    return state


class CheckpointManager:
    """Keep-last-k checkpoints of a ``TrainState`` in one directory."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step:08d}.pt")

    def save(self, step: int, state: TrainState) -> None:
        final = self.path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        try:
            torch.save(state_payload(state), tmp)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if self._keep and self._keep > 0:
            for old in self.steps()[:-self._keep]:
                os.remove(self.path(old))

    def restore(self, state_like: TrainState,
                step: int | None = None) -> TrainState | None:
        """Fill ``state_like`` from the latest (or a given) checkpoint and
        return it; None, with ``state_like`` untouched, when there is no
        checkpoint."""
        payload = self.load(step)
        if payload is None:
            return None
        return load_payload(state_like, payload)

    def load(self, step: int | None = None) -> dict | None:
        """The latest (or a given) checkpoint's content on the host (see
        ``state_payload``); None when there is no checkpoint."""
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        return torch.load(self.path(target), weights_only=True,
                          map_location="cpu")

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def steps(self) -> list[int]:
        """All retained checkpoint steps, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        """Holds no open resource; kept for the JAX package's interface."""

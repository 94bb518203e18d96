"""Learner-style API, mirroring the reference's orchestration classes.

Port of ``ganlab_tpu/learners.py``: each learner is a thin veneer over the
``Trainer`` with train / checkpoint / sample methods, for users who come
from the reference's ``ResNetGANLearner`` / ``ProGANLearner`` /
``StyleGANLearner`` objects (defaults: ``resnetgan-cifar10``,
``progan-128``, ``stylegan-256``).
"""

from __future__ import annotations

import torch

from ganlab_tpu_torch.config import Config, get_config
from ganlab_tpu_torch.train.loop import Trainer


class Learner:
    """Base learner: wraps a Trainer with reference-flavored methods."""

    DEFAULT_PRESET: str = "stylegan-256"
    MODEL: str | None = None

    def __init__(self, config: Config | None = None, workdir: str = ".",
                 device: str | torch.device = "cuda", **overrides):
        if config is None:
            config = get_config(self.DEFAULT_PRESET, **overrides)
        elif overrides:
            raise ValueError("pass either a Config or overrides, not both")
        if self.MODEL and config.model.model != self.MODEL:
            raise ValueError(
                f"{type(self).__name__} expects model={self.MODEL!r}, "
                f"config has {config.model.model!r}")
        self.trainer = Trainer(config, workdir=workdir, device=device)

    # -- reference-surface methods ------------------------------------
    @property
    def config(self) -> Config:
        return self.trainer.cfg

    @property
    def state(self):
        return self.trainer.state

    def train(self, max_steps: int | None = None):
        """The alternating G/D loop over the progressive schedule."""
        return self.trainer.train(max_steps=max_steps)

    def save_model(self) -> None:
        """Checkpoint G, D, G-EMA, optimizers and schedule position."""
        self.trainer.save_checkpoint()
        self.trainer.ckpt.wait()

    def load_model(self) -> bool:
        """Restore the latest checkpoint; True if one existed. Cached
        steppers are dropped so their lazy-regularization counters re-seed
        from the restored optimizer step."""
        trainer = self.trainer
        if trainer.ckpt.restore(trainer.state) is None:
            return False
        trainer._steps.clear()
        return True

    def gen_samples(self, tag: str = "samples",
                    psi: float | None = None) -> str:
        """Save a fixed-z image grid from G-EMA (truncation for StyleGAN)."""
        return self.trainer.save_samples(tag=tag, psi=psi)

    def close(self) -> None:
        self.trainer.close()


class ResNetGANLearner(Learner):
    DEFAULT_PRESET = "resnetgan-cifar10"
    MODEL = "resnetgan"


class ProGANLearner(Learner):
    DEFAULT_PRESET = "progan-128"
    MODEL = "progan"


class StyleGANLearner(Learner):
    DEFAULT_PRESET = "stylegan-256"
    MODEL = "stylegan"

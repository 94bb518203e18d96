"""Training of the PyTorch port: state, schedule and the lazy-R1 step.

Entry: ``create_train_state(cfg, seed, device="cuda")`` ->
``make_lazy_stepper(cfg, phase)`` -> ``stepper(state, real_u8)``, with the
phase from ``build_phases(cfg.schedule, cfg.model)``.
"""

from ganlab_tpu_torch.train.schedule import PhaseSpec, build_phases
from ganlab_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizers,
)
from ganlab_tpu_torch.train.steps import build_train_step, make_lazy_stepper

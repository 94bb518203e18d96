"""Training of the PyTorch port: state, schedule, the lazy-R1 step, the
checkpoints and the progressive ``Trainer``.

Entry: ``Trainer(cfg, workdir, device="cuda").train()``; or by hand,
``create_train_state(cfg, seed, device="cuda")`` ->
``make_lazy_stepper(cfg, phase)`` -> ``stepper(state, real_u8)``, with the
phase from ``build_phases(cfg.schedule, cfg.model)``.
"""

from ganlab_tpu_torch.train.checkpoint import CheckpointManager
from ganlab_tpu_torch.train.loop import Trainer
from ganlab_tpu_torch.train.schedule import (
    PhaseSpec,
    alpha_at,
    build_phases,
    phase_at,
)
from ganlab_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizers,
    reset_moments,
    state_tensors,
)
from ganlab_tpu_torch.train.steps import build_train_step, make_lazy_stepper

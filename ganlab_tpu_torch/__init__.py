"""ganlab_tpu_torch — the PyTorch / CUDA port of ``ganlab_tpu`` for Hopper.

The JAX package ``ganlab_tpu`` stays the reference; this package re-homes
its paths in PyTorch, one slice at a time, with every TPU (Pallas) kernel
on a ported path rewritten by hand for the H100 (CUDA C++ under ``csrc``,
wrapped in ``ops/kernels``). It imports ``torch`` and numpy, never
``jax``/``flax`` and nothing of ``ganlab_tpu``.

Ported so far: G-EMA serving (``BatchSampler``, the exported sampler),
the training step (``create_train_state`` -> ``make_lazy_stepper``, with
ADA augmentation, gradient accumulation and data parallelism) and the
progressive trainer with its checkpoints, data sources, evaluation (FID /
KID / PR, PPL), profiling and command line (``Trainer``, the three
learners, ``python -m ganlab_tpu_torch.cli train|prepare-data|sample|
interpolate|mixgrid|eval-fid|eval-ppl|export|project``) for StyleGAN,
StyleGAN2, ProGAN and ResNet-GAN (all six presets). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper computes its plain PyTorch version, on a CUDA tensor it
launches the kernel or raises.
"""

__version__ = "0.1.0"

_API = {
    "Config": "ganlab_tpu_torch.config",
    "get_config": "ganlab_tpu_torch.config",
    "build_generator": "ganlab_tpu_torch.models",
    "build_models": "ganlab_tpu_torch.models",
    "create_train_state": "ganlab_tpu_torch.train",
    "make_lazy_stepper": "ganlab_tpu_torch.train",
    "build_phases": "ganlab_tpu_torch.train",
    "Trainer": "ganlab_tpu_torch.train",
    "CheckpointManager": "ganlab_tpu_torch.train",
    "StyleGANLearner": "ganlab_tpu_torch.learners",
    "ProGANLearner": "ganlab_tpu_torch.learners",
    "ResNetGANLearner": "ganlab_tpu_torch.learners",
    "BatchSampler": "ganlab_tpu_torch.serve",
    "from_flax": "ganlab_tpu_torch.convert",
}


def __getattr__(name):
    """Lazy top-level API (PEP 562): no torch import at package import."""
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

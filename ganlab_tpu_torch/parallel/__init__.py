"""Data parallelism of the PyTorch port: one process a card over
``torch.distributed`` (``parallel/dist.py``), the counterpart of
``ganlab_tpu/parallel/mesh.py``."""

from ganlab_tpu_torch.parallel import dist

__all__ = ["dist"]

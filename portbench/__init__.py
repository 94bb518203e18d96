"""The benchmark of ganlab_tpu_torch on NVIDIA GPUs (see run.py)."""

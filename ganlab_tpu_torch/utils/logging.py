"""Metric logging: stdout + JSONL (port of ``ganlab_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    """Appends one JSON object per ``log`` call to ``<log_dir>/<name>.jsonl``
    and echoes it to stdout. TensorBoard scalars are not ported
    (ROADMAP.md A.5): ``tensorboard=True`` raises."""

    def __init__(self, log_dir: str | None = None, name: str = "train",
                 tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "run.tensorboard is not ported to PyTorch yet (ROADMAP.md "
                "A.5); the JSONL record holds the same scalars")
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, echo: bool = True) -> None:
        row = {"step": step, "time": round(time.time() - self._t0, 3)}
        row.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in row.items()
                             if k != "time")
            print(f"[{row['time']:9.1f}s] {parts}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

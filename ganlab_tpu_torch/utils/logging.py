"""Metric logging: stdout + JSONL (port of ``ganlab_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    """Appends one JSON object per ``log`` call to ``<log_dir>/<name>.jsonl``
    and echoes it to stdout. With ``tensorboard=True`` every float of a row
    but its time also goes to TensorBoard event files under
    ``<log_dir>/tb`` (``torch.utils.tensorboard.SummaryWriter``, imported
    only then); without the ``tensorboard`` package that is skipped, as the
    JAX package's logger skips it without ``tensorflow``."""

    def __init__(self, log_dir: str | None = None, name: str = "train",
                 tensorboard: bool = False):
        self._fh = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    pass
                else:
                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, echo: bool = True) -> None:
        row = {"step": step, "time": round(time.time() - self._t0, 3)}
        row.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, float) and k != "time":
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in row.items()
                             if k != "time")
            print(f"[{row['time']:9.1f}s] {parts}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

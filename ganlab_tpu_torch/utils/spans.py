"""Named host spans at the program's boundaries, recorded by the profiler.

``span(name)`` marks a stretch of host work as a named range of the
profiler while one records (the trainer's ``run.profile``, or any
``torch.profiler.profile`` around the calls), so that the spans sit in the
profiler's trace on the clock of its device activities, and each kernel,
copy or idle gap of the device can be tied to the span whose host code
launched it or left the device waiting. With no profiler recording it
returns one shared null context, at the cost of a flag check.

A span is recorded as a host op (``_RecordFunctionFast``), not as a user
annotation (``record_function``): the profiler gives each user annotation
that encloses device work a copy on the device's timeline, which a reader
of device activity would have to tell apart from the kernels.

The spans (``SPANS``) and where they are opened:

* ``serve.generate``: ``ExportedSampler.generate`` / ``BatchSampler.
  generate``, the whole call; inside it, per batch, ``serve.inputs`` (the
  latents, the noise generator and maps, z and psi to the device),
  ``serve.forward`` (the host's issue of the G forward and its uint8
  conversion), ``serve.copy`` (the wait for the forward and the copy to
  the host), inside it ``serve.alloc`` (the allocation of the batch's host
  array: page-locked on the card, from torch's host cache, so
  microseconds where the cache holds a free block), and once a call
  ``serve.assemble`` (the concatenation of the batches where there are
  several);
* ``step.reg`` / ``step.pl`` / ``step.plain``: one eager call of a
  training step (``train/steps.py::build_train_step``): ``step.reg``
  where a D penalty fires in it (with or without a path-length term),
  ``step.pl`` where only the path-length term fires, ``step.plain`` where
  nothing does;
* ``graph.replay``: the replay of a graphed off-run
  (``train/graphs.py::OffRunGraphs.replay``) with its input copies and
  the copies of its metrics, and the capture where one happens;
* ``train.chunk``: one call of the chunked stepper;
* ``train.data``, ``train.log``, ``train.checkpoint``, ``train.sample``,
  ``train.eval``: the ``Trainer``'s waits for the next batch, the device
  sync of a logged row, a checkpoint, a sample grid and an evaluation.

No span opens inside a model's forward or inside a module that
``torch.export`` traces.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

SPANS = ("serve.generate", "serve.inputs", "serve.forward", "serve.copy",
         "serve.alloc", "serve.assemble", "step.reg", "step.pl",
         "step.plain", "graph.replay", "train.chunk", "train.data",
         "train.log", "train.checkpoint", "train.sample", "train.eval")

_NULL = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a profiler records; otherwise a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NULL

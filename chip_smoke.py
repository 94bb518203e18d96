#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training-step, progressive-trainer and
user-data paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only    # phases 1-3, no result lines

Phases (any failure raises and the script exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA C++ kernels from ``ganlab_tpu_torch/csrc``
   with nvcc, all sources at once (build time and ``-Xptxas -v`` output).
3. Kernels: each hand-written kernel against its plain PyTorch version at
   every shape the stylegan-256 serving path (pixelnorm, AdaIN, up+blur)
   and training step (all five) give it at batch 32 (the progressive
   phases' steps use the same shapes), at every shape of a stylegan-1024
   R1-off step at its batch of 4 (512x512 and 1024x1024 planes; AdaIN's
   loop path) and of a served batch of 16 at 1024x1024, and at a few odd
   shapes, in float32 (TF32 off) and bfloat16, with the path each call
   took; mbstd on both its paths, with the batch held
   in registers and read twice, bit-equal across two calls and with fewer
   blocks than its cluster of 8; the resample kernels also
   with a gain, and each one's vector path against its element path bit
   for bit; AdaIN on each of its paths, at an unaligned pointer, on
   constant planes and on planes with a large mean, and with one block
   against a thread block cluster per 256² plane. Then kernel, plain and
   one library call timed with CUDA events around back-to-back calls
   (``ms``), beside the bound (bytes / 3.35 TB/s or flops / 67 TFLOP/s,
   the larger); the kernel and the
   library call also on the device alone (``device_ms``, a CUDA-graph
   replay of the same calls) and on the host alone (``host_us``, wall
   time per un-synchronised call). Sums per served batch and per R1-off
   training step of each preset. Then up+blur, blur+down and AdaIN on
   tensors of 2^31 elements: first and last planes against the plain
   version, so that an offset that wraps at 32 bits shows.
4. Gradients: each autograd Function's gradient against autograd through
   its plain version on the card (float32); the resample Functions'
   backwards must each be one device kernel (the gain rides in the
   kernel's store); then a second-order R1-shaped derivative through the
   resample and mbstd Functions, against the same chain of plain versions.
5. Serving: ``BatchSampler`` at the full stylegan-256 widths (bf16, batch
   32, seeded random weights with every term made live) serves a few
   requests; the launch counters must show 1 pixelnorm, 14 AdaIN and
   6 up+blur launches per batch; two images in float32 on the card are
   held against the same inputs on the CPU; img/s, latency and a profile.
6. Training: ``create_train_state`` -> ``make_lazy_stepper`` at the
   ``bench.py`` configuration (stylegan-256, fixed 256², batch 32, bf16,
   lazy R1 every 16 steps) for 34 steps, three of them R1-on; every step's
   launch counts must equal those derived from the config and the model
   structure; losses finite, parameters, G-EMA and w-avg moved, shown
   images counted; ms per R1-off and R1-on step, img/s over a 16-step
   cycle, peak memory and a profile of one R1-on and one R1-off step. Then
   one R1-on step of a narrow 32² model in float32, on the card and on the
   CPU from the same state and draws: losses and every gradient leaf agree.
7. Trainer: ``cli train --preset stylegan-256`` into a temporary workdir
   on the ``ellipses`` source, at full width, through the preset's own 11
   phases 8x8 -> 256x256 (fade and stabilize), 16 steps each (the
   schedule's length is the only cut besides batch 32 throughout), R1 on
   at each phase's first step: every step's launch counts against those
   derived for its resolution, the logged alpha (0 -> 15/16 in a fade
   phase, 1.0 in a stabilize phase), finite losses, the checkpoints; a
   second ``Trainer`` on the workdir holds the live state bit for bit and
   its next two steps equal the live state's; ``BatchSampler(cfg,
   workdir=...)`` serves the live G-EMA's batch bit for bit; ``cli
   sample`` writes a PNG. Per phase: ms per step, img/s by step time and
   by the loop's clock; peak memory; one R1-off step of 8x8 and of 64x64
   profiled (the device's idle share); the host's time to make a batch.
8. The user's own images at 1024x1024: 64 PNGs (PIL, three of four sizes
   not square) -> ``cli prepare-data --max-res 1024`` (the native gather
   library must have built) -> ``cli train --preset stylegan-1024`` on the
   ``npy`` shards at full width with remat and the preset's batches
   16 / 8 / 4, all 15 phases 8x8 -> 1024x1024, cut in length only (fade
   256 images, stabilize 64: the 512x512 and 1024x1024 phases start with
   an R1 step and run one lazy-R1 cycle or more); the checks of phase 7 per
   phase (launch counts with remat's recomputes), resume bit for bit;
   ``cli sample``, ``interpolate``, ``mixgrid`` and ``eval-fid --metrics
   fid,kid,pr`` (random-conv features), each with the launch counts read
   around it. Then the time of one synchronous checkpoint save, the host's
   ms per ``npy`` batch through the native gather, ``image_folder`` and
   ``image_folder_stream`` batches from the PNG folder, and peak memory
   of 1024x1024 steps with and without remat.
9. One ``InceptionExtractor`` forward on 64 images of 1024x1024 (random
   weights), ms per 64 images.
10. One JSON line of per-kernel numbers, then the final ``{"ok": true,
    ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ganlab_tpu_torch import BatchSampler, build_generator, get_config
from ganlab_tpu_torch import cli as port_cli
from ganlab_tpu_torch import ops as port_ops
from ganlab_tpu_torch.data import make_source
from ganlab_tpu_torch.models.stylegan import noise_shapes
from ganlab_tpu_torch.ops.kernels import _build
from ganlab_tpu_torch.ops.kernels.adain import (
    adain_cuda,
    adain_path,
    adain_ref,
)
from ganlab_tpu_torch.ops.kernels.mbstd import (
    minibatch_stddev_cuda,
    minibatch_stddev_path,
    minibatch_stddev_ref,
)
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    pixel_norm_ref,
    pixel_norm_cuda,
)
from ganlab_tpu_torch.ops.kernels.resample import (
    blur_downsample_2x_cuda,
    blur_downsample_2x_path,
    blur_downsample_2x_ref,
    upsample_blur_2x_cuda,
    upsample_blur_2x_path,
    upsample_blur_2x_ref,
)
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train import (
    Trainer,
    build_phases,
    create_train_state,
    make_lazy_stepper,
    state_tensors,
)
from ganlab_tpu_torch.train import loop as train_loop
from ganlab_tpu_torch.train import steps as train_steps

BATCH = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_RTOL = 1e-5                # kernel vs plain, float32, of the output scale
BF16_ULPS = 2                  # kernel vs plain, bf16 ulps of the output scale
IMAGE_ATOL = 2e-3              # card f32 vs CPU f32 image, on [-1, 1]
GRAD_RTOL = 1e-5               # Function grad vs plain autograd, of scale
STEP_LOSS_RTOL = 1e-4          # f32 train step, card vs CPU: losses
STEP_GRAD_RTOL = 5e-3          # ... every gradient leaf, of its scale:
                               # the biases ahead of each AdaIN get sums
                               # that cancel to ~1e-3 of their terms
TRAIN_STEPS = 34               # steps 0, 16, 32 are R1-on (penalty_every 16)


def log(*a):
    print(*a, flush=True)


# -- 1. device -------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"device: {kind}  count={torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return kind, card


# -- 2. build --------------------------------------------------------------
def phase_build():
    t0 = time.perf_counter()
    for lib in _build.build_all():
        log(f"build: {lib.name} -> {lib.path.name} in "
            f"{lib.build_seconds:.2f} s")
        if lib.log.strip():
            log(lib.log.rstrip())
    log(f"build: all CUDA sources in {time.perf_counter() - t0:.2f} s")


# -- 3. kernels vs plain ---------------------------------------------------
def cuda_time_ms(fn, iters: int = 30, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """fn's time on the device alone: ``calls`` calls captured into one
    CUDA graph, the replay timed by CUDA events. No host time per call is
    in it; the gap the device leaves between two nodes of a graph is."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_time_us(fn, calls: int = 100) -> float:
    """Host wall time per call over ``calls`` calls with no synchronize in
    between: what the caller's thread spends to submit one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def tolerance(dtype, scale: float) -> float:
    """Kernel against plain version. The resample kernels sum nothing
    across threads (their two paths agree bit for bit); pixelnorm, AdaIN
    and mbstd sum in another order than the plain version, and AdaIN in
    another order on each of its paths, so float32 agrees to rounding:
    1e-5 of the output's scale. bfloat16: both sides round once."""
    if dtype == torch.float32:
        return F32_RTOL * scale
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    return BF16_ULPS * ulp


def _bsz(dtype):
    return torch.finfo(dtype).bits // 8


def serving_shapes(mc, res_log2=None, batch=BATCH):
    """shape -> launches per batch, for each kernel of a G forward at
    2^res_log2 (the serving path runs it at the model's full resolution)."""
    top = mc.res_log2 if res_log2 is None else res_log2
    adain = {}
    for lg in range(2, top + 1):
        s = (batch, mc.nf(lg - 1), 2 ** lg, 2 ** lg)
        adain[s] = adain.get(s, 0) + 2
    up = {(batch, mc.nf(lg - 2), 2 ** (lg - 1), 2 ** (lg - 1)): 1
          for lg in range(3, top + 1)}
    return {"pixelnorm": {(batch, mc.latent_dim): 1},
            "adain": adain, "upsample_blur_2x": up}


def _add(total: dict, part: dict) -> None:
    for name, shapes in part.items():
        for shape, n in shapes.items():
            d = total.setdefault(name, {})
            d[shape] = d.get(shape, 0) + n


def step_launches(mc, r1: bool, res_log2=None, batch=BATCH) -> dict:
    """kernel -> {shape: launches} of one training step at 2^res_log2 (the
    model's full resolution when None) and ``batch``, derived from the
    model's structure (``mc``, ``mc.remat``) and the step's code. A fade
    phase adds no launch: its extra toRGB / fromRGB, nearest upsample,
    average pool and blend are plain PyTorch. At one batch throughout,
    every shape of a lower resolution's step is one of the full
    resolution's.

    * G forward: one pixelnorm over the 2B rows of concat([z1, z2]), two
      AdaIN per resolution, one up+blur per block from 8x8 up;
    * D forward: one blur+down per block, one mbstd;
    * D backward (to its parameters or its input): each blur+down's
      backward is UpsampleBlur2x with gain 1/4 at the block's output
      shape; mbstd's backward is plain PyTorch;
    * G backward: each up+blur's backward is BlurDownsample2x with gain 4
      at the block's upsampled shape; AdaIN's and pixelnorm's are plain.

    D phase: G forward (no grad), D on real and on fake, one backward of
    both. G phase: G forward, D forward, backward through D into G. An R1
    step adds D on real once more and its create-graph backward; the
    double backward then runs the backward of every first-order
    UpsampleBlur2x node (blur+down at the block shapes) and of every
    blur+down node of that D forward (up+blur).

    With ``model.remat`` each block is recomputed in the backward, up to
    its last tensor the backward needs (``torch.utils.checkpoint`` stops
    there): a synthesis block's up+blur and its two AdaIN run again in the
    G phase's backward; a D block ends in blur+down, which saves nothing,
    so its recompute launches no kernel of ours (the CPU tests count this
    on a small model: tests/test_torch_remat_launches.py).
    """
    lg = mc.res_log2 if res_log2 is None else res_log2
    down = {(batch, mc.nf(l - 2), 2 ** l, 2 ** l): 1 for l in range(3, lg + 1)}
    up = {(batch, mc.nf(l - 2), 2 ** (l - 1), 2 ** (l - 1)): 1
          for l in range(3, lg + 1)}
    serve = serving_shapes(mc, lg, batch)
    g_fwd = {"pixelnorm": {(2 * batch, mc.latent_dim): 1},
             "adain": serve["adain"], "upsample_blur_2x": up}
    d_fwd = {"blur_downsample_2x": down,
             "minibatch_stddev": {(batch, mc.nf(1), 4, 4): 1}}
    d_bwd = {"upsample_blur_2x": up}
    g_bwd = {"blur_downsample_2x": down}
    parts = [g_fwd, d_fwd, d_fwd, d_bwd, d_bwd,      # D phase
             g_fwd, d_fwd, d_bwd, g_bwd]             # G phase
    if mc.remat:                                     # G phase's recompute
        parts.append({"adain": {s: n for s, n in serve["adain"].items()
                                if s[2] > 4},
                      "upsample_blur_2x": up})
    if r1:
        parts += [d_fwd, d_bwd, {"blur_downsample_2x": down}, d_bwd]
    total: dict = {}
    for part in parts:
        _add(total, part)
    return total


@functools.cache
def _blur_filter(c, dtype, norm=16.0):
    """The library calls' depthwise 4x4 filter, made once per (c, dtype):
    a call then copies nothing from the host and can go into a graph."""
    t = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda")
    return (torch.outer(t, t) / norm).to(dtype).expand(c, 1, 4, 4)


def _blur_down_filter(c, dtype):
    return _blur_filter(c, dtype, 64.0)


def _mbstd_library(x):
    stat = x.float().var(0, unbiased=False).add(1e-8).sqrt().mean()
    return torch.cat([x, stat.to(x.dtype).expand(x.shape[0], 1,
                                                  *x.shape[2:])], 1)


KERNELS = {
    "pixelnorm": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/pixelnorm.cu",
        replaces="ganlab_tpu/ops/pallas/pixelnorm.py:64",
        kernel=pixel_norm_cuda,
        plain=pixel_norm_ref,
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=(lambda x: F.rms_norm(x, (x.shape[-1],), eps=1e-8))
        if hasattr(F, "rms_norm") else None,
        nbytes=lambda s, dt: 2 * math.prod(s) * _bsz(dt),
        flops=lambda s: 4 * math.prod(s)),
    "adain": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/adain.cu",
        replaces="ganlab_tpu/ops/pallas/adain.py:77",
        kernel=adain_cuda, plain=adain_ref,
        inputs=lambda s, dt, g: (
            (torch.randn(s, generator=g, device="cuda") * 2 + 0.5).to(dt),
            (torch.randn(s[:2], generator=g, device="cuda") + 1).to(dt),
            torch.randn(s[:2], generator=g, device="cuda").to(dt)),
        library=lambda x, ys, yb: F.instance_norm(
            x.view(1, -1, *x.shape[2:]), weight=ys.flatten(),
            bias=yb.flatten(), eps=1e-8).view(x.shape),
        nbytes=lambda s, dt: (2 * math.prod(s) + 2 * s[0] * s[1]) * _bsz(dt),
        flops=lambda s: 8 * math.prod(s)),
    "upsample_blur_2x": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/resample.cu",
        replaces="ganlab_tpu/ops/pallas/resample.py:132",
        kernel=upsample_blur_2x_cuda,
        plain=upsample_blur_2x_ref,
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=lambda x: F.conv_transpose2d(
            x, _blur_filter(x.shape[1], x.dtype), stride=2, padding=1,
            groups=x.shape[1]),
        nbytes=lambda s, dt: 5 * math.prod(s) * _bsz(dt),
        flops=lambda s: 30 * math.prod(s)),
    "blur_downsample_2x": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/resample.cu",
        replaces="ganlab_tpu/ops/pallas/resample.py:154",
        kernel=blur_downsample_2x_cuda,
        plain=blur_downsample_2x_ref,
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=lambda x: F.conv2d(
            x, _blur_down_filter(x.shape[1], x.dtype), stride=2, padding=1,
            groups=x.shape[1]),
        nbytes=lambda s, dt: 1.25 * math.prod(s) * _bsz(dt),
        flops=lambda s: 21 * math.prod(s) / 4),
    "minibatch_stddev": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/mbstd.cu",
        replaces="ganlab_tpu/ops/pallas/mbstd.py:45",
        kernel=minibatch_stddev_cuda,
        plain=minibatch_stddev_ref,
        inputs=lambda s, dt, g: (
            (torch.randn(s, generator=g, device="cuda") * 1.5 + 0.3)
            .to(dt),),
        library=_mbstd_library,
        nbytes=lambda s, dt: (2 * math.prod(s) + s[0] * s[2] * s[3])
        * _bsz(dt),
        flops=lambda s: 5 * math.prod(s)),
}

# backward of each kernel's autograd Function
BWD_ROUTE = {
    "pixelnorm": "plain PyTorch (analytic VJP)",
    "adain": "plain PyTorch (analytic VJP)",
    "upsample_blur_2x": "cuda: BlurDownsample2x with gain 4",
    "blur_downsample_2x": "cuda: UpsampleBlur2x with gain 1/4",
    "minibatch_stddev": "plain PyTorch (analytic VJP)",
}
WITH_GAIN = ("upsample_blur_2x", "blur_downsample_2x")
CHECK_GAIN = 0.3               # kernel(x, gain) against plain(x, gain)
# checked, not timed: rows that end ragged, widths that are no multiple of
# a 16-byte vector, more than a warp's worth of vectors in a row
EXTRA_SHAPES = {
    "pixelnorm": [(3, 96), (5, 500), (4, 4096), (2, 2056)],
    "upsample_blur_2x": [(3, 5, 7, 24), (2, 3, 33, 31), (1, 2, 5, 264),
                         (2, 2, 9, 8)],
    "blur_downsample_2x": [(2, 3, 34, 30), (3, 5, 14, 48), (1, 2, 10, 528),
                           (2, 2, 18, 16), (2, 3, 66, 62)],
    # one per path of the kernel and the edges between them: a plane that
    # is no multiple of a vector (loop), 33x31, the largest warp plane
    # (32x32) and the first block plane, a block that ends ragged, a
    # cluster in float32
    "adain": [(2, 3, 5, 7), (3, 5, 33, 31), (2, 3, 32, 32), (2, 3, 32, 36),
              (2, 3, 48, 48), (1, 2, 256, 256)],
    # both paths of the kernel, with the batch in registers (N <= 32) and
    # read twice: N = 1, 3, 33, 64, the largest batch; an odd C; H*W = 9
    # and M no multiple of a vector (element path); more chunks than the
    # cluster has threads; the batches of the progressive presets
    "minibatch_stddev": [(1, 512, 4, 4), (3, 511, 4, 4), (33, 512, 4, 4),
                         (64, 512, 4, 4), (1024, 8, 4, 4), (4, 3, 5, 7),
                         (3, 5, 3, 3), (33, 7, 3, 3), (1, 1, 1, 1),
                         (5, 2048, 4, 4), (40, 1100, 2, 2), (16, 512, 4, 4),
                         (8, 512, 4, 4)],
}
# resample kernel -> the function that tells which path a call takes
RESAMPLE_PATHS = {"upsample_blur_2x": upsample_blur_2x_path,
                  "blur_downsample_2x": blur_downsample_2x_path}
SUMMED = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms",
          "bytes_ms", "ops_ms")
SERVED, STEP = "served batch", "R1-off step"
SERVED_1K, STEP_1K = "1024 served batch", "1024 R1-off step"
SMALL_MS = 0.05                # below this a timing is read five more times


def _dt(dtype) -> str:
    return str(dtype)[6:]


def _check(label: str, out, ref, dtype, note: str = "") -> float:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = tolerance(dtype, scale)
    ok = bool(math.isfinite(err) and err <= tol and out.shape == ref.shape
              and out.dtype == ref.dtype)
    log(f"check {label}: max_abs {err:.3e} max_rel "
        f"{err / max(scale, 1e-30):.3e} tol {tol:.3e}{note} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def check_shape(name: str, shape, g) -> float:
    """The kernel against its plain version at one shape in float32 and
    bfloat16; returns the largest absolute error."""
    k = KERNELS[name]
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        inp = k["inputs"](shape, dt, g)
        t0 = time.perf_counter()
        out = k["kernel"](*inp)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        label = f"{name} {shape} {_dt(dt)}"
        worst = max(worst, _check(label, out, k["plain"](*inp), dt,
                                  f" first call {first_s:.2f} s"))
        if name in WITH_GAIN:
            worst = max(worst, _check(
                f"{label} gain {CHECK_GAIN}", k["kernel"](*inp, CHECK_GAIN),
                k["plain"](*inp, CHECK_GAIN), dt))
        if name in RESAMPLE_PATHS:
            # the same values at a pointer that is not 16-byte aligned go
            # down the element path, whatever path the shape took, with
            # and without a gain
            x = inp[0]
            xu = _unaligned_copy(x)
            for gain in (1.0, CHECK_GAIN):
                out, out_u = k["kernel"](x, gain), k["kernel"](xu, gain)
                paths = (RESAMPLE_PATHS[name](x, out),
                         RESAMPLE_PATHS[name](xu, out_u))
                same = torch.equal(out, out_u)
                log(f"path {label} gain {gain}: {paths[0]}; from an "
                    f"unaligned copy: {paths[1]}, bit-identical {same}")
                if paths[1] != "element" or not same:
                    raise AssertionError(f"{label}: the two paths of {name} "
                                         "disagree")
        if name == "adain":
            # the sums' order differs between the paths, so they are held
            # to the plain version's tolerance, not to each other's bits
            xu = _unaligned_copy(inp[0])
            out_u = k["kernel"](xu, *inp[1:])
            log(f"path {label}: {adain_path(inp[0], out)}; from an "
                f"unaligned copy: {adain_path(xu, out_u)}")
            if adain_path(xu, out_u) != "loop":
                raise AssertionError(f"{label}: an unaligned input did not "
                                     "take the loop path")
            worst = max(worst, _check(f"{label} unaligned", out_u,
                                      k["plain"](*inp), dt))
        if name == "minibatch_stddev":
            worst = max(worst, check_mbstd_paths(label, inp[0], out, dt))
    return worst


def check_mbstd_paths(label: str, x, out, dt) -> float:
    """mbstd beyond the plain comparison: a second call gives the same
    bits, the same values at an unaligned pointer take the element path,
    and every cluster size agrees with the plain version."""
    want = minibatch_stddev_ref(x)
    if not torch.equal(out, minibatch_stddev_cuda(x)):
        raise AssertionError(f"{label}: two calls gave other bits")
    xu = _unaligned_copy(x)
    out_u = minibatch_stddev_cuda(xu)
    paths = minibatch_stddev_path(x, out), minibatch_stddev_path(xu, out_u)
    log(f"path {label}: {paths[0]}; from an unaligned copy: {paths[1]}; "
        "bit-equal across two calls")
    if not paths[1].startswith("element"):
        raise AssertionError(f"{label}: an unaligned input did not take "
                             "the element path")
    worst = _check(f"{label} unaligned", out_u, want, dt)
    for cluster in (1, 2, 4):
        worst = max(worst, _check(
            f"{label} cluster {cluster}",
            minibatch_stddev_cuda(x, cluster=cluster), want, dt))
    return worst


def mbstd_variants(g) -> None:
    """The cluster of 8 blocks against fewer blocks at the training shape:
    the same call with the cluster size forced, each read three times in
    turns (ms by CUDA events, device_ms by graph replay)."""
    shape = (BATCH, 512, 4, 4)
    (x,) = KERNELS["minibatch_stddev"]["inputs"](shape, torch.bfloat16, g)
    calls = {f"cluster {c}": functools.partial(minibatch_stddev_cuda, x,
                                               cluster=c)
             for c in (8, 4, 2, 1)}
    reads = {n: [] for n in calls}
    for _ in range(3):
        for n, fn in calls.items():
            reads[n].append((cuda_time_ms(fn, iters=50, warmup=5),
                             device_time_ms(fn)))
    log(f"variants minibatch_stddev {shape} bf16 "
        f"({minibatch_stddev_path(x, x)}), ms / device_ms, median of 3 in "
        "turns: " + ", ".join(
            f"{n} {statistics.median(v[0] for v in r):.4f} / "
            f"{statistics.median(v[1] for v in r):.4f}"
            for n, r in reads.items()))


def _unaligned_copy(x):
    """x's values in a contiguous tensor whose pointer is one element past
    a 16-byte boundary."""
    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:] \
        .view(x.shape).copy_(x)


def check_adain_planes(g) -> float:
    """AdaIN where the variance formula matters: constant planes (variance
    0, as StyleGAN's 4x4 planes at init: the output is the bias, while
    E[x^2] - mean^2 would leave rounding noise for rsqrt(eps) = 1e4 to
    multiply) and planes with a mean far above their spread
    (1000 + 16 noise), on every path of the kernel."""
    worst = 0.0
    for shape in ((4, 8, 4, 4), (2, 3, 5, 7), (2, 3, 64, 64),
                  (1, 2, 256, 256)):
        for dt in (torch.float32, torch.bfloat16):
            _, ys, yb = KERNELS["adain"]["inputs"](shape, dt, g)
            noise = torch.randn(shape, generator=g, device="cuda")
            for what, x in (("constant planes", torch.full(shape, 1.5)),
                            ("planes 1000 + 16 noise", 1000 + 16 * noise)):
                x = x.to("cuda", dt)
                out = adain_cuda(x, ys, yb)
                worst = max(worst, _check(
                    f"adain {shape} {_dt(dt)} {what} "
                    f"[{adain_path(x, out)}]", out, adain_ref(x, ys, yb), dt))
                if what == "constant planes" and not torch.equal(
                        out, yb[:, :, None, None].expand_as(out)):
                    raise AssertionError("adain: a constant plane did not "
                                         "come out as its bias")
    return worst


# (threads a block, blocks a plane) forced on AdaIN's 256x256 planes
ADAIN_VARIANTS = {
    torch.bfloat16: [(1024, 1), (512, 2), (256, 4), (512, 4), (256, 8)],
    torch.float32: [(1024, 2), (512, 4), (256, 8), (512, 8)],
}


def adain_variants(g) -> None:
    """One block against a thread block cluster per 256x256 plane: the
    same call with the cut forced, each read three times in turns."""
    shape = (BATCH, 64, 256, 256)
    for dt, cuts in ADAIN_VARIANTS.items():
        inp = KERNELS["adain"]["inputs"](shape, dt, g)
        calls = {"chosen": lambda: adain_cuda(*inp)}
        for threads, cluster in cuts:
            calls[adain_path(inp[0], inp[0], threads=threads,
                             cluster=cluster)] = functools.partial(
                adain_cuda, *inp, threads=threads, cluster=cluster)
        reads = {n: [] for n in calls}
        for _ in range(3):
            for n, fn in calls.items():
                reads[n].append(cuda_time_ms(fn, iters=20, warmup=3))
        nbytes = KERNELS["adain"]["nbytes"](shape, dt)
        log(f"variants adain {shape} {_dt(dt)} (chosen: "
            f"{adain_path(inp[0], inp[0])}; bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), ms, median of 3 in "
            "turns: " + ", ".join(
                f"{n} {statistics.median(v):.4f}" for n, v in reads.items()))


def time_shape(name: str, shape, g) -> dict:
    """Times of the kernel, its plain version and its library call at one
    shape in bfloat16, beside the bound."""
    k = KERNELS[name]
    inp = k["inputs"](shape, torch.bfloat16, g)

    def kern():
        return k["kernel"](*inp)

    t = dict(ms=cuda_time_ms(kern),
             plain_ms=cuda_time_ms(lambda: k["plain"](*inp)),
             device_ms=device_time_ms(kern), host_us=host_time_us(kern),
             library_ms=None, library_device_ms=None, library_host_us=None)
    note = "n/a"
    if k["library"] is not None:
        def lib():
            return k["library"](*inp)

        lib_err = (lib().float() - k["plain"](*inp).float()).abs().max().item()
        t.update(library_ms=cuda_time_ms(lib),
                 library_device_ms=device_time_ms(lib),
                 library_host_us=host_time_us(lib))
        note = (f"{t['library_ms']:.4f} ms (device "
                f"{t['library_device_ms']:.4f} ms, host "
                f"{t['library_host_us']:.1f} us; vs plain {lib_err:.2e})")
    if t["ms"] < SMALL_MS and k["library"] is not None:
        # a call this short is timed by the host's pace, which wanders:
        # read kernel and library call in turns to see by how much
        reads = [(cuda_time_ms(kern), cuda_time_ms(lib)) for _ in range(5)]
        for who, vals in zip(("kernel", "library"), zip(*reads)):
            log(f"again {name} {shape} bf16 {who} ms, 5 readings in turns: "
                f"min {min(vals):.4f} median {statistics.median(vals):.4f} "
                f"max {max(vals):.4f}")
    nbytes = k["nbytes"](shape, torch.bfloat16)
    t["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    t["ops_ms"] = k["flops"](shape) / F32_FLOPS_PER_S * 1e3
    bound = max(t["bytes_ms"], t["ops_ms"])
    log(f"time {name} {shape} bf16: kernel {t['ms']:.4f} ms (device "
        f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us)  plain "
        f"{t['plain_ms']:.4f} ms  library {note}  bound {bound:.4f} ms "
        f"({'bytes' if t['bytes_ms'] >= t['ops_ms'] else 'operations'}); "
        f"{nbytes / t['ms'] / 1e6:.0f} GB/s = "
        f"{nbytes / t['ms'] / 1e-3 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s by "
        f"ms, {nbytes / t['device_ms'] / 1e-3 / HBM_BYTES_PER_S:.3f} by "
        "device_ms")
    return t


def pixelnorm_host_parts(g) -> None:
    """Where the host's time for one pixelnorm call goes: the output's
    allocation, the C function through ctypes on a ready output, and the
    whole wrapper, beside the library call (host_time_us of each)."""
    from ganlab_tpu_torch.ops.kernels import pixelnorm, stream_handle

    x = torch.randn(BATCH, 512, generator=g, device="cuda").bfloat16()
    out = torch.empty_like(x)
    fn = pixelnorm._fn()

    def raw():
        fn(x.data_ptr(), out.data_ptr(), BATCH, 512, 1e-8, 1, 0,
           stream_handle(0))

    parts = {"empty_like": lambda: torch.empty_like(x),
             "C function through ctypes": raw,
             "whole wrapper": lambda: pixel_norm_cuda(x)}
    if KERNELS["pixelnorm"]["library"] is not None:
        parts["F.rms_norm"] = lambda: KERNELS["pixelnorm"]["library"](x)
    for _ in range(2):                    # the second reading is the warm one
        reads = {n: host_time_us(f, calls=300) for n, f in parts.items()}
    log(f"host pixelnorm {tuple(x.shape)} bf16, us per call over 300 "
        "un-synchronised calls: "
        + ", ".join(f"{n} {v:.2f}" for n, v in reads.items()))


def unit_sums(times: dict, launches: dict) -> dict:
    """The per-shape times summed over one unit's launches."""
    n_all = sum(launches.values())
    r = {"launches": n_all}
    for key in SUMMED:
        vals = [times[s][key] for s in launches]
        r[key] = None if None in vals else \
            sum(n * v for n, v in zip(launches.values(), vals))
    for key in ("host_us", "library_host_us"):      # per call: the mean
        vals = [times[s][key] for s in launches]
        r[key] = None if None in vals else \
            sum(n * v for n, v in zip(launches.values(), vals)) / n_all
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    return r


def phase_kernels(units: dict) -> dict:
    """Check and time every kernel. ``units`` maps a unit of work (a served
    batch, a training step) to kernel -> {shape: launches per unit}; every
    shape is checked and timed once and the times are summed per unit.
    Returns kernel -> {"max_abs_err": ..., unit: sums}."""
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with torch.inference_mode():
        for name in KERNELS:
            shapes = list(dict.fromkeys(
                s for by_kernel in units.values()
                for s in by_kernel.get(name, {})))
            r = {"max_abs_err": max(
                check_shape(name, s, g)
                for s in shapes + EXTRA_SHAPES.get(name, []))}
            if name == "adain":
                r["max_abs_err"] = max(r["max_abs_err"],
                                       check_adain_planes(g))
                adain_variants(g)
            times = {s: time_shape(name, s, g) for s in shapes}
            if name == "pixelnorm":
                pixelnorm_host_parts(g)
            if name == "minibatch_stddev":
                mbstd_variants(g)
            for unit, by_kernel in units.items():
                if by_kernel.get(name):
                    u = r[unit] = unit_sums(times, by_kernel[name])
                    lib = "n/a" if u["library_ms"] is None else \
                        (f"{u['library_ms']:.4f} ms (device "
                         f"{u['library_device_ms']:.4f} ms)")
                    log(f"sum {name} per {unit} ({u['launches']} launches): "
                        f"kernel {u['ms']:.4f} ms (device "
                        f"{u['device_ms']:.4f} ms, host {u['host_us']:.1f} "
                        f"us a call)  plain {u['plain_ms']:.4f} ms  library "
                        f"{lib}  bound {u['bound_ms']:.4f} ms "
                        f"({u['bound_by']})")
            results[name] = r
    return results


# -- 5. serving path -------------------------------------------------------
def make_sampler(cfg) -> BatchSampler:
    """Full-width G with seeded random weights; every term made live."""
    torch.manual_seed(0)
    sd = build_generator(cfg.model).state_dict()
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith(("noise.scale", ".bias", ".b")):
            v += 0.2 * torch.randn(v.shape, generator=gen)
    w_avg = 0.5 * torch.randn(cfg.model.latent_dim, generator=gen)
    return BatchSampler(cfg, params=sd, w_avg=w_avg, batch_size=BATCH)


def reset_counts():
    for k in KERNELS.values():
        k["kernel"].launches = 0


def phase_serving(card: str) -> dict:
    cfg = get_config("stylegan-256")
    assert cfg.run.compute_dtype == "bfloat16" and cfg.model.resolution == 256
    sampler = make_sampler(cfg)
    res = sampler.resolution
    t0 = time.perf_counter()
    sampler.warmup()
    log(f"main: warmup batch {time.perf_counter() - t0:.2f} s")

    reset_counts()
    a = sampler.generate(100, seed=0)
    b = sampler.generate(10, seed=0)
    z = sampler.latents(40, seed=5)
    c = sampler.generate_from_z(z)
    frames = sampler.interpolate(seed_a=0, seed_b=1, steps=8)
    ends = sampler.generate_from_z(sampler.latents(1, seed=0))
    batches = 4 + 1 + 2 + 1 + 1
    counts = {n: k["kernel"].launches for n, k in KERNELS.items()}
    log(f"main: {batches} batches of {BATCH}, launches {counts}")

    expect = {"pixelnorm": 1, "adain": 14, "upsample_blur_2x": 6}
    for n, per in expect.items():
        if counts[n] != per * batches:
            raise AssertionError(f"{n}: {counts[n]} launches, expected "
                                 f"{per} x {batches} batches")
    assert a.shape == (100, res, res, 3) and a.dtype == np.uint8, a.shape
    assert c.shape == (40, res, res, 3) and frames.shape == (8, res, res, 3)
    np.testing.assert_array_equal(a[:10], b)          # prefix index-stable
    np.testing.assert_array_equal(frames[0], ends[0])  # slerp(t=0) endpoint
    assert not np.array_equal(a[:10], c[:10])
    assert float(a.astype(np.float32).std()) > 1.0, "images are flat"
    log("main: prefix stability, interpolation endpoint and spread ok")

    # finite bf16 output straight from the sample function
    sample = build_sample_fn(cfg, sampler.res_log2)
    with torch.inference_mode():
        zz = torch.from_numpy(sampler.latents(BATCH, seed=9)).cuda()
        img = sample(sampler.g, sampler.w_avg, zz, None, 0.7, 1.0)
    assert img.shape == (BATCH, 3, res, res) and bool(img.isfinite().all())

    # float32 on the card vs float32 on the CPU, explicit noise
    cfg32 = get_config("stylegan-256", **{"run.compute_dtype": "float32"})
    s32 = build_sample_fn(cfg32, sampler.res_log2)
    gcpu = torch.Generator().manual_seed(3)
    z2 = torch.randn(2, cfg.model.latent_dim, generator=gcpu)
    noises = [torch.randn(2, 1, h, w, generator=gcpu)
              for h, w in noise_shapes(sampler.res_log2)]
    with torch.inference_mode():
        on_card = s32(sampler.g, sampler.w_avg, z2.cuda(), None, 0.7, 1.0,
                      [n.cuda() for n in noises]).cpu()
        g_cpu = copy.deepcopy(sampler.g).cpu()
        on_cpu = s32(g_cpu, sampler.w_avg.cpu(), z2, None, 0.7, 1.0, noises)
    err = (on_card - on_cpu).abs().max().item()
    log(f"main: f32 card vs CPU on 2 images: max_abs {err:.3e} "
        f"(tol {IMAGE_ATOL:g}), image std {on_cpu.std().item():.3f}")
    if not err <= IMAGE_ATOL:
        raise AssertionError("card and CPU disagree in float32")

    # throughput and latency (host clock; each call ends in a host copy)
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        sampler.generate(BATCH, seed=100 + i)
        lat.append((time.perf_counter() - t0) * 1e3)
    n_img = 8 * BATCH
    t0 = time.perf_counter()
    sampler.generate(n_img, seed=200)
    dt = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sampler.generate(BATCH, seed=300)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    perf = dict(img_per_s=n_img / dt, batch_ms_median=statistics.median(lat),
                batch_ms_max=max(lat), peak_gib=peak)
    log(f"main: {perf['img_per_s']:.1f} img/s over {n_img} images; batch "
        f"latency median {perf['batch_ms_median']:.2f} ms max "
        f"{perf['batch_ms_max']:.2f} ms; peak mem {peak:.2f} GiB "
        f"[{card}]")
    profile_call(f"one served batch of {BATCH}",
                 lambda: sampler.generate(BATCH, seed=500), card)
    return counts



def profile_call(label: str, fn, card: str, top: int = 12) -> dict:
    """Where one call spends its time: device time by kernel name
    (torch.profiler, device-side events only) against the host-clock wall
    time of the call, which ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((dev_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == cuda and dev_us(e) > 0), reverse=True)
    sum_ms = sum(r[0] for r in rows) / 1e3
    # busy = the union of the device events' intervals, so that events
    # the trace shows overlapping are not counted twice
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    idle = 1 - busy_ms / wall_ms
    log(f"profile: {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {idle:.3f}; device events sum to "
        f"{sum_ms:.2f} ms) [{card}]")
    ours = [r for r in rows[top:] if any(n in r[2] for n in PORT_KERNELS)]
    for us, count, key in rows[:top] + ours:
        log(f"profile: {us / 1e3:9.3f} ms  {100 * us / 1e3 / sum_ms:5.1f}%  "
            f"x{count:<5d} {key[:90]}")
    log(f"profile: {label}: {sum(r[1] for r in rows)} device events in all")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle)


# substrings of the hand-written kernels' names in a profile
PORT_KERNELS = ("pixel_norm", "adain", "upsample_blur_2x",
                "blur_downsample_2x", "mbstd")


def device_events(fn) -> list[str]:
    """Names of the device-side events (kernels, copies, memsets) of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name for e in prof.events() if e.device_type == cuda]


# -- 4. gradients on the card ------------------------------------------------
def _assert_grads_close(label, got, want, rtol=GRAD_RTOL):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        ok = math.isfinite(err) and err <= rtol * scale
        log(f"grad {label}[{i}] {tuple(b.shape)}: max_abs {err:.3e} "
            f"scale {scale:.3e} tol {rtol * scale:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: gradient {i} disagrees with "
                                 "autograd through the plain version")


def phase_gradients() -> None:
    """Each autograd Function against autograd through its plain version
    (float32, TF32 off), then R1's second-order derivative through a small
    D-like chain of up+blur, convs, blur+down and mbstd."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device="cuda") * scale) \
            .requires_grad_(True)

    kern = {"pixelnorm": port_ops.pixel_norm, "adain": port_ops.adain,
            "upsample_blur_2x": port_ops.upsample_blur_2x,
            "blur_downsample_2x": port_ops.blur_downsample_2x,
            "minibatch_stddev": port_ops.minibatch_stddev}
    cases = {"pixelnorm": (r(2 * BATCH, 512),),
             "adain": (r(BATCH, 256, 32, 32), r(BATCH, 256), r(BATCH, 256)),
             "upsample_blur_2x": (r(BATCH, 256, 32, 32),),
             "blur_downsample_2x": (r(BATCH, 256, 64, 64),),
             "minibatch_stddev": (r(BATCH, 512, 4, 4),)}
    before = {n: k["kernel"].launches for n, k in KERNELS.items()}
    for name, args in cases.items():
        out = kern[name](*args)
        ct = torch.randn(out.shape, generator=g, device="cuda")
        got = torch.autograd.grad(out, args, ct)
        want = torch.autograd.grad(KERNELS[name]["plain"](*args), args, ct)
        _assert_grads_close(name, got, want)
    moved = {n: KERNELS[n]["kernel"].launches - before[n] for n in before}
    if any(v == 0 for v in moved.values()):
        raise AssertionError(f"a Function did not launch its kernel: {moved}")

    # the factor between the two resample ops' adjoints rides in the
    # kernel's store: a backward is one kernel, with no elementwise pass
    for name, other in (("blur_downsample_2x", "upsample_blur_2x"),
                        ("upsample_blur_2x", "blur_downsample_2x")):
        (xin,) = cases[name]
        out = kern[name](xin)
        ct = torch.randn(out.shape, generator=g, device="cuda")
        names = device_events(lambda: torch.autograd.grad(out, xin, ct))
        log(f"grad {name}: its backward ran {len(names)} device kernel(s): "
            f"{[n[:60] for n in names]}")
        if len(names) != 1 or other not in names[0]:
            raise AssertionError(f"{name}: backward is not one {other} "
                                 "kernel")

    x = torch.randn(8, 16, 16, 16, generator=g, device="cuda")
    w1, w2 = r(16, 16, 3, 3, scale=0.2), r(16, 16, 3, 3, scale=0.2)
    w3 = r(17 * 8 * 8, scale=0.05)
    params = (w1, w2, w3)

    def chain(up, down, mbstd, xi):
        h = F.leaky_relu(F.conv2d(up(xi), w1, padding=1), 0.2)
        h = F.leaky_relu(F.conv2d(down(h), w2, padding=1), 0.2)
        return mbstd(down(h)).flatten(1) @ w3

    def r1(up, down, mbstd):
        xi = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(chain(up, down, mbstd, xi).sum(), xi,
                                    create_graph=True)
        return torch.autograd.grad(gx.square().sum(), params)

    got = r1(port_ops.upsample_blur_2x, port_ops.blur_downsample_2x,
             port_ops.minibatch_stddev)
    want = r1(upsample_blur_2x_ref, blur_downsample_2x_ref,
              minibatch_stddev_ref)
    _assert_grads_close("second order (R1 shape)", got, want)


# -- 6. training path ----------------------------------------------------------
def training_config(**over):
    return get_config("stylegan-256", **{
        "schedule.progressive": False,
        "schedule.batch_schedule": {256: BATCH}, **over})


def _leaves(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _changed(before: dict, module) -> int:
    return sum(not torch.equal(v, before[k])
               for k, v in module.state_dict().items())


def phase_training(card: str) -> dict:
    cfg = training_config()
    mc = cfg.model
    assert (mc.resolution, mc.latent_dim, mc.mapping_layers, mc.fmap_base,
            mc.fmap_max, cfg.run.compute_dtype) == (256, 512, 8, 8192, 512,
                                                    "bfloat16")
    phase = build_phases(cfg.schedule, mc)[-1]
    assert phase.batch_size == BATCH and phase.res_log2 == 8
    combo_at, _ = train_steps._lazy_combos(cfg)
    expect = {r1: {n: sum(v.values()) for n, v in
                   step_launches(mc, r1).items()} for r1 in (False, True)}
    log(f"train: launches per step derived from the config: R1-off "
        f"{expect[False]}, R1-on {expect[True]}")

    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=0)
    stepper = make_lazy_stepper(cfg, phase)
    log(f"train: state at full width on {state.device} in "
        f"{time.perf_counter() - t0:.2f} s; G {sum(p.numel() for p in state.g.parameters())} "
        f"D {sum(p.numel() for p in state.d.parameters())} parameters")
    gdata = torch.Generator(device="cuda").manual_seed(11)
    reals = [torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gdata,
                           device="cuda", dtype=torch.uint8)
             for _ in range(4)]
    before = {"g": _leaves(state.g), "d": _leaves(state.d),
              "g_ema": _leaves(state.g_ema)}

    totals = {n: 0 for n in KERNELS}
    step_ms, kinds = [], []
    peak_gib = None
    prof = {}
    for i in range(TRAIN_STEPS):
        r1 = combo_at(i)[0] is True
        if i == 16:
            torch.cuda.reset_peak_memory_stats()

        def one():
            nonlocal state, metrics
            state, metrics = stepper(state, reals[i % len(reals)])

        metrics = None
        reset_counts()
        if i >= TRAIN_STEPS - 2:            # the last two: profiled
            prof[r1] = profile_call(
                f"one R1-{'on' if r1 else 'off'} training step (step {i})",
                one, card)
            ms = prof[r1]["wall_ms"]
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = {n: k["kernel"].launches for n, k in KERNELS.items()}
        for n in totals:
            totals[n] += counts[n]
        if i == 31:
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"train: step {i} R1-{'on ' if r1 else 'off'} {ms:9.2f} ms "
            f"launches {counts} "
            + " ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite metrics {vals}")
        if (vals["penalty"] > 0) != r1:
            raise AssertionError(f"step {i}: penalty {vals['penalty']} on "
                                 f"an R1-{'on' if r1 else 'off'} step")
        if counts != expect[r1]:
            raise AssertionError(f"step {i}: launches {counts}, derived "
                                 f"{expect[r1]}")
        step_ms.append(ms)
        kinds.append(r1)

    if state.shown_imgs != BATCH * TRAIN_STEPS or \
            state.step != TRAIN_STEPS:
        raise AssertionError(f"counters: step {state.step} shown "
                             f"{state.shown_imgs}")
    moved = {name: (_changed(before[name], getattr(state, name)),
                    len(before[name])) for name in before}
    log(f"train: parameters changed (of all): {moved}; w_avg norm "
        f"{state.w_avg.norm().item():.4f}; shown {state.shown_imgs}")
    for name, (n, total) in moved.items():
        # heads of resolutions below 256 get no gradient at 256x256
        if n < total // 2:
            raise AssertionError(f"{name}: only {n} of {total} leaves moved")
    if not (state.w_avg.norm().item() > 0 and
            bool(state.w_avg.isfinite().all())):
        raise AssertionError("w_avg did not move")

    timed = range(2, TRAIN_STEPS - 2)       # after the first of each kind
    off = [step_ms[i] for i in timed if not kinds[i]]
    on = [step_ms[i] for i in timed if kinds[i]]
    cycle_s = sum(step_ms[16:32]) / 1e3     # steps 16..31: 1 on + 15 off
    perf = dict(ms_r1_off=statistics.median(off), ms_r1_on=statistics.median(on),
                img_per_s_cycle=16 * BATCH / cycle_s, peak_gib=peak_gib,
                first_step_ms=step_ms[0], prof=prof,
                launches=totals, expect=expect)
    log(f"train: {perf['ms_r1_off']:.2f} ms per R1-off step (median of "
        f"{len(off)}), {perf['ms_r1_on']:.2f} ms per R1-on step (step 16); "
        f"{perf['img_per_s_cycle']:.1f} img/s over the 16-step cycle "
        f"16..31; peak memory {peak_gib:.2f} GiB; first step "
        f"{step_ms[0]:.0f} ms [{card}]")
    perf["cudnn_benchmark"] = probe_cudnn_benchmark(cfg, phase, state,
                                                    reals[0], card)
    phase_train_card_vs_cpu()
    return perf


def probe_cudnn_benchmark(cfg, phase, state, real, card) -> dict:
    """The same steps with cuDNN's autotuner on (``cudnn.benchmark``),
    after the main path was read: the second call of each is timed."""
    torch.backends.cudnn.benchmark = True
    try:
        out = {}
        for r1 in (True, False):
            step = train_steps.build_train_step(cfg, phase,
                                                penalty_override=r1)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, real)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            out["r1_on" if r1 else "r1_off"] = ms
    finally:
        torch.backends.cudnn.benchmark = False
    log(f"train: with cudnn.benchmark on: {out['r1_on']:.2f} ms per R1-on "
        f"step, {out['r1_off']:.2f} ms per R1-off step (second call) "
        f"[{card}]")
    return out


def phase_train_card_vs_cpu() -> None:
    """One R1-on step of a narrow 32² model in float32 (TF32 off), on the
    card and on the CPU from the same initial state and draws. D's lr is 0
    here: Adam's first update is about lr * sign(g), so where D's gradient
    is ~0 the two devices' updated D's would differ by up to 2 lr, and G's
    gradients, taken against the updated D, with them."""
    cfg = get_config("stylegan-256", **{
        "model.resolution": 32, "model.fmap_base": 512,
        "model.fmap_max": 64, "model.latent_dim": 128,
        "run.compute_dtype": "float32", "schedule.progressive": False,
        "schedule.batch_schedule": {32: 8}, "optim.lr_d": 0.0})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    draws = train_steps.draw_step(cfg, phase.res_log2, 8,
                                  torch.Generator().manual_seed(4), "cpu")
    real = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(5))
    # every term live: at init the 4x4 planes are constant (const 1, bias
    # and noise scale 0), where AdaIN's gradient is rounding noise x 1e4
    base = create_train_state(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for net in (base.g, base.d):
            for k, v in net.state_dict().items():
                if k.endswith(("noise.scale", ".bias", ".b", "const")):
                    v += 0.2 * torch.randn(v.shape, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        st = create_train_state(cfg, seed=3, device=dev)
        st.g.load_state_dict(base.g.state_dict())
        st.d.load_state_dict(base.d.state_dict())
        step = train_steps.build_train_step(cfg, phase, penalty_override=True)
        st, m = step(st, real, draws)
        grads = {f"{net}.{k}": p.grad.detach().cpu()
                 for net in ("g", "d")
                 for k, p in getattr(st, net).named_parameters()
                 if p.grad is not None}
        out[dev] = ({k: float(v) for k, v in m.items()}, grads)
    (m_card, g_card), (m_cpu, g_cpu) = out["cuda"], out["cpu"]
    for k, v in m_cpu.items():
        err = abs(m_card[k] - v)
        if not err <= STEP_LOSS_RTOL * max(abs(v), 1e-3):
            raise AssertionError(f"f32 step {k}: card {m_card[k]} cpu {v}")
    if set(g_card) != set(g_cpu):
        raise AssertionError("f32 step: card and CPU have other grad leaves")
    rels = sorted((((g_card[k] - want).abs().max().item()
                    / max(want.abs().max().item(), 1e-30)), k)
                  for k, want in g_cpu.items())
    worst = rels[-1][0]
    log("train: f32 step, largest gradient differences (of the leaf "
        "scale): " + ", ".join(f"{k} {r:.2e}" for r, k in rels[-4:]))
    if not worst <= STEP_GRAD_RTOL:
        raise AssertionError(f"f32 step grad {rels[-1][1]}: {worst:.3e} "
                             "of scale")
    log(f"train: f32 R1-on step at 32² card vs CPU: losses {m_cpu} agree "
        f"within {STEP_LOSS_RTOL:g} rel; {len(g_cpu)} gradient leaves agree, "
        f"worst {worst:.3e} of the leaf scale (tol {STEP_GRAD_RTOL:g})")


# -- 7. the progressive trainer ------------------------------------------------
PHASE_STEPS = 16               # steps a phase: one lazy-R1 cycle, R1 on first
CKPT_EVERY = 80


def _assert_states_equal(what: str, a, b) -> int:
    ta, tb = state_tensors(a), state_tensors(b)
    if set(ta) != set(tb):
        raise AssertionError(f"{what}: the states hold other leaves: "
                             f"{sorted(set(ta) ^ set(tb))[:6]}")
    bad = [k for k in ta if not torch.equal(ta[k].cpu(), tb[k].cpu())]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(ta)} leaves "
                             f"differ, first {bad[:4]}")
    return len(ta)


def run_cli_train(preset: str, sets: dict, workdir: str) -> dict:
    """``cli train --preset <preset> --set k=v ...`` into ``workdir``. The
    step functions the Trainer builds are wrapped to set the launch counts
    to 0 before each step and to read them and the clock (after a
    synchronize) after it."""
    records, live = [], {}
    make = train_loop.make_lazy_stepper

    def instrumented(cfg_, phase, initial_step=0):
        stepper = make(cfg_, phase, initial_step=initial_step)
        count = {"i": int(initial_step)}

        def step(state, real, draws=None):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stepper(state, real, draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            records.append(dict(
                phase=phase.index, step=count["i"], ms=ms, t0=t0,
                r1=count["i"] % cfg_.loss.penalty_every == 0,
                shape=tuple(real.shape), device=real.device.type,
                counts={n: k["kernel"].launches
                        for n, k in KERNELS.items()}))
            count["i"] += 1
            live["state"] = out[0]
            return out

        return step

    args = ["--preset", preset, "--workdir", workdir]
    for k, v in sets.items():
        args += ["--set", f"{k}={v}"]
    torch.cuda.reset_peak_memory_stats()
    train_loop.make_lazy_stepper = instrumented
    try:
        t0 = time.perf_counter()
        rc = port_cli.main(["train", *args])
        wall = time.perf_counter() - t0
    finally:
        train_loop.make_lazy_stepper = make
    if rc != 0:
        raise AssertionError(f"cli train returned {rc}")
    return dict(records=records, live=live["state"], wall_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_steps(ph) -> int:
    n, rest = divmod(ph.end_img - ph.start_img, ph.batch_size)
    assert rest == 0, (ph, rest)
    return n


def phase_trainer(card: str) -> dict:
    """The progressive trainer through its command line at full width: the
    stylegan-256 preset's own 11 phases, 8x8 stabilize up to 256x256
    stabilize, on the ``ellipses`` source."""
    kimg = PHASE_STEPS * BATCH / 1000.0
    sets = {"data.dataset": "ellipses", "schedule.fade_kimg": kimg,
            "schedule.stabilize_kimg": kimg, "schedule.total_kimg": 0.001,
            "schedule.batch_schedule": {2 ** lg: BATCH for lg in range(2, 9)},
            "run.log_every": 1, "run.checkpoint_every": CKPT_EVERY}
    cfg = get_config("stylegan-256", **sets)
    mc = cfg.model
    phases = build_phases(cfg.schedule, mc)
    assert (mc.resolution, mc.latent_dim, mc.mapping_layers, mc.fmap_base,
            cfg.run.compute_dtype, cfg.loss.penalty_every,
            cfg.schedule.progressive) == (256, 512, 8, 8192, "bfloat16", 16,
                                          True)
    assert [(p.resolution, p.kind) for p in phases] == \
        [(8, "stabilize")] + [(2 ** lg, kind) for lg in range(4, 9)
                              for kind in ("fade", "stabilize")]
    log(f"trainer: stylegan-256 preset, all widths and its {len(phases)} "
        f"phases; cut: schedule.fade_kimg and stabilize_kimg 600 -> {kimg} "
        f"({PHASE_STEPS} steps a phase), schedule.total_kimg 12000 -> the "
        f"phases' own end ({phases[-1].end_img} images), batch {BATCH} at "
        "every resolution (preset: 16, 8 from 128x128), data.dataset "
        "ellipses, run.log_every 1, run.checkpoint_every "
        f"{CKPT_EVERY}")

    workdir = tempfile.mkdtemp(prefix="ganlab_smoke_")
    try:
        run = run_cli_train("stylegan-256", sets, workdir)
        checked = check_trainer_run(cfg, phases, run["records"], workdir,
                                    card, CKPT_EVERY, r1_first_from=8)
        log(f"trainer: cli train took {run['wall_s']:.1f} s for "
            f"{len(run['records'])} steps; peak memory "
            f"{run['peak_gib']:.2f} GiB [{card}]")
        check_resume_and_serving(cfg, phases, run["live"], workdir)
        profile_phase_steps(cfg, phases, run["live"], card)
        png = os.path.join(workdir, "smoke_sample.png")
        if port_cli.main(["sample", "--workdir", workdir, "--num", "4",
                          "--psi", "0.7", "--out", png]) != 0:
            raise AssertionError("cli sample failed")
        check_png(png, "cli sample")
        log(f"trainer: cli sample wrote a PNG of {os.path.getsize(png)} "
            "bytes from the workdir's own config.json")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(launches=checked["launches"], peak_gib=run["peak_gib"])


def check_png(path: str, what: str) -> None:
    if not os.path.exists(path) or not os.path.getsize(path):
        raise AssertionError(f"{what} wrote no PNG")
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{what}: not a PNG file")


def check_trainer_run(cfg, phases, records, workdir, card,
                      ckpt_every, r1_first_from: int) -> dict:
    """Every phase ran its steps at its resolution and batch with the
    derived launch counts; R1 on every 16th step of the run, and every
    phase from ``r1_first_from`` pixels up runs 16 steps or more and
    starts with an R1 step; the logged alpha rises
    from 0 in a fade phase and is 1.0 in a stabilize phase; losses finite;
    checkpoints written, the newest kept. Prints each phase's step times
    and img/s by step time and by the loop's clock."""
    mc = cfg.model
    with open(os.path.join(workdir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    counts = [phase_steps(ph) for ph in phases]
    n_steps = sum(counts)
    if len(records) != n_steps or [r["step"] for r in rows] != \
            list(range(1, n_steps + 1)):
        raise AssertionError(f"trainer: {len(records)} steps, {len(rows)} "
                             f"log rows, expected {n_steps}")
    totals = {n: 0 for n in KERNELS}
    per_phase = {}
    first = 0
    for ph, n in zip(phases, counts):
        recs = [r for r in records if r["phase"] == ph.index]
        logged = rows[first:first + n]
        first += n
        res, b = ph.resolution, ph.batch_size
        if len(recs) != n or any(
                r["shape"] != (b, res, res, 3) or r["device"] != "cuda"
                for r in recs):
            raise AssertionError(f"trainer: phase {ph.index} ran "
                                 f"{[(r['shape']) for r in recs][:3]}")
        for r in recs:
            want = {k: sum(v.values()) for k, v in
                    step_launches(mc, r["r1"], ph.res_log2, b).items()}
            want = {k: want.get(k, 0) for k in KERNELS}
            if r["counts"] != want:
                raise AssertionError(
                    f"trainer: phase {ph.index} step {r['step']}: launches "
                    f"{r['counts']}, derived {want}")
            for k in totals:
                totals[k] += r["counts"][k]
        if res >= r1_first_from and (n < 16 or not recs[0]["r1"]):
            raise AssertionError(f"trainer: phase {ph.index} ({n} steps) "
                                 "is no lazy-R1 cycle from an R1 step")
        alphas = [row["alpha"] for row in logged]
        want_alpha = [k / n if ph.kind == "fade" else 1.0 for k in range(n)]
        for row, a in zip(logged, want_alpha):
            # bf16 blend: the step rounds alpha to the compute dtype
            if (row["res"], row["kind"]) != (res, ph.kind) or \
                    abs(row["alpha"] - a) > 2 ** -8:
                raise AssertionError(f"trainer: log row {row}, expected "
                                     f"res {res} {ph.kind} alpha {a}")
            vals = [row[k] for k in ("d_loss", "g_loss", "penalty",
                                     "real_score", "fake_score")]
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"trainer: non-finite metrics {row}")
            if (row["penalty"] > 0) != (row["step"] % 16 == 1):
                raise AssertionError(f"trainer: penalty in {row}")
        off = [r["ms"] for r in recs[2:] if not r["r1"]]
        on = [r["ms"] for r in recs if r["r1"]]
        steady = sum(r["ms"] for r in recs[2:]) / 1e3
        # between two steps the loop logs and waits for the next batch
        gaps = [(y["t0"] - x["t0"]) * 1e3 - x["ms"]
                for x, y in zip(recs[2:], recs[3:])]
        pp = per_phase[ph.index] = dict(
            res=res, kind=ph.kind, batch=b, steps=n,
            ms_r1_off=statistics.median(off),
            ms_r1_on=on, img_s_step=(n - 2) * b / steady,
            img_s_loop=(n - 3) * b / (recs[-1]["t0"] - recs[2]["t0"]),
            gap_ms=statistics.median(gaps))
        log(f"trainer: phase {ph.index} {res}x{res} {ph.kind} batch {b}: "
            f"{n} steps, alpha {alphas[0]:.4f}..{alphas[-1]:.4f}, "
            f"{pp['ms_r1_off']:.2f} ms per R1-off step (median of "
            f"{len(off)}), R1-on steps "
            f"{', '.join(f'{v:.2f}' for v in on) or 'none'} ms, first step "
            f"{recs[0]['ms']:.2f} ms, {pp['img_s_step']:.1f} img/s over "
            f"steps 3..{n} by step time, {pp['img_s_loop']:.1f} img/s by "
            f"the loop's clock (between steps: median {pp['gap_ms']:.2f} "
            f"ms, checkpoints included), launches R1-off "
            f"{next(r['counts'] for r in recs if not r['r1'])} [{card}]")
    ckpts = sorted(os.listdir(os.path.join(workdir, cfg.run.checkpoint_dir)))
    want = [f"ckpt_{s:08d}.pt" for s in
            sorted({*range(ckpt_every, n_steps + 1, ckpt_every), n_steps})
            ][-cfg.run.keep_checkpoints:]
    if ckpts != want:
        raise AssertionError(f"trainer: checkpoints {ckpts}, expected {want}")
    log(f"trainer: all {len(phases)} phases ran their steps ({counts}) at "
        "their resolution and batch with the derived launch counts; alpha "
        "0 -> (n-1)/n in fade phases, 1.0 in stabilize phases; metrics "
        f"finite; checkpoints {ckpts}")
    return dict(launches=totals, phases=per_phase)


def profile_phase_steps(cfg, phases, state, card) -> None:
    """Where an R1-off step of a low resolution spends its time (the
    device's idle share says how far the host holds the card back), and
    what the host needs to make one batch of each resolution."""
    for index in (0, 6):                       # 8x8 and 64x64 stabilize
        phase = phases[index]
        source = make_source(cfg.data, cfg.model.resolution, seed=5)
        real = torch.from_numpy(source.batch(BATCH, phase.resolution)).cuda()
        stepper = make_lazy_stepper(cfg, phase, initial_step=1)
        for _ in range(2):
            stepper(state, real)

        def one():
            stepper(state, real)

        profile_call(f"one R1-off step of phase {index} "
                     f"({phase.resolution}x{phase.resolution} {phase.kind})",
                     one, card, top=6)
    source = make_source(cfg.data, cfg.model.resolution, seed=5)
    times = {}
    for lg in range(3, cfg.model.res_log2 + 1):
        reads = []
        for _ in range(3):
            t0 = time.perf_counter()
            source.batch(BATCH, 2 ** lg)
            reads.append((time.perf_counter() - t0) * 1e3)
        times[2 ** lg] = statistics.median(reads)
    log(f"trainer: host ms to make one {cfg.data.dataset} batch of {BATCH} "
        "(median of 3, one thread, beside the idle main thread): "
        + ", ".join(f"{r}x{r} {t:.1f}" for r, t in times.items()))


def check_resume_and_serving(cfg, phases, live, workdir) -> None:
    """A second Trainer on the workdir holds the first one's state bit for
    bit; the sampler built from the workdir serves the live G-EMA's batch;
    and the next two steps (one with R1) of the restored and of the live
    state, on the same batches, end in the same bits. cuDNN is held to
    its deterministic algorithms for those steps, or two runs of one step
    from one state need not agree at all."""
    phase = phases[-1]
    batch, res = phase.batch_size, phase.resolution
    n_steps = sum(phase_steps(ph) for ph in phases)
    second = Trainer(cfg, workdir)
    try:
        if second.state.step != live.step or live.step != n_steps:
            raise AssertionError(f"resume: at step {second.state.step}, "
                                 f"live {live.step}")
        n = _assert_states_equal("resume", second.state, live)
        log(f"trainer: a second Trainer resumed at step {live.step}, shown "
            f"{live.shown_imgs}: all {n} leaves of the state (G, D, G-EMA, "
            "both Adam states, w_avg, counters, generator) bit-equal to "
            "the live state")

        from_disk = BatchSampler(cfg, workdir=workdir, batch_size=batch)
        from_live = BatchSampler(cfg, state=live, batch_size=batch)
        a = from_disk.generate(batch, seed=3)
        b = from_live.generate(batch, seed=3)
        if a.shape != (batch, res, res, 3) or not np.array_equal(a, b):
            raise AssertionError("serving from the workdir differs from "
                                 "serving the live G-EMA")
        log(f"trainer: BatchSampler(cfg, workdir=...) served a batch of "
            f"{batch} bit-equal to the live state's G-EMA (image std "
            f"{a.astype(np.float32).std():.2f})")
        del from_disk, from_live

        source = make_source(cfg.data, cfg.model.resolution, seed=123)
        reals = [torch.from_numpy(source.batch(batch, res)).cuda()
                 for _ in range(2)]
        step_live = make_lazy_stepper(cfg, phase, initial_step=live.step)
        step_second = second._step_fn(phase)
        torch.backends.cudnn.deterministic = True
        try:
            for real in reals:
                live, m1 = step_live(live, real)
                _, m2 = step_second(second.state, real)
                if {k: float(v) for k, v in m1.items()} != \
                        {k: float(v) for k, v in m2.items()}:
                    raise AssertionError(f"resume: metrics {m1} vs {m2}")
        finally:
            torch.backends.cudnn.deterministic = False
        n = _assert_states_equal("resume + 2 steps", second.state, live)
        log(f"trainer: two more steps ({live.step - 2} with R1, "
            f"{live.step - 1} without) from the restored and from the live "
            f"state: all {n} leaves bit-equal")
    finally:
        second.close()


# -- 8. the user's own images at 1024x1024 ---------------------------------------
USER_IMAGES = 64
USER_SIZES = ((1024, 1024), (1280, 1024), (1024, 1216), (1100, 1100))
# fade 256 images, stabilize 64: at the preset's batches (16 to 64x64, 8 to
# 256x256, 4 above) a fade phase runs 16 / 32 / 64 steps and a stabilize
# phase 4 / 8 / 16, so the 512x512 and 1024x1024 phases start at a
# multiple of 16 steps: R1 on their first step, one lazy-R1 cycle or more
USER_FADE_KIMG, USER_STABILIZE_KIMG = 0.256, 0.064
EVAL_SAMPLES = 64
SERVE_1K_BATCH = 16            # cli sample's --num default


def write_user_images(folder: str, n: int = USER_IMAGES, seed: int = 0):
    """``n`` PNGs of 1-3 filled ellipses on a flat background, at the sizes
    of ``USER_SIZES`` in turn (three of four not square, so the centre crop
    runs), drawn by PIL from ``seed``."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        w, h = USER_SIZES[i % len(USER_SIZES)]
        shapes = [(rng.uniform(0.1, 0.6, 2) * (w, h),
                   rng.uniform(0.15, 0.4, 2) * (w, h),
                   tuple(int(c) for c in rng.integers(80, 256, 3)))
                  for _ in range(int(rng.integers(1, 4)))]
        specs.append((i, w, h, tuple(int(c) for c in rng.integers(0, 120, 3)),
                      shapes))

    def one(spec):
        i, w, h, bg, shapes = spec
        img = Image.new("RGB", (w, h), bg)
        draw = ImageDraw.Draw(img)
        for (x0, y0), (ax, ay), col in shapes:
            draw.ellipse([x0, y0, x0 + ax, y0 + ay], fill=col)
        path = os.path.join(folder, f"img{i:03d}.png")
        img.save(path, compress_level=1)
        return path

    os.makedirs(folder, exist_ok=True)
    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(one, specs))


def user_config_sets(shard_dir: str) -> dict:
    return {"data.dataset": "npy", "data.data_dir": shard_dir,
            "schedule.fade_kimg": USER_FADE_KIMG,
            "schedule.stabilize_kimg": USER_STABILIZE_KIMG,
            "schedule.total_kimg": 0.001, "run.log_every": 1}


def counted(label: str, fn, need=("pixelnorm", "adain",
                                  "upsample_blur_2x")) -> dict:
    """Run ``fn`` with the launch counts set to 0 just before; read them
    just after; fail if a kernel of ``need`` was never launched."""
    reset_counts()
    rc = fn()
    counts = {n: k["kernel"].launches for n, k in KERNELS.items()}
    log(f"user: {label}: rc {rc}, launches {counts}")
    if rc not in (None, 0) or any(counts[n] == 0 for n in need):
        raise AssertionError(f"{label}: rc {rc}, launches {counts}")
    return counts


def phase_user_data(card: str) -> dict:
    """The user's story at the largest preset: an image folder ->
    ``cli prepare-data`` -> ``cli train --preset stylegan-1024`` (remat
    on, the preset's batches 16 / 8 / 4, full width, every phase 8x8 ->
    1024x1024; cut in length only) -> resume bit for bit -> ``cli
    sample``, ``interpolate``, ``mixgrid``, ``eval-fid --metrics
    fid,kid,pr``. Then the host's feed (the native gather, the two folder
    sources), peak memory of a 1024x1024 step with and without remat, and
    the time of one synchronous checkpoint save."""
    from ganlab_tpu_torch.data import native

    root = tempfile.mkdtemp(prefix="ganlab_user_")
    try:
        img_dir, shard_dir = (os.path.join(root, d) for d in ("images",
                                                              "shards"))
        wd = os.path.join(root, "run")
        t0 = time.perf_counter()
        write_user_images(img_dir, USER_IMAGES)
        log(f"user: wrote {USER_IMAGES} PNGs of {sorted(set(USER_SIZES))} "
            f"in {time.perf_counter() - t0:.1f} s")
        if not native.available():
            raise AssertionError("the native gather library did not build "
                                 f"on this host: {native._state.why_not}")
        log(f"user: native gather library {native.library_path().name} "
            "built and loaded")
        t0 = time.perf_counter()
        rc = port_cli.main(["prepare-data", "--src", img_dir, "--out",
                            shard_dir, "--max-res", "1024"])
        prep_s = time.perf_counter() - t0
        shards = {int(n[7:-4]): np.load(os.path.join(shard_dir, n),
                                        mmap_mode="r")
                  for n in os.listdir(shard_dir)}
        if rc != 0 or sorted(shards) != [2 ** lg for lg in range(2, 11)] \
                or any(a.shape != (USER_IMAGES, r, r, 3)
                       for r, a in shards.items()):
            raise AssertionError(f"prepare-data: rc {rc}, shards "
                                 f"{ {r: a.shape for r, a in shards.items()} }")
        log(f"user: cli prepare-data --max-res 1024 took {prep_s:.1f} s: "
            f"shards {sorted(shards)} of {USER_IMAGES} images")

        sets = user_config_sets(shard_dir)
        cfg = get_config("stylegan-1024", **sets)
        mc = cfg.model
        phases = build_phases(cfg.schedule, mc)
        assert (mc.resolution, mc.latent_dim, mc.mapping_layers,
                mc.fmap_base, mc.remat, cfg.run.compute_dtype,
                cfg.loss.penalty_every) == (1024, 512, 8, 8192, True,
                                            "bfloat16", 16)
        assert [(p.resolution, p.kind) for p in phases] == \
            [(8, "stabilize")] + [(2 ** lg, kind) for lg in range(4, 11)
                                  for kind in ("fade", "stabilize")]
        assert [p.batch_size for p in phases] == \
            [16] * 7 + [8] * 4 + [4] * 4
        log(f"user: stylegan-1024 preset, all widths, remat on, its "
            f"{len(phases)} phases at batches 16 / 8 / 4; cut: "
            f"schedule.fade_kimg 600 -> {USER_FADE_KIMG}, stabilize_kimg "
            f"600 -> {USER_STABILIZE_KIMG} (steps a phase: "
            f"{[phase_steps(p) for p in phases]}), schedule.total_kimg "
            f"25000 -> the phases' own end ({phases[-1].end_img} images); "
            f"data.dataset npy from the prepared shards, run.log_every 1")
        run = run_cli_train("stylegan-1024", sets, wd)
        checked = check_trainer_run(cfg, phases, run["records"], wd, card,
                                    cfg.run.checkpoint_every,
                                    r1_first_from=512)
        log(f"user: cli train took {run['wall_s']:.1f} s for "
            f"{len(run['records'])} steps; peak memory "
            f"{run['peak_gib']:.2f} GiB [{card}]")
        check_resume_and_serving(cfg, phases, run["live"], wd)
        save = checkpoint_save_time(run["live"], root, card)
        feed = host_feed(cfg, phases, shard_dir, card)

        launches = dict(checked["launches"])
        png = os.path.join(root, "sample.png")
        steps = [
            ("cli sample", lambda: port_cli.main(
                ["sample", "--workdir", wd, "--num", "4", "--psi", "0.7",
                 "--out", png])),
            ("cli interpolate", lambda: port_cli.main(
                ["interpolate", "--workdir", wd, "--anchors", "2",
                 "--steps", "3"])),
            ("cli mixgrid", lambda: port_cli.main(
                ["mixgrid", "--workdir", wd, "--num", "2"])),
            ("cli eval-fid", lambda: port_cli.main(
                ["eval-fid", "--workdir", wd, "--num-samples",
                 str(EVAL_SAMPLES), "--metrics", "fid,kid,pr"]))]
        for label, fn in steps:
            t0 = time.perf_counter()
            c = counted(label, fn)
            log(f"user: {label} took {time.perf_counter() - t0:.1f} s")
            for n in launches:
                launches[n] += c[n]
        check_png(png, "cli sample")
        for name in ("interpolation.png", "mixgrid.png"):
            check_png(os.path.join(wd, cfg.run.sample_dir, name), name)
        cache = os.listdir(os.path.join(wd, "fid_cache"))
        if len(cache) != 1:
            raise AssertionError(f"eval-fid: real-feature cache {cache}")
        folders = folder_sources(img_dir, card)
        memory = remat_memory(card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, phases=checked["phases"],
                peak_gib=run["peak_gib"], save=save, feed=feed,
                folders=folders, memory=memory, prepare_s=prep_s)


def checkpoint_save_time(state, root: str, card: str) -> dict:
    """Wall time of one synchronous ``CheckpointManager.save`` of the
    1024x1024 state (the loop stalls this long at every checkpoint)."""
    from ganlab_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(os.path.join(root, "save_probe"), keep=1)
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step + i, state)
        times.append((time.perf_counter() - t0) * 1e3)
    size = os.path.getsize(mgr.path(state.step + 1)) / 2 ** 20
    log(f"user: one synchronous checkpoint save of the 1024x1024 state "
        f"({size:.1f} MiB): {times[0]:.1f} ms, again {times[1]:.1f} ms "
        f"[{card}]")
    return dict(ms=times, mib=size)


def host_feed(cfg, phases, shard_dir: str, card: str) -> dict:
    """Host ms to make one batch of the ``npy`` source (the native gather
    from the exact-resolution shard) at each phase's resolution and batch,
    median of 5."""
    from ganlab_tpu_torch.data import NpySource

    src = NpySource(shard_dir, seed=5)
    out = {}
    for ph in phases:
        if ph.resolution in out:
            continue
        reads = []
        for _ in range(5):
            t0 = time.perf_counter()
            src.batch(ph.batch_size, ph.resolution)
            reads.append((time.perf_counter() - t0) * 1e3)
        out[ph.resolution] = statistics.median(reads)
    log("user: host ms per npy batch through the native gather (median of "
        "5): " + ", ".join(f"{r}x{r} batch {cfg.schedule.batch_for(r)} "
                           f"{t:.2f}" for r, t in out.items()) + f" [{card}]")
    return out


def folder_sources(img_dir: str, card: str) -> dict:
    """``image_folder`` (decoded once at startup) and
    ``image_folder_stream`` (decoded by 8 DataLoader workers) serve a few
    batches from the PNG folder: ms per batch on the card's host."""
    from ganlab_tpu_torch.config import DataConfig

    out = {}
    for name in ("image_folder", "image_folder_stream"):
        t0 = time.perf_counter()
        src = make_source(DataConfig(dataset=name, data_dir=img_dir), 1024,
                          seed=3)
        setup_ms = (time.perf_counter() - t0) * 1e3
        try:
            for res, b in ((1024, 4), (256, 8)):
                reads = []
                for i in range(6):
                    t0 = time.perf_counter()
                    x = src.batch(b, res)
                    reads.append((time.perf_counter() - t0) * 1e3)
                    if x.shape != (b, res, res, 3) or x.dtype != np.uint8:
                        raise AssertionError(f"{name}: batch {x.shape}")
                out[(name, res)] = dict(first_ms=reads[0],
                                        ms=statistics.median(reads[1:]))
                log(f"user: {name} at {res}x{res} batch {b}: first batch "
                    f"{reads[0]:.1f} ms, then median "
                    f"{statistics.median(reads[1:]):.1f} ms per batch "
                    f"(set-up {setup_ms:.0f} ms) [{card}]")
        finally:
            close = getattr(src, "close", None)
            if close is not None:
                close()
    return out


def remat_memory(card: str) -> dict:
    """A 1024x1024 stabilize step of the full-width preset at its batch of
    4, with remat as the preset sets it and with ``model.remat=False``:
    peak device memory over one R1-on and two R1-off steps, and the step
    times; one R1-off step with remat profiled."""
    out = {}
    for remat in (True, False):
        cfg = get_config("stylegan-1024", **{"model.remat": remat})
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        b = phase.batch_size
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        state = create_train_state(cfg, seed=0)
        stepper = make_lazy_stepper(cfg, phase)
        gdata = torch.Generator(device="cuda").manual_seed(11)
        real = torch.randint(0, 256, (b, 1024, 1024, 3), generator=gdata,
                             device="cuda", dtype=torch.uint8)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = stepper(state, real)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(float(v)) for v in m.values()):
                raise AssertionError(f"remat {remat}: metrics {m}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 - base
        out[remat] = dict(peak_gib=peak, ms=ms)
        log(f"user: 1024x1024 stabilize steps at batch {b}, remat {remat}: "
            f"peak {peak:.2f} GiB above the {base:.2f} GiB held before; "
            f"R1-on {ms[0]:.1f} ms (first), R1-off {ms[1]:.1f}, {ms[2]:.1f} "
            f"ms [{card}]")
        if remat:
            profile_call("one R1-off 1024x1024 step at batch 4 (remat)",
                         lambda: stepper(state, real), card, top=8)
        del state, stepper, real
    return out


# -- 9. Inception at full size -----------------------------------------------------
def phase_inception(card: str) -> dict:
    """One ``InceptionExtractor`` forward (random weights with non-trivial
    batch-norm statistics, as a weights file would give) on 64 images of
    1024x1024, resized to 299 in the module; ms per 64 images by CUDA
    events, and finite features of the expected shape."""
    from ganlab_tpu_torch.eval import InceptionExtractor
    from ganlab_tpu_torch.eval.inception import inception_spec

    gen = torch.Generator().manual_seed(0)
    sd = {}
    for name, cin, cout, kh, kw in inception_spec():
        sd[f"{name}.conv.weight"] = torch.randn(
            cout, cin, kh, kw, generator=gen) * math.sqrt(2 / (cin * kh * kw))
        sd[f"{name}.bn.weight"] = 1 + 0.2 * torch.randn(cout, generator=gen)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(cout, generator=gen)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(cout,
                                                          generator=gen)
        sd[f"{name}.bn.running_var"] = 0.5 + torch.rand(cout, generator=gen)
    net = InceptionExtractor(state_dict=sd).cuda()
    x = torch.rand(64, 3, 1024, 1024, generator=gen).cuda() * 2 - 1
    with torch.inference_mode():
        feats = net(x)
        ms = cuda_time_ms(lambda: net(x), iters=5, warmup=2)
    if feats.shape != (64, 2048) or not bool(feats.isfinite().all()):
        raise AssertionError(f"inception: features {tuple(feats.shape)}")
    log(f"inception: pool3 of 64 images 1024x1024 -> 299 (float32, TF32 "
        f"off): {ms:.2f} ms per 64 images, features std "
        f"{feats.std().item():.4f} [{card}]")
    return dict(ms_per_64=ms)


# -- 3b. offsets beyond 2^31 elements ------------------------------------------------
LARGE = {"upsample_blur_2x": (64, 32, 512, 512),      # out: 2^31 elements
         "blur_downsample_2x": (128, 16, 1024, 1024),  # in: 2^31 elements
         "adain": (128, 16, 1024, 1024)}               # in and out: 2^31


def check_large_offsets() -> float:
    """The kernels on tensors of 2^31 elements (a served batch of 64 at
    512x512 / 128 at 1024x1024, bf16): the first and the last planes of
    the output against the plain version on those planes alone, so that
    an offset that wraps at 2^31 shows."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    with torch.inference_mode():
        for name, shape in LARGE.items():
            k = KERNELS[name]
            inp = k["inputs"](shape, torch.bfloat16, g)
            out = k["kernel"](*inp)
            path = (adain_path(inp[0], out) if name == "adain"
                    else RESAMPLE_PATHS[name](inp[0], out))
            for sl in (slice(0, 1), slice(shape[0] - 1, shape[0])):
                part = tuple(a[sl] for a in inp)
                worst = max(worst, _check(
                    f"{name} {shape} bf16 [{path}] image {sl.start}",
                    out[sl], k["plain"](*part), torch.bfloat16,
                    f" ({max(inp[0].numel(), out.numel())} elements)"))
            del inp, out
            torch.cuda.empty_cache()
    return worst


def main(kernels_only: bool = False) -> None:
    kind, card = phase_device()
    phase_build()
    mc = get_config("stylegan-256").model
    cfg1k = get_config("stylegan-1024")
    mk, b1k = cfg1k.model, cfg1k.schedule.batch_for(1024)
    results = phase_kernels({
        SERVED: serving_shapes(mc), STEP: step_launches(mc, r1=False),
        SERVED_1K: serving_shapes(mk, batch=SERVE_1K_BATCH),
        STEP_1K: step_launches(mk, r1=False, batch=b1k)})
    large_err = check_large_offsets()
    if kernels_only:
        log(f"--kernels-only: stopping after the kernel phase [{card}]")
        return
    phase_gradients()
    serve_counts = phase_serving(card)
    train = phase_training(card)
    trainer = phase_trainer(card)
    user = phase_user_data(card)
    phase_inception(card)
    kernels = []
    for name, k in KERNELS.items():
        r = results[name]
        per = SERVED if SERVED in r else STEP
        u, st, s1k = r[per], r[STEP], r[STEP_1K]
        tl = train["launches"][name]
        pl = trainer["launches"][name]
        ul = user["launches"][name]
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": serve_counts.get(name, 0) + tl + pl + ul,
            "launches_serving": serve_counts.get(name, 0),
            "launches_training": tl,
            "launches_trainer": pl,
            "launches_user_path_1024": ul,
            "launches_per_step": {"r1_off": train["expect"][False][name],
                                  "r1_on": train["expect"][True][name]},
            "fwd_route": k["route"], "bwd_route": BWD_ROUTE[name],
            "max_abs_err": max(r["max_abs_err"], large_err
                               if name in LARGE else 0.0),
            "ms": u["ms"],
            "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
            "bound_by": u["bound_by"], "library_ms": u["library_ms"],
            "ms_per": per,
            "device_ms": u["device_ms"], "host_us": u["host_us"],
            "library_device_ms": u["library_device_ms"],
            "library_host_us": u["library_host_us"],
            "ms_per_step": st["ms"], "bound_ms_per_step": st["bound_ms"],
            "device_ms_per_step": st["device_ms"],
            "plain_ms_per_step": st["plain_ms"],
            "library_ms_per_step": st["library_ms"],
            "ms_per_step_1024": s1k["ms"],
            "bound_ms_per_step_1024": s1k["bound_ms"],
            "device_ms_per_step_1024": s1k["device_ms"],
            "plain_ms_per_step_1024": s1k["plain_ms"],
            "library_ms_per_step_1024": s1k["library_ms"]})
    log(f"kernel times (ms, plain_ms, library_ms, device_ms, bound_ms) are "
        f"summed over the launches of one served batch of {BATCH} "
        f"(pixelnorm, AdaIN, up+blur) or one R1-off training step at batch "
        f"{BATCH} (blur+down, mbstd; *_per_step for all five) of "
        f"stylegan-256, *_per_step_1024 over one R1-off step of "
        f"stylegan-1024 at batch {b1k} (remat), bf16; host_us is per call "
        f"[{card}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        raise SystemExit(__doc__)
    main(kernels_only=bool(sys.argv[1:]))
    sys.exit(0)

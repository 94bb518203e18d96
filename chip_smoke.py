#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training-step, progressive-trainer,
user-data, ProGAN / ResNet-GAN, StyleGAN2, accumulation, data-parallel,
export, ADA, projector, step-recipe, chunked-stepping, composed
upsample + conv and width-folded paths on one NVIDIA GPU.

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
   clusters of 16 blocks) and of a served batch of 16 at 1024x1024, at
   every shape of a progan-128 step (pixelnorm over the channels of NCHW at batch 16 from
   4x4 to 64x64 and at batch 8 to 128x128; mbstd at batch 16 and 8), and
   at a few odd shapes, in float32 (TF32 off) and bfloat16, with the path
   each call took; the NCHW pixelnorm also bit for bit against the rows
   kernel on the same values transposed, from an unaligned copy, from
   a strided view, and with the run kernel forced (all the same bits); mbstd on both its paths, with the batch held
   in registers and read twice, bit-equal across two calls and with fewer
   blocks than its cluster of 8; the resample kernels also
   with a gain, and each one's vector path against its element path bit
   for bit; at every shape a unit launches channels-last (the StyleGAN2
   G's and every D's: ``step_launches(..., channels_last=True)``) also
   on channels-last memory, which takes the NHWC paths: against the plain
   version, at the gain, bit for bit against the NCHW call and from an
   unaligned copy (the NHWC element path), and timed there beside the
   NCHW kernel (``time ... nhwc`` lines), so each unit's sums add the
   layout its launches run in; AdaIN on each of its paths, at an
   unaligned pointer, on
   constant planes and on planes with a large mean (the split path also
   forced on 1024² planes, and taken by planes of 72 and 144 MiB);
   ``variants`` lines read forced cuts in turns:
   AdaIN with one block against a thread block cluster per 256² plane, the
   earlier plans (a cluster of 4 x 1024 threads at 512², the loop path at
   1024²) against other clusters and the split path at 512² and 1024²
   (bf16 and float32); the NCHW
   pixelnorm's run kernel against its tile kernel at its four large
   ProGAN shapes. Then kernel, plain and
   one library call timed with CUDA events around back-to-back calls
   (``ms``), beside the bound (bytes / 3.35 TB/s or flops / 67 TFLOP/s,
   the larger); the kernel and the
   library call also on the device alone (``device_ms``, a CUDA-graph
   replay of the same calls) and on the host alone (``host_us``, wall
   time per un-synchronised call). Sums per served batch and per R1-off
   training step of each preset. Then up+blur, blur+down, AdaIN and the
   NCHW pixelnorm on tensors of 2^31 elements (AdaIN also through its
   split path, the NCHW pixelnorm also through its run kernel): first
   and last planes against the plain version, so that an offset that
   wraps at 32 bits shows.
4. Gradients: each autograd Function's gradient against autograd through
   its plain version on the card (float32); the resample Functions'
   backwards must each be one device kernel (the gain rides in the
   kernel's store); then a second-order R1-shaped derivative through the
   resample and mbstd Functions, against the same chain of plain versions;
   WGAN-GP's gradient through a ProGAN D (mbstd, average pools, a fade)
   on the card against the CPU.
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
   ``cli sample``, ``interpolate``, ``mixgrid``, ``eval-fid --metrics
   fid,kid,pr`` (random-conv features) and ``eval-fid --metrics ppl`` (w
   space, random VGG16), each with the launch counts read around it.
   Then the time of one synchronous checkpoint save, the host's ms per ``npy`` batch through the native gather, ``image_folder`` and
   ``image_folder_stream`` batches from the PNG folder, and peak memory
   of 1024x1024 steps with and without remat.
9. ProGAN and ResNet-GAN at full width: ``cli train --preset
   progan-128`` through its 11 phases 4x4 -> 128x128 at the preset's
   batches 16 / 8 on ``ellipses``, cut in length only (8 steps a phase, 16
   at 128x128), WGAN-GP and drift every step: launch counts per step as
   derived (pixelnorm 1 + 2 + 2 (lg - 2) a G forward, mbstd once a D
   forward), alpha, finite losses, resume bit for bit, serving from the
   workdir; one 128x128 step profiled (idle share); ``cli sample``; ``cli
   eval-ppl --space z`` (256 samples, random VGG16); ``BatchSampler`` on
   the G-EMA at batch 32; one float32 WGAN-GP step card vs CPU;
   ``progan-64`` (R1 every step) and ``resnetgan-cifar10`` (WGAN-GP,
   batch 64, ``synthetic``) for 24 steps each; ``resnetgan-cifar10`` with
   ``loss.d_steps_per_g=5``, G changing only on every fifth step.
10. StyleGAN2 at full width (``stylegan2-256``: modulated convs, skip
    G, residual D, path-length regularization; bf16, seeded random
    weights with every term live, the toRGB and style affine weights
    perturbed): ``BatchSampler`` at batch 32 (launches per batch as
    derived: 1 pixelnorm, 12 up+blur; a float32 pair card vs CPU; img/s,
    latency, idle share); ``cli train --preset stylegan2-256`` on the
    preset's own ``synthetic`` data at its batch of 8 for 48 steps, R1 at
    0, 16, 32 and path length every 4th (three step programs), every
    step's launches against ``stylegan2_step_launches``, ``pl_penalty`` >
    0 exactly on PL steps, ``pl_mean`` off 0, ms per step of each program,
    img/s per 16-step cycle, peak memory; resume bit for bit across the
    R1 + PL step 48; one step of each program profiled, the PL term's
    forward and outer backward timed, the backward's share in cuDNN's
    convolutions; an R1 + PL step of a narrow 32² model in float32 card
    vs CPU (1e-3 of each leaf's scale, the mapping layers included);
    ``cli sample`` and ``cli eval-ppl --space w`` (64 pairs at 256²).
    Phase 3 checks and times the kernels at every StyleGAN2 shape (the
    3-channel skip RGBs at batch 32, 8 and 4, the residual D's blur+downs
    at batch 8) and phase 4 adds a path-length-shaped second derivative
    through the resample Functions.
11. Gradient accumulation, data parallelism and the exported sampler,
    at full width, bf16: the fixed-256² stylegan-256 step with
    ``optim.grad_accum`` = 2 at a microbatch of 16 (an R1-on and an
    R1-off step, launches twice a microbatch's); a stylegan2-256
    path-length step with two microbatches of 8 (``pl_mean`` chained at
    the decay 1 - (1 - pl_decay)^(1/2)); two ranks spawned over ``gloo``
    on the one card with identical shards of 16 for three steps (states
    bitwise identical, first-step gradients against the one-process
    ``grad_accum`` = 2 step within 1e-2 of each leaf's scale; two ranks
    sharing a card read correctness, not a data-parallel speed);
    stylegan-1024 at its preset batch of 4 with remat and ``grad_accum``
    = 4 in its 1024² phase (three steps, peak memory); ``export_sampler``
    -> ``ExportedSampler`` for stylegan-256 (cuda and cpu programs;
    images against ``BatchSampler``'s within one level and more than
    99% equal; the loaded program's launches per batch; img/s of both at
    a batch of 32). Phase 3 also holds each ``torch.ops.ganlab``
    operator bit for bit to its launching wrapper, times the kernels
    through the operators (``host_us``) and the wrappers alone
    (``wrapper_host_us``), and reads the host's time a call of the rows
    pixelnorm as a ``torch.library.custom_op`` beside the operator.
12. One ``InceptionExtractor`` forward on 64 images of 1024x1024 (random
    weights), ms per 64 images.
13. ADA (``aug.mode=ada``) at the bench.py configuration, full width: the
    step without augmentation, with ``bc`` and with ``bcgfnu``, R1-off and
    R1-on, read in turns (ms a step, the augmentation's own device time
    by CUDA events, peak memory, one profiled step of each); the launches
    of our kernels a step as without augmentation; p moving by the rule
    from the step's rt; the augmentation on the card against the CPU on
    one set of params at 256² (values and VJP within 1e-5 of the scale)
    and its backward the same bits twice; a bitwise resume with
    ``ada_p``; ``cli train --set aug.mode=ada --set aug.categories=bcgfnu``
    through 8x8 -> 32x32; two gloo ranks with ADA against one process
    accumulating two.
14. The projector: ``project`` in W+ at 256² (8 restarts of a pool of 64,
    300 steps, float32) on a target the G-EMA made: ms a step, the loss
    falling, launch counts as derived; ``cli project --optimize-noise`` on
    a PNG; a ``run.profile`` trainer run whose trace names the
    ``ganlab::`` operators and our kernels.
15. The opt-in step recipes at the bench.py configuration, full width:
    the sequential step, ``loss.reg_separate``, ``loss.fused_seq`` and
    ``loss.fused_g_step``, R1-off and R1-on, read in turns (ms a step,
    the launches of our kernels a step against ``step_launches(...,
    recipe=)``, D's Adam count +2 on a ``reg_separate`` R1 step, peak
    memory, one profiled step of each: device busy, idle share); one
    float32 step of each recipe card vs CPU (stylegan-256 and
    stylegan2-256 with path length, 32²); ``reg_separate`` on progan-128
    at 128² (WGAN-GP and drift every step: two D updates a step);
    ``fused_seq`` against the sequential R1-on step at 1024² (remat, batch
    4: peak memory); ``cli train --set loss.<recipe>=true`` chunked (the
    default), three cycles at 8² (the off-run captured and replayed) and
    two steps of the 16² fade, each stepper call's launches as derived;
    two gloo ranks under ``fused_seq`` against one process accumulating
    two.
16. Chunked stepping (``run.chunk_steps``, ``make_chunked_stepper``)
    with each cycle's off-run replayed as a CUDA graph, full width, bf16,
    deterministic cuDNN: the eager lazy stepper and the graphed chunked
    stepper from one seed over the same batches (cycles of 16 steps and a
    2-step tail; the first cycle runs eagerly, the second captures), the
    states and the stacked metrics bit for bit and the launches of our
    kernels equal (a replay adds its captured launches to the counts), at
    the bench.py configuration (a replayed cycle's launches read from the
    counts and held to those derived: ``launches_per_cycle``), at the 8x8
    and 64x64 stabilize phases of the progressive preset (batch 32), on
    stylegan2-256 (path length every 4: the off-run in 3-step segments),
    under ADA ``bcgfnu`` (``ada_p`` through the replays) and under
    ``loss.fused_g_step``; ms a step over a cycle eager and graphed, the
    host's time a cycle, the idle share of a profiled graphed cycle,
    capture seconds, the graph pool's bytes, peak memory; ``cli train
    --preset stylegan-256`` 8x8 -> 32x32 with ``run.chunk_steps`` at
    its default and set to False (img/s a phase by the loop's clock;
    chunked: each stepper call's launches as derived, a graph captured a
    phase, ``train.jsonl`` rows at the JAX package's chunk rule); a step
    that reads the host raises at capture; capturable Adam's update
    against the default one's. The cli runs of phases 7-14 pin
    ``run.chunk_steps=False``: they count launches a step.
17. The composed upsample + conv (``model.fused_up_conv``: dilated,
    ``'poly'``, ``'hybrid'``), full width: each form of ``up2_conv2d``
    against the two-op form (the up+blur kernel or the nearest upsample,
    then ``F.conv2d``) at the first conv of every G block of stylegan-256
    (batch 32), stylegan-1024's 512² and 1024² blocks (batch 4) and
    progan-128 (batch 8), float32, TF32 off, within 1e-4 of the scale; the
    hybrid's gradients against autograd through the two-op form; the
    bench.py step under the two-op form and each composed form in turns
    (ms per R1-off and R1-on step, device busy, idle share, peak memory,
    launches a step against ``step_launches``, which reads the form);
    ``BatchSampler`` at batch 32 under each form (img/s, latency) and its
    bf16 images against the float32 two-op images (no more than twice the
    bf16 two-op error); one eager lazy / graphed chunked pair at 256²
    under the dilated form, bit for bit; stylegan-1024 at 1024², batch 4,
    remat off and on, two-op against dilated (peak memory, ms an R1-off
    step); progan-128 at 128², batch 8, two-op / dilated / poly (ms a
    step; ``'hybrid'`` raises ``ValueError``); the exported sampler under
    dilated against ``BatchSampler`` under dilated, the same bits. A
    script may call ``phase_fused(card)`` alone after ``phase_device()``
    and ``phase_build()``.
18. The width-folded blocks (``model.fold_width``; plain PyTorch, as in
    the JAX package, so a folded block launches none of our kernels),
    full width: the bench.py step with fold off and on in turns (ms per
    R1-off and R1-on step, busy, idle share, peak memory, launches a step
    against ``step_launches``, which reads ``cfg.fold_block``);
    ``BatchSampler`` at batch 32 fold off and on (img/s, latency; float32
    images within 1e-4 of the scale, bf16 within twice fold off's error);
    the D's scores likewise; the exported folded sampler against
    ``BatchSampler``, the same bits; one eager lazy / graphed chunked pair
    at 256² under fold, bit for bit; stylegan-1024 at 1024², batch 4,
    remat, fold off and on (six folded blocks: ms R1-off and R1-on, peak
    memory); a float32 folded step of stylegan-256 and progan-128 at 32²,
    card against CPU. A script may call ``phase_fold(card)`` alone after
    ``phase_device()`` and ``phase_build()``.
19. One JSON line of per-kernel numbers, then the final ``{"ok": true,
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
import types

import numpy as np
import torch
import torch.nn.functional as F

from ganlab_tpu_torch import BatchSampler, build_generator, get_config
from ganlab_tpu_torch import cli as port_cli
from ganlab_tpu_torch import models as port_models
from ganlab_tpu_torch import ops as port_ops
from ganlab_tpu_torch.data import make_source
from ganlab_tpu_torch.export import ExportedSampler, export_sampler
from ganlab_tpu_torch.models.layers import up2_form
from ganlab_tpu_torch.ops.equalized import HYBRID_NEAREST
from ganlab_tpu_torch.ops.kernels import COUNTS, _build
from ganlab_tpu_torch.ops.kernels.adain import (
    ADAIN,
    adain_cuda,
    adain_path,
    adain_ref,
)
from ganlab_tpu_torch.ops.kernels.mbstd import (
    MINIBATCH_STDDEV,
    minibatch_stddev_cuda,
    minibatch_stddev_path,
    minibatch_stddev_ref,
)
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    PIXEL_NORM,
    PIXEL_NORM_NCHW,
    pixel_norm_cuda,
    pixel_norm_nchw_cuda,
    pixel_norm_nchw_path,
    pixel_norm_nchw_ref,
    pixel_norm_ref,
)
from ganlab_tpu_torch.ops.kernels.resample import (
    BLUR_DOWNSAMPLE_2X,
    UPSAMPLE_BLUR_2X,
    blur_downsample_2x_cuda,
    blur_downsample_2x_path,
    blur_downsample_2x_ref,
    upsample_blur_2x_cuda,
    upsample_blur_2x_path,
    upsample_blur_2x_ref,
)
from ganlab_tpu_torch.ops.layout import is_channels_last
from ganlab_tpu_torch.ops.upfirdn import BLUR_TAPS
from ganlab_tpu_torch.parallel import dist as pdist
from ganlab_tpu_torch.sample import build_sample_fn
from ganlab_tpu_torch.train import (
    CheckpointManager,
    Trainer,
    build_phases,
    create_train_state,
    make_lazy_stepper,
    state_tensors,
)
from ganlab_tpu_torch.train import loop as train_loop
from ganlab_tpu_torch.train import steps as train_steps
from ganlab_tpu_torch.train.state import optimizer_hparams

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
WGAN_GP_GRAD_RTOL = 1e-3       # WGAN-GP's gradient leaves, card vs CPU
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
    2^res_log2 (the serving path runs it at the model's full resolution).
    Under ``model.fused_up_conv`` (any form) no block launches up+blur: the
    upsample is composed into the block's first conv. A block that
    ``model.fold_width`` folds (``mc.fold_block``) launches neither AdaIN
    nor up+blur: its folded ops are plain PyTorch, as in the JAX package."""
    top = mc.res_log2 if res_log2 is None else res_log2
    adain = {}
    for lg in range(2, top + 1):
        if lg > 2 and mc.fold_block(lg):
            continue
        s = (batch, mc.nf(lg - 1), 2 ** lg, 2 ** lg)
        adain[s] = adain.get(s, 0) + 2
    out = {"pixelnorm": {(batch, mc.latent_dim): 1}, "adain": adain}
    if not mc.fused_up_conv:
        out["upsample_blur_2x"] = _block_shapes(
            mc, unfolded_blocks(mc, top), batch)[1]
    return out


def unfolded_blocks(mc, res_log2: int, d: bool = False) -> list:
    """The res_log2 of each block from 8x8 up that ``model.fold_width``
    leaves unfolded: in the G, or with ``d`` in the D, whose residual
    blocks never fold (``mc.d_resnet``)."""
    return [lg for lg in range(3, res_log2 + 1)
            if not (mc.fold_block(lg) and not (d and mc.d_resnet))]


def _block_shapes(mc, blocks, batch) -> tuple:
    """({shape: 1} at each block's 2^lg plane of nf(lg - 2) channels,
    {shape: 1} at its 2^(lg - 1) plane): a G block's up+blur output and
    input, a D block's blur+down input and output."""
    return ({(batch, mc.nf(lg - 2), 2 ** lg, 2 ** lg): 1 for lg in blocks},
            {(batch, mc.nf(lg - 2), 2 ** (lg - 1), 2 ** (lg - 1)): 1
             for lg in blocks})


def _add(total: dict, part: dict) -> None:
    for name, shapes in part.items():
        for shape, n in shapes.items():
            d = total.setdefault(name, {})
            d[shape] = d.get(shape, 0) + n


RECIPES = ("sequential", "reg_separate", "fused_seq", "fused_g_step")


def step_launches(mc, r1: bool, res_log2=None, batch=BATCH,
                  recipe: str = "sequential",
                  channels_last: bool = False) -> dict:
    """kernel -> {shape: launches} of one training step at 2^res_log2 (the
    model's full resolution when None) and ``batch``, derived from the
    model's structure (``mc``, ``mc.remat``), the step's code and the
    step recipe (``RECIPES``: the sequential step or ``loss.<recipe>``).
    ProGAN's step is ``progan_step_launches`` (its penalty runs every
    step, ``r1`` is not read); ResNet-GAN launches none of these kernels.
    A fade phase adds no launch: its extra toRGB / fromRGB, nearest
    upsample, average pool and blend are plain PyTorch. At one batch
    throughout, every shape of a lower resolution's step is one of the
    full resolution's.

    * G forward: one pixelnorm over the 2B rows of concat([z1, z2]), two
      AdaIN per resolution, one up+blur per block from 8x8 up;
    * D forward: one blur+down per block, one mbstd;
    * D backward (to its parameters or its input): each blur+down's
      backward is UpsampleBlur2x with gain 1/4 at the block's output
      shape; mbstd's backward is plain PyTorch;
    * G backward: each up+blur's backward is BlurDownsample2x with gain 4
      at the block's upsampled shape; AdaIN's and pixelnorm's are plain.

    Sequential: the D phase runs a G forward (no grad), D on real and on
    fake and one backward of both; the G phase a G forward, a D forward
    and the backward through D into G. An R1 step adds D on real once
    more and its create-graph backward; the double backward then runs the
    backward of every first-order UpsampleBlur2x node (blur+down at the
    block shapes) and of every blur+down node of that D forward (up+blur).

    * ``reg_separate``: the sequential step's launches. Its second D
      update is R1 alone, which runs the same D forward and backwards as
      R1 inside the first; off a penalty step it is the sequential step.
    * ``fused_seq``: one G forward fewer: the D phase's G forward (with
      autograd) is the G phase's too.
    * ``fused_g_step``: one G forward; D on real and on the fakes once
      (both losses read its scores); D's backward to its parameters over
      both forwards, then G's backward through the fakes' D forward to the
      images and through G; R1 as above.

    ``channels_last``: only the launches on channels-last memory, which
    the D's resample kernels make (``ProDiscriminator`` runs channels-
    last, its mbstd NCHW; StyleGAN's G runs NCHW).

    With ``model.remat`` each block is recomputed in the backward, up to
    its last tensor the backward needs (``torch.utils.checkpoint`` stops
    there): a synthesis block's up+blur and its two AdaIN run again in
    G's backward (once under every recipe); a D block ends in blur+down,
    which saves nothing, so its recompute launches no kernel of ours (the
    CPU tests count this on a small model, every recipe:
    tests/test_torch_remat_launches.py).

    ``model.fused_up_conv`` composes each synthesis block's upsample into
    its first conv. Dilated (True) and ``'poly'``: no up+blur in G's
    forward (nor in remat's recompute) and no blur+down in G's backward.
    ``'hybrid'``: the forward is the dilated one, and G's backward runs
    the two-op backward, one up+blur (the upsampled input made again) and
    one blur+down (gain 4, to the block's input) a block; remat's
    recompute adds the two AdaIN a block alone (tests/test_torch_up2conv.
    py counts each form).

    ``model.fold_width``: a folded block's ops are plain PyTorch. A folded
    G block launches no AdaIN and no up+blur (so nothing in G's backward
    or remat's recompute either, whatever the form); a folded D block no
    blur+down, so none of the D backwards' up+blur nor R1's blur+down at
    its shapes (tests/test_torch_folded.py counts this).
    """
    if recipe not in RECIPES:
        raise ValueError(f"recipe {recipe!r}: one of {RECIPES}")
    if mc.model == "progan":
        return progan_step_launches(mc, res_log2, batch, recipe)
    if mc.model == "resnetgan":
        return {}
    lg = mc.res_log2 if res_log2 is None else res_log2
    g_down, g_up = _block_shapes(mc, unfolded_blocks(mc, lg), batch)
    down, up = _block_shapes(mc, unfolded_blocks(mc, lg, d=True), batch)
    serve = serving_shapes(mc, lg, batch)
    form = up2_form(mc.fused_up_conv)
    g_fwd = {"pixelnorm": {(2 * batch, mc.latent_dim): 1},
             "adain": serve["adain"]}
    d_fwd = {"blur_downsample_2x": down,
             "minibatch_stddev": {(batch, mc.nf(1), 4, 4): 1}}
    d_bwd = {"upsample_blur_2x": up}
    g_bwd = {"blur_downsample_2x": g_down}
    if form is None:
        g_fwd["upsample_blur_2x"] = g_up
    elif form == "hybrid":                           # the two-op backward
        g_bwd = {"blur_downsample_2x": g_down, "upsample_blur_2x": g_up}
    else:
        g_bwd = {}
    if recipe == "fused_g_step":
        parts = [g_fwd, d_fwd, d_fwd, d_bwd, d_bwd,  # D's loss
                 d_bwd, g_bwd]                       # G's, through D
    else:
        parts = [g_fwd, d_fwd, d_fwd, d_bwd, d_bwd,  # D phase
                 d_fwd, d_bwd, g_bwd]                # G phase
        if recipe != "fused_seq":
            parts.append(g_fwd)                      # G phase's forward
    if mc.remat:                                     # G backward's recompute
        parts.append({"adain": {s: n for s, n in serve["adain"].items()
                                if s[2] > 4},
                      **({"upsample_blur_2x": g_up} if form is None else {})})
    r1_down = {"blur_downsample_2x": down}
    if r1:
        parts += [d_fwd, d_bwd, r1_down, d_bwd]
    if channels_last:
        parts = [_resample_only(p) for p in parts
                 if any(p is d for d in (d_fwd, d_bwd, r1_down))]
    total: dict = {}
    for part in parts:
        _add(total, part)
    return total


def _resample_only(launches: dict) -> dict:
    """The resample kernels' launches of ``launches``."""
    return {n: v for n, v in launches.items() if n in RESAMPLE_PATHS}


def progan_g_launches(mc, res_log2=None, batch=BATCH) -> dict:
    """kernel -> {shape: launches} of one ProGAN G forward at 2^res_log2:
    pixelnorm of z (rows kernel), then over the channels twice in the 4x4
    block and twice in each block from 8x8 up (channel kernel). Every
    ``model.fused_up_conv`` form gives the same: the nearest upsample it
    composes into a block's first conv is plain PyTorch either way
    (``'hybrid'``, blur taps only, raises as the G does, unless every block
    folds). A block that ``model.fold_width`` folds launches no pixelnorm:
    its ``pixel_norm_folded`` is plain PyTorch."""
    lg = mc.res_log2 if res_log2 is None else res_log2
    blocks = unfolded_blocks(mc, lg)
    if blocks and up2_form(mc.fused_up_conv) == "hybrid":
        raise ValueError(HYBRID_NEAREST)
    nchw = {}
    for l in [2] + blocks:
        s = (batch, mc.nf(l - 1), 2 ** l, 2 ** l)
        nchw[s] = nchw.get(s, 0) + 2
    return {"pixelnorm": {(batch, mc.latent_dim): 1, **nchw},
            "pixelnorm_nchw": dict(nchw)}


def progan_step_launches(mc, res_log2=None, batch=16,
                         recipe: str = "sequential") -> dict:
    """kernel -> {shape: launches} of one ProGAN training step at
    2^res_log2 and ``batch`` with its penalty (WGAN-GP or R1) on, as both
    ProGAN presets run it every step.

    * G forward: pixelnorm of z over its last axis (rows kernel, one
      launch), then pixelnorm over the channels of NCHW twice in the 4x4
      input block and twice in each block from 8x8 up (channel kernel):
      1 + 2 + 2 (lg - 2), all counted as pixelnorm, 2 + 2 (lg - 2) of them
      as pixelnorm_nchw. A fade phase adds none (the previous toRGB, the
      nearest upsample and the blend are plain PyTorch).
    * D forward: one mbstd; the D's blocks average-pool (plain PyTorch).
    * Every backward (pixelnorm's, mbstd's, and the penalty's double
      backward through them) is plain PyTorch: no launch.

    Sequential (and ``reg_separate``, whose second D update runs the
    penalty's D forward that the first left out): the D phase runs a G
    forward (no grad), D on real, on fake and on the penalty's input
    (WGAN-GP's interpolates, R1's real batch); the G phase a G forward
    and D on the fakes. ``fused_seq``: one G forward fewer.
    ``fused_g_step``: one G forward, D on real, on the fakes (both losses)
    and on the penalty's input. ``model.fused_up_conv`` changes none of
    these (``progan_g_launches``)."""
    g_fwd = progan_g_launches(mc, res_log2, batch)
    d_fwd = {"minibatch_stddev": {(batch, mc.nf(1), 4, 4): 1}}
    parts = {"sequential": [g_fwd, d_fwd, d_fwd, d_fwd, g_fwd, d_fwd],
             "reg_separate": [g_fwd, d_fwd, d_fwd, d_fwd, g_fwd, d_fwd],
             "fused_seq": [g_fwd, d_fwd, d_fwd, d_fwd, d_fwd],
             "fused_g_step": [g_fwd, d_fwd, d_fwd, d_fwd]}[recipe]
    total: dict = {}
    for part in parts:
        _add(total, part)
    return total


def _sg2_shapes(mc, lg: int, batch: int) -> dict:
    """The resample shapes of a StyleGAN2 G at 2^lg and ``batch``: the
    up+blur inputs of the blocks' features (``x_up``) and of the skip RGBs
    (``rgb_up``), and the up+blur outputs (``x_dn``, ``rgb_dn``), where
    their backwards (blur+down) read."""
    out = {"x_up": {}, "rgb_up": {}, "x_dn": {}, "rgb_dn": {}}
    for l in range(3, lg + 1):
        for key, c in (("x", mc.nf(l - 2)), ("rgb", mc.img_channels)):
            _add(out, {f"{key}_up": {(batch, c, 2 ** (l - 1),
                                      2 ** (l - 1)): 1},
                       f"{key}_dn": {(batch, c, 2 ** l, 2 ** l): 1}})
    return out


def stylegan2_serving_launches(mc, res_log2=None, batch=BATCH) -> dict:
    """kernel -> {shape: launches} of one StyleGAN2 G forward from z: one
    pixelnorm over the batch's z, one up+blur per block (its features) and
    one per skip RGB, from 8x8 up."""
    lg = mc.res_log2 if res_log2 is None else res_log2
    sh = _sg2_shapes(mc, lg, batch)
    total = {"pixelnorm": {(batch, mc.latent_dim): 1}}
    _add(total, {"upsample_blur_2x": sh["x_up"]})
    _add(total, {"upsample_blur_2x": sh["rgb_up"]})
    return total


def stylegan2_step_launches(mc, r1: bool, pl: bool, res_log2=None,
                            batch=8, pl_batch=4) -> dict:
    """kernel -> {shape: launches} of one StyleGAN2 training step at
    2^res_log2, ``batch`` and the path-length batch ``pl_batch``, derived
    from the model's structure and the step's code.

    * G forward: one pixelnorm over the 2B rows of concat([z1, z2]); one
      up+blur per synthesis block and one per skip RGB (from 8x8 up);
    * D forward (residual blocks where ``mc.d_resnet``): one blur+down per
      branch of each block, one mbstd;
    * D backward: each blur+down's backward is UpsampleBlur2x at the
      block's output shape; G backward: each up+blur's backward is
      BlurDownsample2x at its output shape; pixelnorm's and mbstd's
      backwards are plain PyTorch.

    D phase: G forward (no grad), D on real and on fake, one backward of
    both. G phase: G forward, D forward, backward through D into G. R1
    adds what it adds in ``step_launches``. Path length (``pl``) adds, at
    ``pl_batch``: the mapping's pixelnorm and the synthesis forward; the
    gradient with respect to the styles (create_graph), a backward of
    every up+blur; and in the outer backward the backward of each
    first-order node that carries a gradient with a graph (the blocks'
    features: up+blur again) and of the forward up+blur of the features,
    which the first-order graph reads (blur+down). The skip RGBs'
    first-order backwards act on the projection alone, which has no
    graph, so the outer backward passes neither them nor the forward's
    RGB upsamples."""
    lg = mc.res_log2 if res_log2 is None else res_log2
    per = 2 if mc.d_resnet else 1
    sh = _sg2_shapes(mc, lg, batch)
    d_dn = {s: per for s in sh["x_dn"]}
    d_up = {s: per for s in sh["x_up"]}
    g_fwd = stylegan2_serving_launches(mc, lg, batch)
    g_fwd["pixelnorm"] = {(2 * batch, mc.latent_dim): 1}
    d_fwd = {"blur_downsample_2x": d_dn,
             "minibatch_stddev": {(batch, mc.nf(1), 4, 4): 1}}
    d_bwd = {"upsample_blur_2x": d_up}
    g_bwd = {"blur_downsample_2x": sh["x_dn"]}
    parts = [g_fwd, d_fwd, d_fwd, d_bwd, d_bwd,      # D phase
             g_fwd, d_fwd, d_bwd, g_bwd,             # G phase
             {"blur_downsample_2x": sh["rgb_dn"]}]
    if r1:
        parts += [d_fwd, d_bwd, {"blur_downsample_2x": d_dn}, d_bwd]
    if pl:
        p = _sg2_shapes(mc, lg, pl_batch)
        parts += [stylegan2_serving_launches(mc, lg, pl_batch),
                  {"blur_downsample_2x": p["x_dn"]},
                  {"blur_downsample_2x": p["rgb_dn"]},
                  {"upsample_blur_2x": p["x_up"]},
                  {"blur_downsample_2x": p["x_dn"]}]
    total: dict = {}
    for part in parts:
        _add(total, part)
    return total


def kernel_units(launches: dict) -> dict:
    """A step's launches by the shapes each kernel entry checks and times:
    the pixelnorm entry times the rows kernel on its (rows, C) shapes, the
    NCHW shapes under pixelnorm_nchw (the same launches, counted twice)."""
    out = dict(launches)
    if "pixelnorm" in out:
        out["pixelnorm"] = {s: n for s, n in out["pixelnorm"].items()
                            if len(s) == 2}
    return out


def launch_totals(launches: dict) -> dict:
    """kernel -> launches, for every kernel of KERNELS."""
    return {n: sum(launches.get(n, {}).values()) for n in KERNELS}


@functools.cache
def _blur_filter(c, dtype, norm=16.0):
    """The library calls' depthwise 4x4 filter, made once per (c, dtype):
    a call then copies nothing from the host and can go into a graph."""
    t = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda")
    return (torch.outer(t, t) / norm).to(dtype).expand(c, 1, 4, 4)


def _blur_down_filter(c, dtype):
    return _blur_filter(c, dtype, 64.0)


def _pixelnorm_nchw_library(x):
    """Pixelnorm over dim 1 of NCHW as one PyTorch call: a local response
    norm whose window (2C - 1 channels, zero-padded) covers all C channels
    at every c, so it divides x by (eps + mean_c x^2)^(1/2). Its window
    makes the work C times the kernel's."""
    c = x.shape[1]
    return F.local_response_norm(x, 2 * c - 1, alpha=(2 * c - 1) / c,
                                 beta=0.5, k=1e-8)


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
        op=lambda x: PIXEL_NORM(x, 1e-8),
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=(lambda x: F.rms_norm(x, (x.shape[-1],), eps=1e-8))
        if hasattr(F, "rms_norm") else None,
        nbytes=lambda s, dt: 2 * math.prod(s) * _bsz(dt),
        flops=lambda s: 4 * math.prod(s)),
    # the channel path of the same kernel source; its wrapper also adds to
    # the pixelnorm count above (the kernel's count)
    "pixelnorm_nchw": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/pixelnorm.cu",
        replaces="ganlab_tpu/ops/pallas/pixelnorm.py:64",
        kernel=pixel_norm_nchw_cuda,
        plain=pixel_norm_nchw_ref,
        op=lambda x: PIXEL_NORM_NCHW(x, 1e-8),
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=_pixelnorm_nchw_library,
        nbytes=lambda s, dt: 2 * math.prod(s) * _bsz(dt),
        flops=lambda s: 4 * math.prod(s)),
    "adain": dict(
        route="cuda",
        source="ganlab_tpu_torch/csrc/adain.cu",
        replaces="ganlab_tpu/ops/pallas/adain.py:77",
        kernel=adain_cuda, plain=adain_ref,
        op=lambda x, ys, yb: ADAIN(x, ys, yb, 1e-8),
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
        op=lambda x, gain=1.0: UPSAMPLE_BLUR_2X(x, gain),
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
        op=lambda x, gain=1.0: BLUR_DOWNSAMPLE_2X(x, gain),
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
        op=lambda x: MINIBATCH_STDDEV(x, 1e-8),
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
    "pixelnorm_nchw": "plain PyTorch (analytic VJP)",
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
    # H*W of 1, 15 and 49 (element pixels), C of 3 and 1000 (single
    # channels; planes read twice), a plane of 2 pixels
    "pixelnorm_nchw": [(3, 512, 1, 1), (2, 512, 3, 5), (2, 256, 7, 7),
                       (4, 3, 8, 8), (2, 1000, 4, 4), (2, 1000, 4, 1),
                       (5, 128, 1, 2),
                       # the progan-128 G's sample grids at 128x128: cli
                       # train's final 16 and cli sample --num 4 (their
                       # lower resolutions are the units' shapes or below)
                       (16, 128, 128, 128), (4, 512, 4, 4), (4, 512, 8, 8),
                       (4, 512, 16, 16), (4, 512, 32, 32), (4, 256, 64, 64),
                       (4, 128, 128, 128),
                       # the tile kernel at C = 256, 512 and 1000 with H*W
                       # that ends its last tile ragged (72 and 120 pixels)
                       (2, 256, 9, 8), (3, 512, 10, 12), (2, 1000, 6, 20)],
    "upsample_blur_2x": [(3, 5, 7, 24), (2, 3, 33, 31), (1, 2, 5, 264),
                         (2, 2, 9, 8)],
    "blur_downsample_2x": [(2, 3, 34, 30), (3, 5, 14, 48), (1, 2, 10, 528),
                           (2, 2, 18, 16), (2, 3, 66, 62)],
    # one per path of the kernel and the edges between them: a plane that
    # is no multiple of a vector (loop), 33x31, the largest warp plane
    # (32x32) and the first block plane, a block that ends ragged, a
    # cluster in float32; 1024x1024 (a cluster of 16 with part of each
    # slice in shared memory: 64 KiB in bf16, 192 KiB in float32), planes
    # whose vectors do not split evenly into 16 blocks (724x728,
    # 1000x1048), and planes too large for a cluster (2048x2048: the split
    # path, 4096 slices that end ragged at 1000x2100; check_adain_planes
    # adds a plane above 64 MiB)
    "adain": [(2, 3, 5, 7), (3, 5, 33, 31), (2, 3, 32, 32), (2, 3, 32, 36),
              (2, 3, 48, 48), (1, 2, 256, 256), (1, 2, 1024, 1024),
              (1, 2, 724, 728), (1, 2, 1000, 1048), (1, 1, 2048, 2048),
              (1, 2, 1000, 2100)],
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
PG_STEP_64 = "progan-128 step at 64x64"
PG_STEP_128 = "progan-128 step at 128x128"
PG_SERVED = "progan-128 served batch"
SG2_SERVED = "stylegan2-256 served batch"
SG2_STEP = "stylegan2-256 step (R1 off, PL off)"
SG2_PL_STEP = "stylegan2-256 PL step"
PROJ = "projection (300 W+ steps)"
F32_UNITS = (PROJ,)            # units whose launches are float32, timed so
SMALL_MS = 0.05                # below this a timing is read five more times
SLOW_MS = 1.0                  # above this a library call is read fewer times


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


def _as_channels_last(inp: tuple) -> tuple:
    """A resample kernel's input in channels-last memory."""
    return (inp[0].contiguous(memory_format=torch.channels_last),)


def _unaligned_cl(x):
    """x's values channels-last, one element past a 16-byte boundary."""
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return buf.as_strided(x.shape, (h * w * c, 1, w * c, c)).copy_(x)


def check_shape(name: str, shape, g, channels_last: bool = False) -> float:
    """The kernel against its plain version at one shape in float32 and
    bfloat16; returns the largest absolute error. ``channels_last`` (the
    resample kernels): on channels-last memory, which takes the NHWC
    paths, each also bit-equal to the NCHW call on the same values and
    its result channels-last."""
    k = KERNELS[name]
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        inp = k["inputs"](shape, dt, g)
        nchw = inp
        if channels_last:
            inp = _as_channels_last(inp)
        t0 = time.perf_counter()
        out = k["kernel"](*inp)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        label = f"{name} {shape} {_dt(dt)}{' nhwc' if channels_last else ''}"
        worst = max(worst, _check(label, out, k["plain"](*inp), dt,
                                  f" first call {first_s:.2f} s"))
        # the registered operator (what the autograd Function calls) is
        # the launching wrapper on a CUDA tensor: the same bits
        if not torch.equal(k["op"](*inp), out):
            raise AssertionError(f"{label}: torch.ops.ganlab differs from "
                                 "the launching wrapper")
        if name in WITH_GAIN:
            worst = max(worst, _check(
                f"{label} gain {CHECK_GAIN}", k["kernel"](*inp, CHECK_GAIN),
                k["plain"](*inp, CHECK_GAIN), dt))
        if name in RESAMPLE_PATHS:
            # the same values at a pointer that is not 16-byte aligned go
            # down the element path, whatever path the shape took, with
            # and without a gain; channels-last, the NHWC paths agree
            # with the NCHW call too
            x = inp[0]
            xu = (_unaligned_cl if channels_last else _unaligned_copy)(x)
            for gain in (1.0, CHECK_GAIN):
                out, out_u = k["kernel"](x, gain), k["kernel"](xu, gain)
                paths = (RESAMPLE_PATHS[name](x, out),
                         RESAMPLE_PATHS[name](xu, out_u))
                same = torch.equal(out, out_u)
                if channels_last:
                    same = (same and torch.equal(out, k["kernel"](
                        nchw[0], gain)) and all(is_channels_last(t)
                                                for t in (out, out_u)))
                log(f"path {label} gain {gain}: {paths[0]}; from an "
                    f"unaligned copy: {paths[1]}, bit-identical {same}"
                    f"{' (also to NCHW)' if channels_last else ''}")
                if paths[1] != "element" or not same:
                    raise AssertionError(f"{label}: the paths of {name} "
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
        if name == "pixelnorm_nchw":
            check_nchw_paths(label, inp[0], out)
    return worst


def check_nchw_paths(label: str, x, out) -> None:
    """The channel kernel beyond the plain comparison: bit for bit equal to
    the rows kernel on the same values transposed to (N*H*W, C) (it sums
    in the rows kernel's order), and the same bits from an unaligned copy
    (element pixels) and from a strided view of a larger tensor."""
    n, c, h, w = x.shape
    rows = pixel_norm_cuda(x.permute(0, 2, 3, 1).reshape(-1, c)
                           .contiguous())
    if not torch.equal(out, rows.view(n, h, w, c).permute(0, 3, 1, 2)):
        raise AssertionError(f"{label}: channel kernel and rows kernel "
                             "disagree")
    xu = _unaligned_copy(x)
    out_u = pixel_norm_nchw_cuda(xu)
    # a view: every other image of a batch twice the size, made
    # contiguous by the op (as PixelNorm's forward does)
    big = torch.empty((2 * n, c, h, w), dtype=x.dtype, device=x.device)
    big[::2] = x
    out_v = port_ops.pixel_norm(big[::2], dim=1)
    # the run kernel forced on the same values
    out_r = pixel_norm_nchw_cuda(x, tile=-1)
    log(f"path {label}: {pixel_norm_nchw_path(x, out)}; from an unaligned "
        f"copy: {pixel_norm_nchw_path(xu, out_u)}; bit-equal to the rows "
        "kernel, the unaligned copy, a strided view and "
        + pixel_norm_nchw_path(x, out, tile=-1))
    if not pixel_norm_nchw_path(xu, out_u).startswith("element") or \
            not torch.equal(out_u, out) or not torch.equal(out_v, out) or \
            not torch.equal(out_r, out):
        raise AssertionError(f"{label}: the channel kernel's paths "
                             "disagree")


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
    (1000 + 16 noise), on every path of the kernel: 1024x1024 takes a
    cluster with part of each slice in shared memory and is also forced
    through the split path, which 2048x2048 takes, and 8192x4608 (72 MiB
    in bf16, 144 in float32: 1152 and 2304 slices, so its partials are
    combined over several rounds; not read from an unaligned copy, whose
    loop path gives the whole plane to one block)."""
    worst = 0.0
    for shape in ((4, 8, 4, 4), (2, 3, 5, 7), (2, 3, 64, 64),
                  (1, 2, 256, 256), (1, 2, 1024, 1024), (1, 1, 2048, 2048),
                  (1, 1, 8192, 4608)):
        for dt in (torch.float32, torch.bfloat16):
            _, ys, yb = KERNELS["adain"]["inputs"](shape, dt, g)
            noise = torch.randn(shape, generator=g, device="cuda")
            paths = [None] + (["split"] if shape[2] == 1024 else [])
            for what, x in (("constant planes", torch.full(shape, 1.5)),
                            ("planes 1000 + 16 noise", 1000 + 16 * noise)):
                x = x.to("cuda", dt)
                for path in paths:
                    out = adain_cuda(x, ys, yb, path=path)
                    worst = max(worst, _check(
                        f"adain {shape} {_dt(dt)} {what} "
                        f"[{adain_path(x, out, path=path)}]", out,
                        adain_ref(x, ys, yb), dt))
                    if what == "constant planes" and not torch.equal(
                            out, yb[:, :, None, None].expand_as(out)):
                        raise AssertionError("adain: a constant plane did "
                                             "not come out as its bias")
    return worst


# forced cuts of AdaIN read in turns beside the chosen one: (shape, dtype)
# -> adain_cuda keywords. 256x256: one block against a thread block
# cluster per plane; 512x512: a cluster of 4 x 1024 threads (the earlier
# plan) against other clusters and the split path; 1024x1024: the loop
# path (the earlier plan) against clusters with part of each slice in
# shared memory and the split path, at the stylegan-1024 step's batch of
# 4 and its served batch of 16.
ADAIN_VARIANTS = {
    ((BATCH, 64, 256, 256), torch.bfloat16): [
        dict(threads=t, cluster=c)
        for t, c in ((1024, 1), (512, 2), (256, 4), (512, 4), (256, 8))],
    ((BATCH, 64, 256, 256), torch.float32): [
        dict(threads=t, cluster=c)
        for t, c in ((1024, 2), (512, 4), (256, 8), (512, 8))],
    **{((n, 32, 512, 512), torch.bfloat16): [
        dict(path="cluster", cluster=4, threads=1024),
        dict(path="cluster", cluster=16, threads=256),
        dict(path="split", threads=256), dict(path="split", threads=512)]
       for n in (4, 16)},
    **{((n, 16, 1024, 1024), torch.bfloat16): [
        dict(path="loop"), dict(path="cluster", cluster=16, threads=1024),
        dict(path="cluster", cluster=16, threads=256),
        dict(path="split", threads=256), dict(path="split", threads=512),
        dict(path="split", threads=1024)]
       for n in (4, 16)},
    **{((n, 16, 1024, 1024), torch.float32): [
        dict(path="loop"), dict(path="cluster", cluster=16, threads=1024),
        dict(path="split", threads=512), dict(path="split", threads=1024)]
       for n in (4, 16)},
}


def adain_variants(g) -> None:
    """AdaIN's chosen cut against forced ones at the same call: each read
    three times in turns (``ms`` by CUDA events, median of 3)."""
    for (shape, dt), cuts in ADAIN_VARIANTS.items():
        inp = KERNELS["adain"]["inputs"](shape, dt, g)
        calls = {f"chosen ({adain_path(inp[0], inp[0])})":
                 functools.partial(adain_cuda, *inp)}
        for cut in cuts:
            calls[adain_path(inp[0], inp[0], **cut)] = functools.partial(
                adain_cuda, *inp, **cut)
        reads = {n: [] for n in calls}
        for _ in range(3):
            for n, fn in calls.items():
                reads[n].append(cuda_time_ms(fn, iters=20, warmup=3))
        nbytes = KERNELS["adain"]["nbytes"](shape, dt)
        log(f"variants adain {shape} {_dt(dt)} (bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), ms, median of 3 in "
            "turns: " + ", ".join(
                f"{n} {statistics.median(v):.4f}" for n, v in reads.items()))
        del inp
        torch.cuda.empty_cache()


# the NCHW pixelnorm's large ProGAN shapes (progan-128 steps at 32x32 to
# 128x128), read with each forced plan in turns
NCHW_VARIANT_SHAPES = ((8, 128, 128, 128), (16, 256, 64, 64),
                       (8, 256, 64, 64), (16, 512, 32, 32))


def nchw_variants(g) -> None:
    """The NCHW pixelnorm's chosen plan against the run kernel, three
    reads each in turns (ms / device_ms, median of 3)."""
    for shape in NCHW_VARIANT_SHAPES:
        (x,) = KERNELS["pixelnorm_nchw"]["inputs"](shape, torch.bfloat16, g)
        calls = {f"chosen ({pixel_norm_nchw_path(x, x)})":
                 functools.partial(pixel_norm_nchw_cuda, x),
                 pixel_norm_nchw_path(x, x, tile=-1):
                 functools.partial(pixel_norm_nchw_cuda, x, tile=-1)}
        reads = {n: [] for n in calls}
        for _ in range(3):
            for n, fn in calls.items():
                reads[n].append((cuda_time_ms(fn), device_time_ms(fn)))
        nbytes = KERNELS["pixelnorm_nchw"]["nbytes"](shape, torch.bfloat16)
        log(f"variants pixelnorm_nchw {shape} bf16 (bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), ms / device_ms, "
            "median of 3 in turns: " + ", ".join(
                f"{n} {statistics.median(v[0] for v in r):.4f} / "
                f"{statistics.median(v[1] for v in r):.4f}"
                for n, r in reads.items()))


def time_shape(name: str, shape, g, dtype=torch.bfloat16,
               channels_last: bool = False) -> dict:
    """Times of the kernel, its plain version and its library call at one
    shape in ``dtype``, beside the bound. ``channels_last``: on
    channels-last inputs (the resample kernels' NHWC paths), beside the
    NCHW call's times on the same values."""
    k = KERNELS[name]
    inp = k["inputs"](shape, dtype, g)
    nchw_note = ""
    if channels_last:
        nchw = inp
        inp = _as_channels_last(inp)
        nchw_note = (f"  NCHW kernel "
                     f"{cuda_time_ms(lambda: k['op'](*nchw)):.4f} ms (device "
                     f"{device_time_ms(lambda: k['op'](*nchw)):.4f} ms)")

    def kern():
        # the operator the autograd Function calls: the model's path
        return k["op"](*inp)

    t = dict(ms=cuda_time_ms(kern),
             plain_ms=cuda_time_ms(lambda: k["plain"](*inp)),
             device_ms=device_time_ms(kern), host_us=host_time_us(kern),
             wrapper_host_us=host_time_us(lambda: k["kernel"](*inp)),
             library_ms=None, library_device_ms=None, library_host_us=None)
    note, slow = "n/a", False
    if k["library"] is not None:
        def lib():
            return k["library"](*inp)

        lib_err = (lib().float() - k["plain"](*inp).float()).abs().max().item()
        # a library call of milliseconds (the NCHW pixelnorm's local
        # response norm) is read fewer times
        slow = cuda_time_ms(lib, iters=1, warmup=1) > SLOW_MS
        t.update(library_ms=cuda_time_ms(lib, *((5, 1) if slow else ())),
                 library_device_ms=device_time_ms(
                     lib, *((2, 1) if slow else ())),
                 library_host_us=host_time_us(lib, *((5,) if slow else ())))
        note = (f"{t['library_ms']:.4f} ms (device "
                f"{t['library_device_ms']:.4f} ms, host "
                f"{t['library_host_us']:.1f} us; vs plain {lib_err:.2e})")
    if t["ms"] < SMALL_MS and k["library"] is not None and not slow:
        # a call this short is timed by the host's pace, which wanders:
        # read kernel and library call in turns to see by how much
        reads = [(cuda_time_ms(kern), cuda_time_ms(lib)) for _ in range(5)]
        for who, vals in zip(("kernel", "library"), zip(*reads)):
            log(f"again {name} {shape} {_dt(dtype)} {who} ms, 5 readings "
                f"in turns: "
                f"min {min(vals):.4f} median {statistics.median(vals):.4f} "
                f"max {max(vals):.4f}")
    nbytes = k["nbytes"](shape, dtype)
    t["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    t["ops_ms"] = k["flops"](shape) / F32_FLOPS_PER_S * 1e3
    bound = max(t["bytes_ms"], t["ops_ms"])
    lay = " nhwc" if channels_last else ""
    log(f"time {name} {shape} {_dt(dtype)}{lay}: kernel {t['ms']:.4f} ms "
        f"(device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us "
        f"through the operator, {t['wrapper_host_us']:.1f} us the wrapper "
        f"alone){nchw_note}  plain "
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
    fn = _build.c_function(*pixelnorm._ROWS)

    def raw():
        fn(x.data_ptr(), out.data_ptr(), BATCH, 512, 1e-8, 1, 0,
           stream_handle(0))

    parts = {"empty_like": lambda: torch.empty_like(x),
             "C function through ctypes": raw,
             "whole wrapper": lambda: pixel_norm_cuda(x),
             "torch.ops.ganlab (Library operator)":
                 lambda: PIXEL_NORM(x, 1e-8),
             "torch.library.custom_op around the wrapper":
                 functools.partial(_custom_pixel_norm(), x, 1e-8)}
    if KERNELS["pixelnorm"]["library"] is not None:
        parts["F.rms_norm"] = lambda: KERNELS["pixelnorm"]["library"](x)
    for _ in range(2):                    # the second reading is the warm one
        reads = {n: host_time_us(f, calls=300) for n, f in parts.items()}
    log(f"host pixelnorm {tuple(x.shape)} bf16, us per call over 300 "
        "un-synchronised calls: "
        + ", ".join(f"{n} {v:.2f}" for n, v in reads.items()))


@functools.cache
def _custom_pixel_norm():
    """The rows pixelnorm registered the other way, as a Python
    ``torch.library.custom_op`` around the same wrapper: read beside the
    package's ``torch.library.Library`` operator for the host's cost."""
    @torch.library.custom_op("ganlab_smoke::pixel_norm", mutates_args=())
    def op(x: torch.Tensor, eps: float) -> torch.Tensor:
        return pixel_norm_cuda(x, eps)

    @op.register_fake
    def _(x, eps):
        return torch.empty_like(x)

    return op


def adain_host_parts(g) -> None:
    """Where the host's time for one AdaIN call on small planes goes: the
    output's allocation, the C function through ctypes, the plan lookup
    (cached; the wrapper makes it only for planes above 128 KiB or a
    forced path) and the whole wrapper (host_time_us of each)."""
    from ganlab_tpu_torch.ops.kernels import adain, stream_handle

    x, s, b = KERNELS["adain"]["inputs"]((BATCH, 512, 4, 4), torch.bfloat16,
                                         g)
    out = torch.empty_like(x)
    fn = _build.c_function(*adain._LAUNCH)

    def raw():
        fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), None,
           BATCH * 512, 16, 1e-8, 1, 1, 1, -1, 0, 0, 0, stream_handle(0))

    parts = {"empty_like": lambda: torch.empty_like(x),
             "C function through ctypes": raw,
             "plan lookup": lambda: adain._plan(True, 16, 1, -1, 0, 0, 0),
             "whole wrapper": lambda: adain_cuda(x, s, b)}
    for _ in range(2):                    # the second reading is the warm one
        reads = {n: host_time_us(f, calls=300) for n, f in parts.items()}
    log(f"host adain {tuple(x.shape)} bf16, us per call over 300 "
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
    for key in ("host_us", "wrapper_host_us", "library_host_us"):
        # per call: the mean
        vals = [times[s][key] for s in launches]
        r[key] = None if None in vals else \
            sum(n * v for n, v in zip(launches.values(), vals)) / n_all
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    return r


def _by_layout(launches: dict, nhwc: dict) -> dict:
    """{(shape, channels_last): launches} of one unit's kernel, from its
    launches and the channels-last ones among them."""
    out = {}
    for s, n in launches.items():
        cl = nhwc.get(s, 0)
        for key, m in (((s, False), n - cl), ((s, True), cl)):
            if m:
                out[key] = m
    return out


def phase_kernels(units: dict, nhwc: dict) -> dict:
    """Check and time every kernel. ``units`` maps a unit of work (a served
    batch, a training step, a projection) to kernel -> {shape: launches per
    unit}, ``nhwc`` to the channels-last launches among them; every shape
    is checked once (float32 and bfloat16) in each layout its units launch
    it in, NCHW always, and timed once in each dtype and layout its units
    launch it in (bfloat16, float32 for ``F32_UNITS``), and the times are
    summed per unit. Returns kernel -> {"max_abs_err": ..., unit: sums}."""
    def unit_dtype(unit):
        return torch.float32 if unit in F32_UNITS else torch.bfloat16

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with torch.inference_mode():
        for name in KERNELS:
            by_unit = {unit: _by_layout(by_kernel[name],
                                        nhwc.get(unit, {}).get(name, {}))
                       for unit, by_kernel in units.items()
                       if by_kernel.get(name)}
            keys = list(dict.fromkeys(
                (s, unit_dtype(unit), cl) for unit, by in by_unit.items()
                for s, cl in by))
            shapes = list(dict.fromkeys(s for s, _, _ in keys))
            cl_shapes = list(dict.fromkeys(s for s, _, cl in keys if cl))
            r = {"max_abs_err": max(
                [check_shape(name, s, g)
                 for s in shapes + EXTRA_SHAPES.get(name, [])]
                + [check_shape(name, s, g, channels_last=True)
                   for s in cl_shapes])}
            if name == "adain":
                r["max_abs_err"] = max(r["max_abs_err"],
                                       check_adain_planes(g))
                adain_variants(g)
            times = {(s, dt, cl): time_shape(name, s, g, dt, cl)
                     for s, dt, cl in keys}
            if name == "pixelnorm":
                pixelnorm_host_parts(g)
            if name == "adain":
                adain_host_parts(g)
            if name == "minibatch_stddev":
                mbstd_variants(g)
            if name == "pixelnorm_nchw":
                nchw_variants(g)
            for unit, by in by_unit.items():
                dt = unit_dtype(unit)
                u = r[unit] = unit_sums(
                    {(s, cl): times[(s, dt, cl)] for s, cl in by}, by)
                n_cl = sum(m for (_, cl), m in by.items() if cl)
                lib = "n/a" if u["library_ms"] is None else \
                    (f"{u['library_ms']:.4f} ms (device "
                     f"{u['library_device_ms']:.4f} ms)")
                log(f"sum {name} per {unit} ({u['launches']} launches, "
                    f"{n_cl} NHWC): "
                    f"kernel {u['ms']:.4f} ms (device "
                    f"{u['device_ms']:.4f} ms, host {u['host_us']:.1f} "
                    f"us a call)  plain {u['plain_ms']:.4f} ms  library "
                    f"{lib}  bound {u['bound_ms']:.4f} ms "
                    f"({u['bound_by']})")
            results[name] = r
    return results


# -- 5. serving path -------------------------------------------------------
def make_sampler(cfg) -> BatchSampler:
    """Full-width G with seeded random weights; every term made live (for
    StyleGAN2 also the toRGB and style affine weights perturbed)."""
    torch.manual_seed(0)
    sd = build_generator(cfg.model).state_dict()
    gen = torch.Generator().manual_seed(1)
    sg2 = cfg.model.model == "stylegan2"
    for k, v in sd.items():
        if k.endswith(("noise.scale", ".bias", ".b")) or (sg2 and (
                k.endswith("affine.w") or (".torgb" in k and
                                           k.endswith(".w")))):
            v += 0.2 * torch.randn(v.shape, generator=gen)
    w_avg = 0.5 * torch.randn(cfg.model.latent_dim, generator=gen)
    return BatchSampler(cfg, params=sd, w_avg=w_avg, batch_size=BATCH)


def _counts() -> dict:
    return {n: k["kernel"].launches for n, k in KERNELS.items()}


def _add_counts(total: dict, part: dict) -> None:
    for n in total:
        total[n] += part[n]


def reset_counts():
    for k in KERNELS.values():
        for attr in COUNTS:
            if hasattr(k["kernel"], attr):
                setattr(k["kernel"], attr, 0)


def _nhwc_counts() -> dict:
    """The resample wrappers' NHWC launches since ``reset_counts``."""
    return {n: KERNELS[n]["kernel"].nhwc_launches for n in RESAMPLE_PATHS}


def serving_speed(sampler) -> dict:
    """Batch latency of 8 requests of one batch (median, max; host clock,
    each ends in a host copy), then img/s over one request of 8 batches."""
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        sampler.generate(BATCH, seed=100 + i)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    sampler.generate(8 * BATCH, seed=200)
    return dict(img_per_s=8 * BATCH / (time.perf_counter() - t0),
                batch_ms_median=statistics.median(lat), batch_ms_max=max(lat))


def f32_card_vs_cpu(preset: str, sampler) -> float:
    """Two images of the sampler's G in float32 (TF32 off), on the card and
    on the CPU from the same z and explicit noise maps (the family's);
    fails above IMAGE_ATOL. Returns the largest difference."""
    cfg32 = get_config(preset, **{"run.compute_dtype": "float32"})
    s32 = build_sample_fn(cfg32, sampler.res_log2)
    gcpu = torch.Generator().manual_seed(3)
    z2 = torch.randn(2, cfg32.model.latent_dim, generator=gcpu)
    noises = [torch.randn(2, 1, h, w, generator=gcpu)
              for h, w in port_models.noise_shapes(cfg32.model,
                                                   sampler.res_log2)]
    with torch.inference_mode():
        on_card = s32(sampler.g, sampler.w_avg, z2.cuda(), None, 0.7, 1.0,
                      [n.cuda() for n in noises]).cpu()
        g_cpu = copy.deepcopy(sampler.g).cpu()
        on_cpu = s32(g_cpu, sampler.w_avg.cpu(), z2, None, 0.7, 1.0, noises)
    err = (on_card - on_cpu).abs().max().item()
    log(f"{preset}: f32 card vs CPU on 2 images ({len(noises)} noise maps): "
        f"max_abs {err:.3e} (tol {IMAGE_ATOL:g}), image std "
        f"{on_cpu.std().item():.3f}")
    if not err <= IMAGE_ATOL:
        raise AssertionError(f"{preset}: card and CPU disagree in float32")
    return err


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

    f32_card_vs_cpu("stylegan-256", sampler)
    perf = serving_speed(sampler)
    torch.cuda.reset_peak_memory_stats()
    sampler.generate(BATCH, seed=300)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main: {perf['img_per_s']:.1f} img/s over {8 * BATCH} images; batch "
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
    by_name: dict = {}
    for us, _, key in rows:
        by_name[key] = by_name.get(key, 0.0) + us / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle,
                by_name=by_name)


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

    kern = {"pixelnorm": port_ops.pixel_norm,
            "pixelnorm_nchw": functools.partial(port_ops.pixel_norm, dim=1),
            "adain": port_ops.adain,
            "upsample_blur_2x": port_ops.upsample_blur_2x,
            "blur_downsample_2x": port_ops.blur_downsample_2x,
            "minibatch_stddev": port_ops.minibatch_stddev}
    cases = {"pixelnorm": (r(2 * BATCH, 512),),
             "pixelnorm_nchw": (r(16, 512, 8, 8, scale=2.0),),
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
    pl_got = pl_second_order(port_ops.upsample_blur_2x,
                             port_ops.blur_downsample_2x, "cuda")
    pl_want = pl_second_order(upsample_blur_2x_ref, blur_downsample_2x_ref,
                              "cuda")
    _assert_grads_close("second order (path-length shape)", pl_got, pl_want)
    wgan_gp_card_vs_cpu()


def pl_second_order(up, down, device, seed: int = 3):
    """Path length's shape of derivative through a small skip synthesis:
    styles from a mapping matrix, a modulated 3x3 conv after up+blur, a
    skip RGB upsampled and added, blur+down at the end; the gradient of
    the projection with respect to the styles (create_graph), and the
    gradient of its squared deviation with respect to every parameter,
    the mapping's included. float32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, device=device) * scale

    x0, z, y = r(8, 16, 8, 8), r(8, 32), r(8, 3, 8, 8, scale=0.125)
    params = [t.requires_grad_(True) for t in (
        r(32, 32, scale=0.2), r(32, 16, scale=0.2), r(32, 16, scale=0.2),
        r(16, 16, 3, 3, scale=0.1), r(3, 16, 1, 1, scale=0.3),
        r(3, 16, 1, 1, scale=0.3))]
    m, a0, a1, w1, rgb_lo, rgb_hi = params
    w = F.leaky_relu(z @ m, 0.2)
    ws = w[:, None, :].repeat(1, 2, 1)
    s0, s1 = ws[:, 0] @ a0 + 1, ws[:, 1] @ a1 + 1
    h0 = x0 * s0[:, :, None, None]
    h = F.leaky_relu(F.conv2d(up(h0) * s1[:, :, None, None], w1,
                              padding=1), 0.2)
    img = down(up(F.conv2d(h0, rgb_lo)) + F.conv2d(h, rgb_hi))
    (gw,) = torch.autograd.grad((img * y).sum(), ws, create_graph=True)
    length = gw.square().sum(2).mean(1).sqrt()
    return torch.autograd.grad((length - length.mean().detach())
                               .square().mean(), params)


def wgan_gp_card_vs_cpu() -> None:
    """WGAN-GP's gradient with respect to the ProGAN D's parameters (the
    double backward through its convs, average pools and mbstd) on the card
    against the CPU, from the same weights, images and interpolation
    weights: a narrow progan-128 D at 32x32 in a fade (alpha 0.3) with
    batch 16, float32, TF32 off; 1e-3 of each leaf's scale."""
    from ganlab_tpu_torch.ops import losses

    cfg = get_config("progan-128", **{
        "model.resolution": 32, "model.fmap_base": 512,
        "model.fmap_max": 64})
    gen = torch.Generator().manual_seed(8)
    real = torch.rand(16, 3, 32, 32, generator=gen) * 2 - 1
    fake = torch.rand(16, 3, 32, 32, generator=gen) * 2 - 1
    eps = torch.rand(16, 1, 1, 1, generator=gen)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        _, d_cpu = port_models.build_models(cfg.model)
    with torch.no_grad():
        for p in d_cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    d_card = copy.deepcopy(d_cpu).cuda()
    grads = {}
    before = minibatch_stddev_cuda.launches
    names = [n for n, _ in d_cpu.named_parameters()]
    for dev, d in (("cuda", d_card), ("cpu", d_cpu)):
        pen = losses.wgan_gp(lambda x: d(x, 5, 0.3, True), real.to(dev),
                             fake.to(dev), None, 10.0, eps=eps.to(dev))
        params = list(d.parameters())
        # the 4x4 and 8x8 heads take no part at 32x32
        grads[dev] = [torch.zeros(p.shape) if g is None else g.cpu()
                      for p, g in zip(params, torch.autograd.grad(
                          pen, params, allow_unused=True))]
    if minibatch_stddev_cuda.launches == before:
        raise AssertionError("WGAN-GP on the card launched no mbstd kernel")
    # weights and biases alike read up to ~3.6e-4 of their leaf's scale:
    # cuDNN and the CPU sum the double backward's products in other orders
    _assert_grads_close("WGAN-GP through the ProGAN D, card vs CPU",
                        grads["cuda"], grads["cpu"], rtol=WGAN_GP_GRAD_RTOL)
    for kind, end in (("weights", ".w"), ("biases", ".b")):
        worst = max((a - b).abs().max().item() / b.abs().max().item()
                    for n, a, b in zip(names, grads["cuda"], grads["cpu"])
                    if n.endswith(end) and b.abs().max().item() > 0)
        log(f"grad WGAN-GP card vs CPU, {kind}: largest error {worst:.3e} "
            f"of the leaf scale (tol {WGAN_GP_GRAD_RTOL:g})")


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
    expect = {r1: launch_totals(step_launches(mc, r1)) for r1 in (False, True)}
    expect_cl = {r1: _resample_only(launch_totals(step_launches(
        mc, r1, channels_last=True))) for r1 in (False, True)}
    log(f"train: launches per step derived from the config: R1-off "
        f"{expect[False]}, R1-on {expect[True]}; NHWC among them (the D's) "
        f"R1-off {expect_cl[False]}, R1-on {expect_cl[True]}")

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
        if _nhwc_counts() != expect_cl[r1]:
            raise AssertionError(f"step {i}: NHWC launches "
                                 f"{_nhwc_counts()}, derived {expect_cl[r1]}")
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


def phase_train_card_vs_cpu(preset: str = "stylegan-256",
                            rtol: float = STEP_GRAD_RTOL,
                            sets: dict | None = None) -> None:
    """One penalty step (R1 for stylegan-256, WGAN-GP and drift for
    progan-128, R1 and path length for stylegan2-256) of a narrow 32²
    model in float32 (TF32 off), on the card and on the CPU from the same
    initial state and draws; ``sets`` adds to the configuration (a step
    recipe: under ``loss.reg_separate`` D's gradients are the second
    update's, R1's alone). D's lr is 0 here: Adam's first update is
    about lr * sign(g), so where D's gradient is ~0 the two devices'
    updated D's would differ by up to 2 lr, and G's gradients, taken
    against the updated D, with them. Every gradient leaf within ``rtol``
    of its scale; with path length the mapping layers' leaves are among
    them and must be nonzero."""
    cfg = get_config(preset, **{
        "model.resolution": 32, "model.fmap_base": 512,
        "model.fmap_max": 64, "model.latent_dim": 128,
        "run.compute_dtype": "float32", "schedule.progressive": False,
        "schedule.start_res": 32,
        "schedule.batch_schedule": {32: 8}, "optim.lr_d": 0.0,
        **(sets or {})})
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
        step = train_steps.build_train_step(
            cfg, phase, penalty_override=True,
            pl_override=True if cfg.pl_active else None)
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
    if not worst <= rtol:
        raise AssertionError(f"f32 step grad {rels[-1][1]}: {worst:.3e} "
                             "of scale")
    mapping = [k for k in g_cpu if k.startswith("g.mapping.")]
    if cfg.pl_active and (not mapping or any(
            not g_cpu[k].abs().max().item() > 0 for k in mapping)):
        raise AssertionError("f32 PL step: the mapping layers have no "
                             "gradient")
    what = cfg.loss.penalty + (" + path length" if cfg.pl_active else "") \
        + "".join(f" {k}={v}" for k, v in (sets or {}).items())
    log(f"train: {preset} f32 {what} step at 32² card vs CPU: "
        f"losses {m_cpu} agree "
        f"within {STEP_LOSS_RTOL:g} rel; {len(g_cpu)} gradient leaves agree "
        f"({len(mapping)} of the mapping layers), worst {worst:.3e} of the "
        f"leaf scale (tol {rtol:g})")


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


def run_cli_train(preset: str, sets: dict, workdir: str,
                  max_steps: int | None = None,
                  chunked: bool = False) -> dict:
    """``cli train --preset <preset> --set k=v ...`` into ``workdir``
    (``--max-steps`` when given), with ``run.chunk_steps=False`` unless
    ``chunked``: one step a call. The step functions the Trainer builds
    are wrapped to set the launch counts to 0 before each call and to read
    them and the clock (after a synchronize) after it: a record a step,
    or where ``chunked`` a record a call of the chunked stepper (its first
    step, the ``n`` steps it took, the graphs its phase had captured by
    then). What the run printed comes back as ``text``."""
    if not chunked:
        sets = {"run.chunk_steps": False, **sets}
    records, live = [], {}
    make = train_loop.make_lazy_stepper
    make_chunked = train_loop.make_chunked_stepper

    def timed(call, state, real, draws, **rec):
        reset_counts()
        start = state.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(state, real, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = out[1]["d_loss"]
        records.append(dict(
            rec, step=start, n=len(loss) if loss.dim() else 1,
            ms=ms, t0=t0, device=real.device.type,
            counts={n: k["kernel"].launches for n, k in KERNELS.items()}))
        live["state"] = out[0]
        return out

    def instrumented(cfg_, phase, initial_step=0):
        stepper = make(cfg_, phase, initial_step=initial_step)
        count = {"i": int(initial_step)}

        def step(state, real, draws=None):
            i = count["i"]
            count["i"] += 1
            return timed(stepper, state, real, draws, phase=phase.index,
                         r1=i % cfg_.loss.penalty_every == 0,
                         pl=cfg_.pl_active and i % cfg_.loss.pl_every == 0,
                         shape=tuple(real.shape))

        return step

    def instrumented_chunked(cfg_, phase, initial_step=0):
        stepper, k = make_chunked(cfg_, phase, initial_step=initial_step)

        def call(state, stack, draws=None):
            out = timed(stepper, state, stack, draws, phase=phase.index,
                        shape=tuple(stack.shape[1:]))
            records[-1]["graphs"] = len(stepper.graphs.capture_s) \
                if stepper.graphs is not None else 0
            return out

        call.close = stepper.close
        return call, k

    args = ["--preset", preset, "--workdir", workdir]
    if max_steps is not None:
        args += ["--max-steps", str(max_steps)]
    for k, v in sets.items():
        args += ["--set", f"{k}={v}"]
    torch.cuda.reset_peak_memory_stats()
    train_loop.make_lazy_stepper = instrumented
    train_loop.make_chunked_stepper = instrumented_chunked
    tee = _Tee(sys.stdout)
    try:
        sys.stdout = tee
        t0 = time.perf_counter()
        rc = port_cli.main(["train", *args])
        wall = time.perf_counter() - t0
    finally:
        sys.stdout = tee.out
        train_loop.make_lazy_stepper = make
        train_loop.make_chunked_stepper = make_chunked
    if rc != 0:
        raise AssertionError(f"cli train returned {rc}")
    if chunked != any("graphs" in r for r in records):
        raise AssertionError(f"cli train: chunked {chunked}, but the "
                             f"Trainer called the other stepper")
    return dict(records=records, live=live["state"], wall_s=wall,
                text="".join(tee.text),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def chunk_launches(label: str, cfg, recs: list,
                   recipe: str = "sequential") -> dict:
    """Each chunked ``run_cli_train`` record's launches of our kernels
    against those derived for the steps it took (R1 on every
    ``loss.penalty_every``-th); returns their sum."""
    total = {n: 0 for n in KERNELS}
    for rec in recs:
        batch, res = rec["shape"][0], rec["shape"][1]
        want = {n: 0 for n in KERNELS}
        for i in range(rec["step"], rec["step"] + rec["n"]):
            _add_counts(want, launch_totals(step_launches(
                cfg.model, i % cfg.loss.penalty_every == 0,
                int(math.log2(res)), batch, recipe)))
        if rec["counts"] != want:
            raise AssertionError(f"{label}: steps {rec['step']}..+"
                                 f"{rec['n']} of phase {rec['phase']}: "
                                 f"launches {rec['counts']}, derived {want}")
        _add_counts(total, rec["counts"])
    return total


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
            "run.log_every": 1, "run.checkpoint_every": CKPT_EVERY,
            # a step a call: every step's launches are checked
            "run.chunk_steps": False}
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
                      ckpt_every, r1_first_from: int | None = None) -> dict:
    """Every phase ran its steps at its resolution and batch with the
    launch counts ``step_launches`` derives; the penalty on every
    ``loss.penalty_every``-th step of the run, and every phase from
    ``r1_first_from`` pixels up runs 16 steps or more and starts with an
    R1 step; the logged alpha rises from 0 in a fade phase and is 1.0 in a
    stabilize phase; losses finite; checkpoints written, the newest kept.
    Prints each phase's step times and img/s by step time and by the
    loop's clock."""
    mc = cfg.model
    every = cfg.loss.penalty_every
    with open(os.path.join(workdir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    counts = [phase_steps(ph) for ph in phases]
    n_steps = sum(counts)
    if len(records) != n_steps or [r["step"] for r in rows] != \
            list(range(1, n_steps + 1)):
        raise AssertionError(f"trainer: {len(records)} steps, {len(rows)} "
                             f"log rows, expected {n_steps}")
    launches = {n: 0 for n in KERNELS}
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
            want = launch_totals(step_launches(mc, r["r1"], ph.res_log2, b))
            if r["counts"] != want:
                raise AssertionError(
                    f"trainer: phase {ph.index} step {r['step']}: launches "
                    f"{r['counts']}, derived {want}")
            for k in launches:
                launches[k] += r["counts"][k]
        if r1_first_from is not None and res >= r1_first_from and (
                n < 16 or not recs[0]["r1"]):
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
            if (row["penalty"] > 0) != ((row["step"] - 1) % every == 0):
                raise AssertionError(f"trainer: penalty in {row}")
        # with lazy R1 the R1-off steps; with a penalty every step, all
        off = [r["ms"] for r in recs[2:] if not r["r1"]] or \
            [r["ms"] for r in recs[2:]]
        on = [r["ms"] for r in recs if r["r1"]] if every > 1 else []
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
        kind = "R1-off step" if every > 1 else "step"
        shown = next((r["counts"] for r in recs if not r["r1"]),
                     recs[-1]["counts"])
        log(f"trainer: phase {ph.index} {res}x{res} {ph.kind} batch {b}: "
            f"{n} steps, alpha {alphas[0]:.4f}..{alphas[-1]:.4f}, "
            f"{pp['ms_r1_off']:.2f} ms per {kind} (median of "
            f"{len(off)}), R1-on steps "
            f"{', '.join(f'{v:.2f}' for v in on) or 'none'} ms, first step "
            f"{recs[0]['ms']:.2f} ms, {pp['img_s_step']:.1f} img/s over "
            f"steps 3..{n} by step time, {pp['img_s_loop']:.1f} img/s by "
            f"the loop's clock (between steps: median {pp['gap_ms']:.2f} "
            f"ms, checkpoints included), launches "
            f"{shown} "
            f"[{card}]")
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
    return dict(launches=launches, phases=per_phase)


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
    and the next two steps (one with R1 in a lazy-R1 run) of the restored
    and of the live state, on the same batches, end in the same bits.
    cuDNN is held to its deterministic algorithms for those steps, or two
    runs of one step from one state need not agree at all."""
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
        log(f"trainer: two more steps ({live.step - 2} and {live.step - 1}, "
            f"penalty every {cfg.loss.penalty_every}) from the restored and "
            f"from the live state: all {n} leaves bit-equal")
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
                 str(EVAL_SAMPLES), "--metrics", "fid,kid,pr"])),
            # PPL in w space, 64 pairs of 1024x1024 images in float32,
            # LPIPS on the random VGG16
            ("cli eval-fid --metrics ppl", lambda: port_cli.main(
                ["eval-fid", "--workdir", wd, "--num-samples",
                 str(EVAL_SAMPLES), "--metrics", "ppl"]))]
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


# -- 9. ProGAN and ResNet-GAN -------------------------------------------------
PG_KIMG = 0.128                # a fade / stabilize phase: 8 steps at batch
                               # 16, 16 steps at batch 8 (128x128)
PG_FIXED_STEPS = 24            # progan-64 and resnetgan-cifar10
N_CRITIC = 5
PPL_SAMPLES = 256


def check_fixed_run(label: str, run: dict, workdir: str, want: dict,
                    card: str) -> dict:
    """A fixed-resolution ``cli train`` run: every step's launch counts as
    derived, the penalty on every step, finite metrics; ms per step (after
    the first two) and img/s by step time."""
    records = run["records"]
    with open(os.path.join(workdir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != len(records) or len(records) != PG_FIXED_STEPS:
        raise AssertionError(f"{label}: {len(records)} steps, {len(rows)} "
                             "log rows")
    for r, row in zip(records, rows):
        if r["counts"] != want or r["device"] != "cuda":
            raise AssertionError(f"{label}: step {r['step']} launches "
                                 f"{r['counts']}, derived {want}")
        vals = [row[k] for k in ("d_loss", "g_loss", "penalty",
                                 "real_score", "fake_score")]
        if not all(math.isfinite(v) for v in vals) or row["penalty"] <= 0:
            raise AssertionError(f"{label}: metrics {row}")
    ms = [r["ms"] for r in records[2:]]
    b = records[0]["shape"][0]
    out = dict(ms=statistics.median(ms), img_s=len(ms) * b / sum(ms) * 1e3,
               first_ms=records[0]["ms"], launches=records[0]["counts"])
    log(f"progan: {label} at full width, batch {b}: {len(records)} steps, "
        f"{out['ms']:.2f} ms per step (median of {len(ms)}), "
        f"{out['img_s']:.1f} img/s by step time, first step "
        f"{out['first_ms']:.1f} ms, launches a step {out['launches']}, "
        f"cli train {run['wall_s']:.1f} s, peak {run['peak_gib']:.2f} GiB "
        f"[{card}]")
    return out


def progan_serving(cfg, state, card) -> dict:
    """``BatchSampler`` on the progan-128 G-EMA at batch 32: launches per
    batch, img/s and batch latency (host clock, uint8 on the host)."""
    sampler = BatchSampler(cfg, state=state, batch_size=BATCH)
    sampler.warmup()
    reset_counts()
    a = sampler.generate(2 * BATCH, seed=0)
    counts = {n: k["kernel"].launches for n, k in KERNELS.items()}
    per_batch = launch_totals(progan_g_launches(cfg.model))
    if counts != {n: 2 * v for n, v in per_batch.items()} or \
            a.shape != (2 * BATCH, 128, 128, 3):
        raise AssertionError(f"progan serving: launches {counts} in two "
                             f"batches, derived {per_batch} a batch, "
                             f"images {a.shape}")
    if not np.array_equal(a[:3], sampler.generate(3, seed=0)):
        raise AssertionError("progan serving: not index-stable")
    out = dict(serving_speed(sampler), launches=counts)
    log(f"progan: BatchSampler on the progan-128 G-EMA, batch {BATCH}: "
        f"{out['img_per_s']:.1f} img/s over {8 * BATCH} images; batch "
        f"latency median {out['batch_ms_median']:.2f} ms max "
        f"{out['batch_ms_max']:.2f} ms; "
        f"launches per batch {per_batch} [{card}]")
    profile_call(f"one served progan-128 batch of {BATCH}",
                 lambda: sampler.generate(BATCH, seed=500), card, top=6)
    return out


def n_critic_run(card: str) -> None:
    """resnetgan-cifar10 at full width with ``loss.d_steps_per_g`` 5: ten
    steps; D changes every step, G (and its G-EMA) only on steps 4 and 9,
    ``g_loss`` 0 on the others."""
    cfg = get_config("resnetgan-cifar10", **{
        "loss.d_steps_per_g": N_CRITIC, "data.dataset": "synthetic"})
    phase = build_phases(cfg.schedule, cfg.model)[0]
    state = create_train_state(cfg, seed=0)
    stepper = make_lazy_stepper(cfg, phase)
    source = make_source(cfg.data, 32, seed=1)
    changed = []
    for i in range(2 * N_CRITIC):
        real = torch.from_numpy(source.batch(phase.batch_size, 32)).cuda()
        g0, d0, e0 = (_leaves(m) for m in (state.g, state.d, state.g_ema))
        state, m = stepper(state, real)
        moved = tuple(_changed(b, mod) for b, mod in
                      ((g0, state.g), (d0, state.d), (e0, state.g_ema)))
        g_step = i % N_CRITIC == N_CRITIC - 1
        if (moved[0] > 0) != g_step or (moved[2] > 0) != g_step or \
                moved[1] == 0 or (float(m["g_loss"]) != 0.0) != g_step:
            raise AssertionError(f"n-critic step {i}: leaves changed "
                                 f"(G, D, G-EMA) {moved}, metrics {m}")
        changed.append(moved)
    log(f"progan: resnetgan-cifar10 with loss.d_steps_per_g={N_CRITIC}, "
        f"batch {phase.batch_size}: leaves changed per step (G, D, G-EMA) "
        f"{changed}: G only on steps {N_CRITIC - 1} and "
        f"{2 * N_CRITIC - 1} [{card}]")


def phase_progan(card: str) -> dict:
    """ProGAN and ResNet-GAN at full width through their entry points:
    ``cli train --preset progan-128`` through all 11 phases 4x4 ->
    128x128 at the preset's batches (16, then 8 at 128x128) on
    ``ellipses``, WGAN-GP and drift every step, cut in length only, with
    launch counts per step, alpha, finite losses, resume bit for bit and
    serving from the workdir; one 128x128 step profiled; ``cli sample``;
    ``cli eval-ppl --space z`` (random VGG16); ``BatchSampler`` on the
    G-EMA; one float32 WGAN-GP step card vs CPU; ``progan-64`` (R1 every
    step) and ``resnetgan-cifar10`` (WGAN-GP, batch 64, ``synthetic``)
    for a few dozen steps; n-critic."""
    sets = {"data.dataset": "ellipses", "schedule.fade_kimg": PG_KIMG,
            "schedule.stabilize_kimg": PG_KIMG,
            "schedule.total_kimg": 0.001, "run.log_every": 1}
    cfg = get_config("progan-128", **sets)
    mc = cfg.model
    phases = build_phases(cfg.schedule, mc)
    assert (mc.resolution, mc.latent_dim, mc.fmap_base, mc.fmap_max,
            cfg.run.compute_dtype, cfg.loss.loss, cfg.loss.penalty,
            cfg.loss.penalty_every, cfg.loss.drift_weight) == \
        (128, 512, 8192, 512, "bfloat16", "wgan-gp", "wgan-gp", 1, 1e-3)
    assert [(p.resolution, p.kind, p.batch_size) for p in phases] == \
        [(4, "stabilize", 16)] + [
            (2 ** lg, kind, 16 if lg < 7 else 8) for lg in range(3, 8)
            for kind in ("fade", "stabilize")]
    log(f"progan: progan-128 preset, all widths, its {len(phases)} phases at "
        f"batches 16 / 8; cut: schedule.fade_kimg and stabilize_kimg 600 "
        f"-> {PG_KIMG} (steps a phase: {[phase_steps(p) for p in phases]}),"
        f" schedule.total_kimg 12000 -> the phases' own end "
        f"({phases[-1].end_img} images); data.dataset ellipses; "
        "run.log_every 1")
    launches = {n: 0 for n in KERNELS}

    def count(c):
        for n in launches:
            launches[n] += c[n]

    root = tempfile.mkdtemp(prefix="ganlab_progan_")
    try:
        wd = os.path.join(root, "progan128")
        run = run_cli_train("progan-128", sets, wd)
        checked = check_trainer_run(cfg, phases, run["records"], wd, card,
                                    cfg.run.checkpoint_every)
        count(checked["launches"])
        log(f"progan: cli train took {run['wall_s']:.1f} s for "
            f"{len(run['records'])} steps; peak memory "
            f"{run['peak_gib']:.2f} GiB [{card}]")
        live = run["live"]
        check_resume_and_serving(cfg, phases, live, wd)
        last = phases[-1]
        source = make_source(cfg.data, mc.resolution, seed=5)
        real = torch.from_numpy(source.batch(last.batch_size, 128)).cuda()
        stepper = make_lazy_stepper(cfg, last, initial_step=live.step)
        for _ in range(2):
            live, _ = stepper(live, real)
        prof = profile_call("one progan-128 step at 128x128 (batch 8, "
                            "WGAN-GP and drift)",
                            lambda: stepper(live, real), card, top=10)

        png = os.path.join(root, "progan_sample.png")
        for label, fn in (
                ("cli sample", lambda: port_cli.main(
                    ["sample", "--workdir", wd, "--num", "4", "--out", png])),
                ("cli eval-ppl --space z", lambda: port_cli.main(
                    ["eval-ppl", "--workdir", wd, "--num-samples",
                     str(PPL_SAMPLES), "--space", "z"]))):
            t0 = time.perf_counter()
            count(counted(label, fn, need=("pixelnorm", "pixelnorm_nchw")))
            log(f"progan: {label} took {time.perf_counter() - t0:.1f} s "
                f"[{card}]")
        check_png(png, "cli sample (progan-128)")
        serving = progan_serving(cfg, live, card)
        count(serving["launches"])
        phase_train_card_vs_cpu("progan-128")

        fixed = {}
        for preset, over in (
                ("progan-64", {"data.dataset": "ellipses"}),
                ("resnetgan-cifar10", {"data.dataset": "synthetic"})):
            pcfg = get_config(preset, **over)
            ph = build_phases(pcfg.schedule, pcfg.model)[0]
            want = launch_totals(step_launches(pcfg.model, True, ph.res_log2,
                                               ph.batch_size))
            wdp = os.path.join(root, preset)
            prun = run_cli_train(preset, dict(over, **{"run.log_every": 1}),
                                 wdp, max_steps=PG_FIXED_STEPS)
            fixed[preset] = check_fixed_run(preset, prun, wdp, want, card)
            count({n: sum(r["counts"][n] for r in prun["records"])
                   for n in KERNELS})
        n_critic_run(card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, phases=checked["phases"],
                peak_gib=run["peak_gib"], prof=prof, serving=serving,
                fixed=fixed)


# -- 10. StyleGAN2 -------------------------------------------------------------
SG2_STEPS = 48                 # R1 at 0, 16 and 32; path length every 4th
SG2_BATCH = 8                  # the preset's batch at 256x256
SG2_PPL_SAMPLES = 64
SG2_PROGRAMS = {(True, True): "R1 + PL", (False, True): "PL",
                (False, False): "neither"}


def sg2_launch_units(mc) -> dict:
    """The StyleGAN2 units the kernel phase checks and times: a served
    batch of 32, a step with neither regularizer, and a PL step, at the
    preset's batch of 8 (PL's batch 4)."""
    return {SG2_SERVED: stylegan2_serving_launches(mc),
            SG2_STEP: stylegan2_step_launches(mc, False, False,
                                              batch=SG2_BATCH,
                                              pl_batch=SG2_BATCH // 2),
            SG2_PL_STEP: stylegan2_step_launches(mc, False, True,
                                                 batch=SG2_BATCH,
                                                 pl_batch=SG2_BATCH // 2)}


def sg2_serving(card: str) -> dict:
    """``BatchSampler`` on a full-width stylegan2-256 G (bf16, seeded random
    weights, every term live) at batch 32: launches per batch as derived,
    index stability, a float32 pair on the card against the CPU, img/s,
    batch latency and a profile."""
    cfg = get_config("stylegan2-256")
    mc = cfg.model
    assert (mc.resolution, mc.latent_dim, mc.fmap_base, cfg.run.compute_dtype,
            mc.d_resnet) == (256, 512, 8192, "bfloat16", True)
    sampler = make_sampler(cfg)
    t0 = time.perf_counter()
    sampler.warmup()
    log(f"stylegan2: warmup batch {time.perf_counter() - t0:.2f} s")
    reset_counts()
    a = sampler.generate(100, seed=0)
    b = sampler.generate(10, seed=0)
    counts = {n: k["kernel"].launches for n, k in KERNELS.items()}
    per_batch = launch_totals(stylegan2_serving_launches(mc))
    if counts != {n: 5 * v for n, v in per_batch.items()}:
        raise AssertionError(f"stylegan2 serving: launches {counts} in 5 "
                             f"batches, derived {per_batch} a batch")
    if _nhwc_counts() != _resample_only(counts):   # channels-last G
        raise AssertionError(f"stylegan2 serving: NHWC launches "
                             f"{_nhwc_counts()} of {counts}")
    assert a.shape == (100, 256, 256, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a[:10], b)
    assert float(a.astype(np.float32).std()) > 1.0, "images are flat"

    f32_card_vs_cpu("stylegan2-256", sampler)
    out = serving_speed(sampler)
    prof = profile_call(f"one served stylegan2-256 batch of {BATCH}",
                        lambda: sampler.generate(BATCH, seed=500), card,
                        top=8)
    out.update(idle_share=prof["idle_share"], launches=counts)
    log(f"stylegan2: BatchSampler at batch {BATCH}: {out['img_per_s']:.1f} "
        "img/s over "
        f"{8 * BATCH} images; batch latency median "
        f"{out['batch_ms_median']:.2f} ms max {out['batch_ms_max']:.2f} ms "
        f"(8 batches); idle share {prof['idle_share']:.3f}; launches per "
        f"batch {per_batch} [{card}]")
    return out


def sg2_check_run(cfg, run: dict, workdir: str, card: str) -> dict:
    """Every step ran its program with the derived launch counts; R1 on
    every 16th step, path length on every 4th: ``pl_penalty`` finite and >
    0 on those, 0 on the others; ms per step of each program, img/s per
    16-step cycle."""
    mc = cfg.model
    with open(os.path.join(workdir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    recs = run["records"]
    if len(recs) != SG2_STEPS or [r["step"] for r in rows] != \
            list(range(1, SG2_STEPS + 1)):
        raise AssertionError(f"stylegan2: {len(recs)} steps, {len(rows)} "
                             "log rows")
    launches = {n: 0 for n in KERNELS}
    for r, row in zip(recs, rows):
        want = launch_totals(stylegan2_step_launches(
            mc, r["r1"], r["pl"], batch=SG2_BATCH, pl_batch=SG2_BATCH // 2))
        if r["counts"] != want or r["shape"] != (SG2_BATCH, 256, 256, 3) \
                or r["device"] != "cuda":
            raise AssertionError(f"stylegan2: step {r['step']} launches "
                                 f"{r['counts']}, derived {want}")
        for n in launches:
            launches[n] += r["counts"][n]
        vals = [row[k] for k in ("d_loss", "g_loss", "penalty", "real_score",
                                 "fake_score", "pl_penalty")]
        if not all(math.isfinite(v) for v in vals) or \
                (row["pl_penalty"] > 0) != r["pl"] or \
                (row["penalty"] > 0) != r["r1"]:
            raise AssertionError(f"stylegan2: step {r['step']} "
                                 f"(R1 {r['r1']}, PL {r['pl']}): {row}")
    ms = {}
    for key, name in SG2_PROGRAMS.items():
        # the first step of each program builds cuDNN's plans
        first = next(i for i, r in enumerate(recs)
                     if (r["r1"], r["pl"]) == key)
        ms[name] = [r["ms"] for i, r in enumerate(recs)
                    if (r["r1"], r["pl"]) == key and i > first]
    cycles = [sum(r["ms"] for r in recs[c:c + 16]) / 1e3
              for c in (16, 32)]
    out = dict(ms={k: statistics.median(v) for k, v in ms.items()},
               img_s_cycle=[16 * SG2_BATCH / c for c in cycles],
               launches=launches, first_ms=recs[0]["ms"],
               pl_penalties=[row["pl_penalty"] for row in rows
                             if row["pl_penalty"] > 0])
    log(f"stylegan2: cli train, {SG2_STEPS} steps at batch {SG2_BATCH}, "
        "ms per step (median after each program's first): "
        + ", ".join(f"{k} {v:.2f} (of {len(ms[k])})"
                    for k, v in out["ms"].items())
        + f"; img/s over the 16-step cycles 16..31 and 32..47: "
        f"{out['img_s_cycle'][0]:.1f}, {out['img_s_cycle'][1]:.1f}; first "
        f"step {out['first_ms']:.0f} ms; peak memory {run['peak_gib']:.2f} "
        "GiB; pl_penalty on PL steps "
        f"{[round(v, 4) for v in out['pl_penalties']]} [{card}]")
    return out


def sg2_resume(cfg, live, workdir: str) -> None:
    """A second Trainer on the workdir holds the live state bit for bit;
    the next two steps from both (step 48: R1 and path length; step 49:
    neither) end in the same bits, under cuDNN's deterministic
    algorithms; serving from the workdir equals serving the live G-EMA."""
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    second = Trainer(cfg, workdir)
    try:
        if second.state.step != live.step or live.step != SG2_STEPS:
            raise AssertionError(f"stylegan2 resume: at step "
                                 f"{second.state.step}, live {live.step}")
        n = _assert_states_equal("stylegan2 resume", second.state, live)
        a = BatchSampler(cfg, workdir=workdir, batch_size=4).generate(
            4, seed=3)
        b = BatchSampler(cfg, state=live, batch_size=4).generate(4, seed=3)
        if not np.array_equal(a, b):
            raise AssertionError("stylegan2: serving from the workdir "
                                 "differs from the live G-EMA")
        source = make_source(cfg.data, 256, seed=123)
        reals = [torch.from_numpy(source.batch(SG2_BATCH, 256)).cuda()
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
                    raise AssertionError(f"stylegan2 resume: {m1} vs {m2}")
        finally:
            torch.backends.cudnn.deterministic = False
        if not float(m1["pl_penalty"]) == 0.0 or \
                not float(second.state.pl_mean) > 0:
            raise AssertionError("stylegan2 resume: no PL step crossed")
        n = _assert_states_equal("stylegan2 resume + 2 steps", second.state,
                                 live)
        log(f"stylegan2: a second Trainer resumed at step {SG2_STEPS} with "
            f"all {n} leaves (pl_mean {float(live.pl_mean):.5f} among "
            "them) bit-equal; steps 48 (R1 + PL) and 49 from both: "
            "bit-equal; serving from the workdir equals the live G-EMA")
    finally:
        second.close()


def sg2_profiles(cfg, state, card) -> dict:
    """One step of each program profiled (the top device operations and
    the idle share), then the path-length term of a PL step alone: its
    forward with the gradient with respect to the styles, and its outer
    backward (the double backward through the synthesis), timed, and the
    backward profiled with the share of its device time in cuDNN's
    convolutions."""
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    source = make_source(cfg.data, 256, seed=7)
    real = torch.from_numpy(source.batch(SG2_BATCH, 256)).cuda()
    out = {}
    for (r1, pl), name in SG2_PROGRAMS.items():
        step = train_steps.build_train_step(cfg, phase, penalty_override=r1,
                                            pl_override=pl)
        step(state, real)
        out[name] = profile_call(f"one stylegan2-256 {name} step (batch "
                                 f"{SG2_BATCH})", lambda: step(state, real),
                                 card, top=10)
    dr = train_steps.draw_pl(cfg, 8, SG2_BATCH, state.generator,
                             state.device)
    lc = cfg.loss

    def term():
        return train_steps.path_length_penalty(
            state.g, state.pl_mean, dr, 8, 1.0,
            weight=lc.pl_weight * lc.pl_every, decay=lc.pl_decay)

    times = {"forward + style gradient": [], "outer backward": []}
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pen = term()[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pen.backward()
        torch.cuda.synchronize()
        times["forward + style gradient"].append((t1 - t0) * 1e3)
        times["outer backward"].append((time.perf_counter() - t1) * 1e3)
    state.g.zero_grad(set_to_none=True)
    pl_ms = {k: statistics.median(v[1:]) for k, v in times.items()}
    pen = term()[0]
    names = profile_call(f"the PL term's outer backward (batch "
                         f"{SG2_BATCH // 2})", pen.backward, card,
                         top=6)["by_name"]
    state.g.zero_grad(set_to_none=True)
    total = sum(names.values())
    conv = sum(v for k, v in names.items() if is_conv_kernel(k))
    out["pl_ms"] = pl_ms
    out["pl_backward_conv_share"] = conv / total
    step_ms = out["PL"]["wall_ms"]
    log(f"stylegan2: the PL term at batch {SG2_BATCH // 2}: forward + "
        f"style gradient {pl_ms['forward + style gradient']:.2f} ms, outer "
        f"backward {pl_ms['outer backward']:.2f} ms (median of 3), "
        f"together {sum(pl_ms.values()) / step_ms:.3f} of a profiled PL "
        f"step ({step_ms:.2f} ms); cuDNN / conv kernels are "
        f"{conv / total:.3f} of the outer backward's device time "
        f"({conv:.2f} of {total:.2f} ms) [{card}]")
    return out


CONV_NAMES = ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad", "wgrad",
              "fprop", "cutlass")


def is_conv_kernel(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in CONV_NAMES)


def phase_stylegan2(card: str) -> dict:
    """StyleGAN2 at full width through its entry points: serving at batch
    32; ``cli train --preset stylegan2-256`` on the preset's own
    (``synthetic``) data at its batch of 8 for 48 steps (R1 at 0, 16, 32,
    path length every 4th: all three programs), launch counts per step as
    derived, ``pl_penalty`` and ``pl_mean``; resume bit for bit across a PL
    step; one step of each program profiled and the PL term's parts timed;
    an R1 + PL step in float32 card vs CPU (1e-3 of each leaf's scale, the
    mapping layers included); ``cli sample`` and ``cli eval-ppl --space
    w``."""
    serving = sg2_serving(card)
    sets = {"run.log_every": 1, "run.checkpoint_every": 10 ** 6,
            # a step a call: every step's launches are checked
            "run.chunk_steps": False}
    cfg = get_config("stylegan2-256", **sets)
    lc = cfg.loss
    assert (cfg.schedule.progressive, cfg.schedule.batch_for(256),
            lc.penalty, lc.penalty_every, lc.pl_weight, lc.pl_every,
            cfg.data.dataset) == (False, SG2_BATCH, "r1", 16, 2.0, 4,
                                  "synthetic")
    launches = {n: 0 for n in KERNELS}
    for n in launches:
        launches[n] += serving["launches"][n]
    workdir = tempfile.mkdtemp(prefix="ganlab_sg2_")
    try:
        run = run_cli_train("stylegan2-256", sets, workdir,
                            max_steps=SG2_STEPS)
        checked = sg2_check_run(cfg, run, workdir, card)
        for n in launches:
            launches[n] += checked["launches"][n]
        live = run["live"]
        if not float(live.pl_mean) > 0:
            raise AssertionError("stylegan2: pl_mean did not move off 0")
        log(f"stylegan2: cli train took {run['wall_s']:.1f} s; pl_mean "
            f"{float(live.pl_mean):.5f} after {SG2_STEPS} steps [{card}]")
        sg2_resume(cfg, live, workdir)
        prof = sg2_profiles(cfg, live, card)
        phase_train_card_vs_cpu("stylegan2-256", rtol=WGAN_GP_GRAD_RTOL)
        png = os.path.join(workdir, "sg2_sample.png")
        secs = {}
        for label, fn in (
                ("cli sample", lambda: port_cli.main(
                    ["sample", "--workdir", workdir, "--num", "4", "--out",
                     png])),
                ("cli eval-ppl --space w", lambda: port_cli.main(
                    ["eval-ppl", "--workdir", workdir, "--num-samples",
                     str(SG2_PPL_SAMPLES), "--space", "w"]))):
            t0 = time.perf_counter()
            c = counted(label, fn, need=("pixelnorm", "upsample_blur_2x"))
            secs[label] = time.perf_counter() - t0
            for n in launches:
                launches[n] += c[n]
            log(f"stylegan2: {label} took {secs[label]:.1f} s [{card}]")
        check_png(png, "cli sample (stylegan2-256)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(launches=launches, serving=serving, train=checked,
                peak_gib=run["peak_gib"], prof=prof, secs=secs)


# -- 11. accumulation, data parallelism, export ----------------------------
ACCUM_MICRO = 16               # a microbatch of the fixed-256² step
DP_STEPS = 3                   # R1 on the first (penalty_every 16)
DP_GRAD_RTOL = 1e-2            # DP ranks vs one accumulating process, bf16,
                               # of each gradient leaf's scale
ACCUM_1K = 4                   # microbatches of the 1024² step


def _launch_counts() -> dict:
    return {n: k["kernel"].launches for n, k in KERNELS.items()}


def _scaled_totals(launches: dict, times: int) -> dict:
    return {n: times * v for n, v in launch_totals(launches).items()}


def _timed_step(step, state, real):
    """(state, metrics, ms, launches) of one step, the counts set to 0
    just before it and read just after."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, real)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return state, {k: float(v) for k, v in m.items()}, ms, _launch_counts()


def _check_accum_step(label: str, m: dict, counts: dict, expect: dict,
                      r1: bool) -> None:
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"{label}: non-finite metrics {m}")
    if (m["penalty"] > 0) != r1:
        raise AssertionError(f"{label}: penalty {m['penalty']}")
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts}, derived {expect}")


def phase_accum(card: str) -> dict:
    """The fixed-256² stylegan-256 step (full width, bf16) with
    ``optim.grad_accum`` = 2 at a microbatch of 16: an R1-on and an
    R1-off step, each twice (the second timed); every step's launches
    twice a microbatch's (``step_launches`` at batch 16)."""
    cfg = training_config(**{"optim.grad_accum": 2,
                             "schedule.batch_schedule": {256: ACCUM_MICRO}})
    mc = cfg.model
    phase = build_phases(cfg.schedule, mc)[-1]
    state = create_train_state(cfg, seed=0)
    gdata = torch.Generator(device="cuda").manual_seed(21)
    real = torch.randint(0, 256, (2 * ACCUM_MICRO, 256, 256, 3),
                         generator=gdata, device="cuda", dtype=torch.uint8)
    totals = {n: 0 for n in KERNELS}
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for r1 in (True, False):
        step = train_steps.build_train_step(cfg, phase, penalty_override=r1)
        expect = _scaled_totals(step_launches(mc, r1, batch=ACCUM_MICRO), 2)
        for i in range(2):
            state, m, ms, counts = _timed_step(step, state, real)
            _check_accum_step(f"accum R1-{'on' if r1 else 'off'} {i}", m,
                              counts, expect, r1)
            for n in totals:
                totals[n] += counts[n]
            log(f"accum: stylegan-256 256² grad_accum 2 x {ACCUM_MICRO} "
                f"R1-{'on ' if r1 else 'off'} call {i}: {ms:.2f} ms, "
                f"launches {counts} (2 x a microbatch's) "
                + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
        out["ms_r1_on" if r1 else "ms_r1_off"] = ms
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if state.shown_imgs != 4 * 2 * ACCUM_MICRO:
        raise AssertionError(f"accum: shown {state.shown_imgs}")
    log(f"accum: {out['ms_r1_on']:.2f} ms an R1-on, {out['ms_r1_off']:.2f} "
        f"ms an R1-off step of 2 x {ACCUM_MICRO} images; peak memory "
        f"{peak:.2f} GiB [{card}]")
    del state
    torch.cuda.empty_cache()
    return dict(out, peak_gib=peak, launches=totals)


def phase_pl_accum(card: str) -> dict:
    """stylegan2-256 at its preset batch of 8 with ``optim.grad_accum`` =
    2 through two path-length steps (the second timed): ``pl_mean`` moves
    once a microbatch with the decay 1 - (1 - pl_decay)^(1/2), from each
    microbatch's mean length; launches twice a microbatch's."""
    cfg = get_config("stylegan2-256", **{"optim.grad_accum": 2})
    mc, lc = cfg.model, cfg.loss
    phase = build_phases(cfg.schedule, mc)[-1]
    micro = phase.batch_size
    state = create_train_state(cfg, seed=0)
    state.pl_mean.fill_(0.25)
    seen, penalty = [], train_steps.path_length_penalty

    def recording(g, pl_mean, dr, *a, **k):
        out = penalty(g, pl_mean, dr, *a, **k)
        seen.append((pl_mean.item(), out[2].mean().item(), out[1].item()))
        return out

    gdata = torch.Generator(device="cuda").manual_seed(22)
    real = torch.randint(0, 256, (2 * micro, 256, 256, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    step = train_steps.build_train_step(cfg, phase, penalty_override=False,
                                        pl_override=True)
    expect = _scaled_totals(stylegan2_step_launches(
        mc, False, True, batch=micro,
        pl_batch=train_steps.pl_batch(cfg, micro)), 2)
    dm = 1.0 - (1.0 - lc.pl_decay) ** 0.5
    want = 0.25
    for i in range(2):
        seen.clear()
        train_steps.path_length_penalty = recording
        try:
            state, m, ms, counts = _timed_step(step, state, real)
        finally:
            train_steps.path_length_penalty = penalty
        _check_accum_step(f"pl accum {i}", m, counts, expect, False)
        chain = [f"{want:.6f}"]
        for mean_in, length, new in seen:
            if abs(mean_in - want) > 1e-5 * max(abs(want), 1.0):
                raise AssertionError(f"pl accum: microbatch took pl_mean "
                                     f"{mean_in}, chained {want}")
            want = want + dm * (length - want)
            if abs(new - want) > 1e-5 * max(abs(want), 1.0):
                raise AssertionError(f"pl accum: pl_mean {new}, chained "
                                     f"{want}")
            chain.append(f"{new:.6f} (mean length {length:.4f})")
            want = new
        if len(seen) != 2 or state.pl_mean.item() != want or \
                not m["pl_penalty"] > 0:
            raise AssertionError(f"pl accum: {seen}, state "
                                 f"{state.pl_mean.item()}")
        log(f"accum: stylegan2-256 PL step grad_accum 2 x {micro}, call "
            f"{i}: {ms:.2f} ms, launches {counts}; pl_mean "
            + " -> ".join(chain) + f", decay a microbatch {dm:.6g} "
            f"(pl_decay {lc.pl_decay}) [{card}]")
    del state
    torch.cuda.empty_cache()
    return dict(ms=ms, launches=counts)


def _dp_state(cfg):
    """A full-width state from seed 0 with every term live (the 4x4 planes
    are constant at init, where AdaIN's gradient is rounding noise)."""
    state = create_train_state(cfg, seed=0)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for net in (state.g, state.d):
            for k, v in net.state_dict().items():
                if k.endswith(("noise.scale", ".bias", ".b", "const")):
                    v += 0.2 * torch.randn(v.shape, generator=gen).to(v)
    return state


def _dp_shard() -> torch.Tensor:
    gdata = torch.Generator(device="cuda").manual_seed(23)
    return torch.randint(0, 256, (ACCUM_MICRO, 256, 256, 3),
                         generator=gdata, device="cuda", dtype=torch.uint8)


def _grads(state) -> dict:
    return {f"{net}.{k}": p.grad.detach().clone()
            for net in ("g", "d")
            for k, p in getattr(state, net).named_parameters()
            if p.grad is not None}


def _dp_rank(rank: int, world: int, port: int, outdir: str,
             sets: dict | None = None) -> None:
    """One rank of ``phase_dp`` (a spawned process); ``sets`` adds to the
    configuration of both the ranks and the reference."""
    import hashlib

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cudnn.deterministic = True
    pdist.initialize("gloo", device="cuda:0", rank=rank, world_size=world,
                     init_method=f"tcp://localhost:{port}")
    sets = sets or {}
    cfg = training_config(**{"schedule.batch_schedule": {256: ACCUM_MICRO},
                             **sets})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = _dp_state(cfg)
    pdist.broadcast_state(state)
    stepper = make_lazy_stepper(cfg, phase)
    shard = _dp_shard()                      # the same images on each rank
    reset_counts()
    ms, grads = [], None
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = stepper(state, shard)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = _grads(state)
            metrics0 = {k: float(v) for k, v in m.items()}
    counts = _launch_counts()
    digest = hashlib.sha256()
    for k, v in sorted(state_tensors(state).items()):
        digest.update(k.encode())
        digest.update(v.detach().cpu().reshape(-1).view(torch.uint8)
                      .numpy().tobytes())
    out = dict(rank=rank, ms=ms, launches=counts, digest=digest.hexdigest(),
               shown=state.shown_imgs, world=pdist.world_size(),
               metrics0=metrics0)
    pdist.shutdown()
    del state
    if rank == 0:
        # the reference: one process, grad_accum = 2 over the two shards,
        # whose microbatch j draws what rank j drew
        cfg2 = training_config(**{
            "schedule.batch_schedule": {256: ACCUM_MICRO},
            "optim.grad_accum": 2, **sets})
        ref = _dp_state(cfg2)
        ref, m = make_lazy_stepper(cfg2, phase)(ref,
                                                torch.cat([shard, shard]))
        want = _grads(ref)
        if set(want) != set(grads):
            raise AssertionError("dp: other gradient leaves than the "
                                 "reference")
        rels = sorted(((grads[k] - w).float().abs().max().item()
                       / max(w.float().abs().max().item(), 1e-30), k)
                      for k, w in want.items())
        out.update(worst=rels[-1], n_leaves=len(rels),
                   ref_metrics={k: float(v) for k, v in m.items()})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_dp(card: str, sets: dict | None = None,
             label: str = "dp") -> dict:
    """Data parallelism on the one card: two ranks spawned over ``gloo``
    on ``cuda:0`` (NCCL refuses two ranks on one device), identical
    shards of 16 images, the fixed-256² stylegan-256 step at full width
    for three steps (R1 on the first). Their D and G gradients of the
    first step against the one-process ``grad_accum`` = 2 step fed both
    microbatches (whose draws are the ranks'), within ``DP_GRAD_RTOL`` of
    each leaf's scale; the two ranks' states bitwise identical after
    three steps (sha256 of every state tensor, the generator included).
    Two ranks sharing one card measure correctness, not a DP speed.
    ``sets`` (ADA's, phase 13) adds to the configuration; with
    ``aug.mode=ada`` the first step's rt of the ranks (their mean) and of
    the one process (the microbatches' mean) are the same bits (each a
    mean of signs, exact in float32, of scores from the same deterministic
    forwards), and so is the p each moved by the rule."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outdir = tempfile.mkdtemp(prefix="ganlab_dp_")
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _dp_rank, args=(2, port, outdir, sets), nprocs=2, join=True,
        start_method="spawn")
    wall = time.perf_counter() - t0
    r = []
    for i in range(2):
        with open(os.path.join(outdir, f"rank{i}.json")) as f:
            r.append(json.load(f))
    shutil.rmtree(outdir, ignore_errors=True)
    worst, leaf = r[0]["worst"]
    if r[0]["digest"] != r[1]["digest"]:
        raise AssertionError("dp: the two ranks' states differ")
    if not worst <= DP_GRAD_RTOL:
        raise AssertionError(f"dp: gradient {leaf} {worst:.3e} of its scale")
    if r[0]["shown"] != DP_STEPS * 2 * ACCUM_MICRO or r[0]["world"] != 2:
        raise AssertionError(f"dp: shown {r[0]['shown']}")
    need = ("pixelnorm", "adain", "upsample_blur_2x", "blur_downsample_2x",
            "minibatch_stddev")
    if any(x["launches"][n] == 0 for x in r for n in need):
        raise AssertionError(f"dp: launches {[x['launches'] for x in r]}")
    if sets and sets.get("aug.mode") == "ada":
        got, ref = r[0]["metrics0"], r[0]["ref_metrics"]
        rate = float(np.float32(2 * ACCUM_MICRO)
                     / np.float32(training_config(**sets).aug.kimg * 1000))
        p0 = sets["aug.p_init"]
        for m in (got, ref):
            want = np.float32(p0) + np.float32(
                np.sign(m["aug_rt"] - 0.6)) * np.float32(rate)
            if abs(m["aug_p"] - float(want)) > 1e-7:
                raise AssertionError(f"{label}: aug_p {m}, want {want}")
        if got["aug_rt"] != ref["aug_rt"] or got["aug_p"] != ref["aug_p"]:
            raise AssertionError(f"{label}: rt, p {got} vs one process "
                                 f"{ref}")
    log(f"{label}: two gloo ranks on one card, {DP_STEPS} steps of 2 x "
        f"{ACCUM_MICRO} images: states bitwise identical (sha256 "
        f"{r[0]['digest'][:16]}); step-0 gradients vs one process with "
        f"grad_accum 2: {r[0]['n_leaves']} leaves, worst {worst:.3e} of the "
        f"leaf scale ({leaf}; tol {DP_GRAD_RTOL:g}, bf16); metrics rank 0 "
        f"{r[0]['metrics0']} one process {r[0]['ref_metrics']}; launches a "
        f"rank {r[0]['launches']}")
    log(f"{label}: ms a step on rank 0 "
        f"{[round(x, 2) for x in r[0]['ms']]}, rank "
        f"1 {[round(x, 2) for x in r[1]['ms']]}; {wall:.1f} s for the phase "
        f"with the spawns. Two ranks share one card here: this is a check "
        f"of correctness, not a data-parallel speed [{card}]")
    return dict(launches=r[0]["launches"], worst=worst, ms=r[0]["ms"])


def phase_1024_accum(card: str) -> dict:
    """stylegan-1024 as the preset has it (remat, batch 4 at 1024²) with
    ``optim.grad_accum`` = 4 in its 1024² phase: an R1-on and two R1-off
    steps of 4 x 4 images, launches four times a microbatch's (remat's
    recomputes included), peak memory."""
    cfg = get_config("stylegan-1024", **{"optim.grad_accum": ACCUM_1K})
    mc = cfg.model
    phase = build_phases(cfg.schedule, mc)[-1]
    micro = phase.batch_size
    assert mc.remat and phase.resolution == 1024 and micro == 4, phase
    state = create_train_state(cfg, seed=0)
    state.shown_imgs = phase.start_img
    gdata = torch.Generator(device="cuda").manual_seed(24)
    real = torch.randint(0, 256, (ACCUM_1K * micro, 1024, 1024, 3),
                         generator=gdata, device="cuda", dtype=torch.uint8)
    stepper = make_lazy_stepper(cfg, phase)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, ms_all = {n: 0 for n in KERNELS}, []
    for i in range(3):
        r1 = i == 0
        state, m, ms, counts = _timed_step(stepper, state, real)
        _check_accum_step(f"1024 accum step {i}", m, counts, _scaled_totals(
            step_launches(mc, r1, batch=micro), ACCUM_1K), r1)
        for n in totals:
            totals[n] += counts[n]
        ms_all.append(ms)
        log(f"accum: stylegan-1024 1024² grad_accum {ACCUM_1K} x {micro} "
            f"step {i} R1-{'on ' if r1 else 'off'}: {ms:.2f} ms, launches "
            f"{counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"accum: stylegan-1024 at 1024² with remat and {ACCUM_1K} "
        f"microbatches of {micro}: {ms_all[0]:.1f} ms R1-on, "
        f"{statistics.median(ms_all[1:]):.1f} ms R1-off; peak memory "
        f"{peak:.2f} GiB [{card}]")
    del state
    torch.cuda.empty_cache()
    return dict(ms=ms_all, peak_gib=peak, launches=totals)


def phase_export(card: str) -> dict:
    """``export_sampler`` -> ``ExportedSampler`` for stylegan-256 (full
    width, bf16, seeded random weights as in phase 5), programs for cuda
    and cpu, a batch of 32: images against ``BatchSampler``'s for the same
    seeds (at most one level apart, more than 99% equal); the loaded cuda
    program's launches per batch (1 pixelnorm, 14 AdaIN, 6 up+blur, read
    from the wrappers' counts); img/s of both at a batch of 32."""
    cfg = get_config("stylegan-256")
    sampler = make_sampler(cfg)
    path = os.path.join(tempfile.mkdtemp(prefix="ganlab_export_"),
                        "sampler.ganlab.zip")
    t0 = time.perf_counter()
    # what export_sampler reads of a state: the G-EMA and the w-average
    export_sampler(cfg, types.SimpleNamespace(g_ema=sampler.g,
                                              w_avg=sampler.w_avg),
                   path, batch_size=BATCH)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exported = ExportedSampler(path)
    load_s = time.perf_counter() - t0
    if exported.meta["platforms"] != ["cuda", "cpu"]:
        raise AssertionError(f"export: platforms {exported.meta}")
    exported.generate(1, seed=0)                       # first call
    reset_counts()
    a = exported.generate(2 * BATCH, seed=3)
    counts = _launch_counts()
    expect = {"pixelnorm": 2, "pixelnorm_nchw": 0, "adain": 28,
              "upsample_blur_2x": 12, "blur_downsample_2x": 0,
              "minibatch_stddev": 0}
    if counts != expect:
        raise AssertionError(f"export: launches {counts}, expected {expect}")
    b = sampler.generate(2 * BATCH, seed=3)
    diff = np.abs(a.astype(int) - b.astype(int))
    equal = float((a == b).mean())
    if a.shape != b.shape or diff.max() > 1 or not equal > 0.99:
        raise AssertionError(f"export: max level difference {diff.max()}, "
                             f"equal share {equal}")
    ex_speed, live_speed = serving_speed(exported), serving_speed(sampler)
    size = os.path.getsize(path) / 2 ** 20
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    log(f"export: stylegan-256 artifact {size:.1f} MiB (cuda + cpu "
        f"programs) in {export_s:.1f} s, loaded in {load_s:.1f} s; "
        f"{2 * BATCH} images vs BatchSampler: max level difference "
        f"{diff.max()}, equal {equal:.6f}; launches {counts}")
    log(f"export: a batch of {BATCH}: exported program "
        f"{ex_speed['img_per_s']:.1f} img/s (latency median "
        f"{ex_speed['batch_ms_median']:.2f} ms), BatchSampler "
        f"{live_speed['img_per_s']:.1f} img/s "
        f"({live_speed['batch_ms_median']:.2f} ms) [{card}]")
    return dict(launches=counts, img_per_s=ex_speed["img_per_s"],
                live_img_per_s=live_speed["img_per_s"])


# -- 12. Inception at full size -----------------------------------------------
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


# -- 13. ADA augmentation ---------------------------------------------------
# the step at the bench.py configuration without augmentation, with blit +
# color and with all six categories; p starts at 0.5 (the work of a step
# does not depend on p: every transform is computed and selected per sample)
AUG_MODES = {"off": {},
             "bc": {"aug.mode": "ada", "aug.categories": "bc",
                    "aug.p_init": 0.5},
             "bcgfnu": {"aug.mode": "ada", "aug.categories": "bcgfnu",
                        "aug.p_init": 0.5}}
AUG_ROUNDS = 3                 # timed rounds in turns, after a warm-up round
AUG_RTOL = 1e-5                # card vs CPU augmentation, float32, of scale
ADA_KIMG = 0.32                # p moves 0.1 a step of 32 images


def _event():
    return torch.cuda.Event(enable_timing=True)


class AugTimer:
    """CUDA events around every ``apply_augment`` the step module calls: its
    forward, and where the result takes a gradient its backward, from the
    output's gradient to the input's (the autograd engine runs the
    augmentation's nodes between the two, alone on the stream: D's
    backward is done, G's waits for the input's gradient)."""

    def __init__(self):
        self.spans = []
        self._fn = train_steps.apply_augment

    def __enter__(self):
        fn = self._fn

        def timed(x, params):
            s, e = _event(), _event()
            s.record()
            out = fn(x, params)
            e.record()
            self.spans.append(("fwd", s, e))
            if out.requires_grad and x.requires_grad:
                bs, be = _event(), _event()
                out.register_hook(lambda g: bs.record())
                x.register_hook(lambda g: be.record())
                self.spans.append(("bwd", bs, be))
            return out

        train_steps.apply_augment = timed
        return self

    def __exit__(self, *exc):
        train_steps.apply_augment = self._fn

    def take_ms(self) -> dict:
        torch.cuda.synchronize()
        out = {"fwd": 0.0, "bwd": 0.0}
        for kind, s, e in self.spans:
            out[kind] += s.elapsed_time(e)
        self.spans.clear()
        return out


def _ada_p_rule(p_before: float, rt: float, rate: float, p_max=0.8) -> float:
    """The JAX package's ``ada_update`` in float32."""
    f = np.float32
    p = f(p_before) + f(np.sign(f(rt) - f(0.6))) * f(rate)
    return float(np.clip(p, f(0.0), f(p_max)))


def _check_ada_metrics(label: str, m: dict, p_before, rate: float) -> None:
    if p_before is None:
        if "aug_p" in m or "aug_rt" in m:
            raise AssertionError(f"{label}: aug metrics without ADA: {m}")
        return
    want = _ada_p_rule(p_before, m["aug_rt"], rate)
    if abs(m["aug_p"] - want) > 1e-7 or not -1.0 <= m["aug_rt"] <= 1.0:
        raise AssertionError(f"{label}: aug_p {m['aug_p']} from p "
                             f"{p_before} and rt {m['aug_rt']}, want {want}")


def phase_ada(card: str) -> dict:
    """ADA at the bench.py configuration (stylegan-256, fixed 256², batch
    32, bf16, lazy R1), full width, seeded live weights: the step without
    augmentation, with ``bc`` and with ``bcgfnu`` (p from 0.5), R1-off and
    R1-on, read in turns over ``AUG_ROUNDS`` rounds after a warm-up round;
    every step's launches of our kernels equal aug-off's
    (``step_launches``: augmentation launches none of them), p moves by the
    rule from the step's rt, the metrics carry aug_p / aug_rt only with
    ADA; the augmentation's own device time (forward in the D and G
    phases, backward in the G phase) read by CUDA events around it; peak
    memory of each step in the last round; one R1-off step of each mode
    profiled. Then ``ada_checks``."""
    mc = training_config().model
    expect = {r1: launch_totals(step_launches(mc, r1)) for r1 in (False, True)}
    gdata = torch.Generator(device="cuda").manual_seed(31)
    real = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    runs = {}
    for mode, sets in AUG_MODES.items():
        cfg = training_config(**sets)
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        runs[mode] = dict(
            cfg=cfg, state=_dp_state(cfg),
            steps={r1: train_steps.build_train_step(
                cfg, phase, penalty_override=r1) for r1 in (False, True)},
            rate=float(np.float32(BATCH) / np.float32(cfg.aug.kimg * 1000)),
            ms={False: [], True: []}, aug={False: [], True: []},
            peak={})
    totals = {n: 0 for n in KERNELS}
    with AugTimer() as timer:
        for rnd in range(AUG_ROUNDS + 1):
            for mode, run in runs.items():
                for r1 in (False, True):
                    st = run["state"]
                    p_before = None if st.ada_p is None else st.ada_p.item()
                    if rnd == AUG_ROUNDS:
                        torch.cuda.reset_peak_memory_stats()
                    st, m, ms, counts = _timed_step(run["steps"][r1], st,
                                                    real)
                    if rnd == AUG_ROUNDS:
                        run["peak"][r1] = \
                            torch.cuda.max_memory_allocated() / 2 ** 30
                    run["state"] = st
                    aug = timer.take_ms()
                    label = f"ada {mode} R1-{'on' if r1 else 'off'} {rnd}"
                    _check_accum_step(label, m, counts, expect[r1], r1)
                    _check_ada_metrics(label, m, p_before, run["rate"])
                    if (aug["fwd"] > 0) != (mode != "off") or \
                            (aug["bwd"] > 0) != (mode != "off"):
                        raise AssertionError(f"{label}: augment ms {aug}")
                    for n in totals:
                        totals[n] += counts[n]
                    if rnd:
                        run["ms"][r1].append(ms)
                        run["aug"][r1].append(aug["fwd"] + aug["bwd"])
                    log(f"ada: {mode:6s} R1-{'on ' if r1 else 'off'} round "
                        f"{rnd}: {ms:8.2f} ms, augmentation fwd "
                        f"{aug['fwd']:.3f} bwd {aug['bwd']:.3f} ms, "
                        + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
    out = {}
    for mode, run in runs.items():
        row = out[mode] = {
            "ms_r1_off": statistics.median(run["ms"][False]),
            "ms_r1_on": statistics.median(run["ms"][True]),
            "aug_ms_r1_off": statistics.median(run["aug"][False]),
            "aug_ms_r1_on": statistics.median(run["aug"][True]),
            "peak_gib": run["peak"]}
        log(f"ada: {mode:6s}: {row['ms_r1_off']:.2f} ms an R1-off step, "
            f"{row['ms_r1_on']:.2f} ms an R1-on step (medians of "
            f"{AUG_ROUNDS}, in turns), augmentation "
            f"{row['aug_ms_r1_off']:.3f} / {row['aug_ms_r1_on']:.3f} ms of "
            f"device time, peak memory {row['peak_gib'][False]:.2f} / "
            f"{row['peak_gib'][True]:.2f} GiB (three full-width states "
            f"held) [{card}]")
    for mode in ("bc", "bcgfnu"):
        log(f"ada: {mode} against off: R1-off "
            f"{out[mode]['ms_r1_off'] - out['off']['ms_r1_off']:+.2f} ms "
            f"({out[mode]['ms_r1_off'] / out['off']['ms_r1_off'] - 1:+.3f}), "
            f"R1-on {out[mode]['ms_r1_on'] - out['off']['ms_r1_on']:+.2f} "
            f"ms ({out[mode]['ms_r1_on'] / out['off']['ms_r1_on'] - 1:+.3f})"
            f" [{card}]")
    with AugTimer() as timer:
        for mode, run in runs.items():
            timer.take_ms()

            def one():
                run["state"] = run["steps"][False](run["state"], real)[0]

            prof = profile_call(f"one ADA {mode} R1-off step", one, card,
                                top=10)
            aug = timer.take_ms()
            share = (aug["fwd"] + aug["bwd"]) / prof["busy_ms"]
            out[mode]["profile"] = dict(busy_ms=prof["busy_ms"],
                                        idle_share=prof["idle_share"],
                                        aug_ms=aug["fwd"] + aug["bwd"],
                                        aug_share=share)
            log(f"ada: {mode}: augmentation {aug['fwd']:.3f} ms forward + "
                f"{aug['bwd']:.3f} ms backward of the profiled step's "
                f"{prof['busy_ms']:.2f} ms device busy time: share "
                f"{share:.4f} [{card}]")
    runs.clear()
    torch.cuda.empty_cache()
    ada_checks(card)
    return dict(out, launches=totals)


def ada_checks(card: str) -> None:
    """The augmentation on the card against its plain run on the CPU (all
    six categories, one set of params at 256², batch 32, float32: values
    and the VJP within ``AUG_RTOL`` of their scale), its backward the same
    bits twice; p moving by the rule at ``aug.kimg`` 0.32 (0.1 a step)
    and a bitwise resume with ``ada_p`` under cuDNN's deterministic
    algorithms at full width; a short progressive ``cli train --set
    aug.mode=ada``; two gloo ranks with ADA against one process
    accumulating two (``phase_dp``)."""
    from ganlab_tpu_torch.ops.augment import apply_augment, sample_params

    gen = torch.Generator(device="cuda").manual_seed(32)
    params = sample_params(gen, BATCH, 256, 0.5, "bcgfnu")
    x = torch.rand(BATCH, 3, 256, 256, generator=gen, device="cuda") * 2 - 1
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        y = apply_augment(xx, params)
        (y * cot).sum().backward()
        grads.append(xx.grad)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("ada: the augmentation's backward differs "
                             "between two calls")
    moved = (y.detach() - x).abs().max().item()
    xc = x.cpu().requires_grad_(True)
    yc = apply_augment(xc, params.to("cpu"))
    (yc * cot.cpu()).sum().backward()
    errs = []
    for what, a, b in (("value", y.detach().cpu(), yc.detach()),
                       ("vjp", grads[0].cpu(), xc.grad)):
        err = (a - b).abs().max().item() / b.abs().max().item()
        errs.append(err)
        if not err <= AUG_RTOL:
            raise AssertionError(f"ada: card vs CPU {what} {err:.3e}")
    with torch.no_grad():
        bf = apply_augment(x.bfloat16(), params)
    if not bool(bf.isfinite().all()):
        raise AssertionError("ada: bf16 augmentation not finite")
    fwd = cuda_time_ms(lambda: apply_augment(x.bfloat16(), params),
                       iters=10, warmup=3)
    xb = x.bfloat16().requires_grad_(True)
    cb = cot.bfloat16()

    def fwd_bwd():
        (apply_augment(xb, params) * cb).sum().backward()

    both = cuda_time_ms(fwd_bwd, iters=10, warmup=3)
    log(f"ada: augmentation bcgfnu at ({BATCH}, 3, 256, 256) card vs CPU, "
        f"float32: value {errs[0]:.3e}, VJP {errs[1]:.3e} of the scale "
        f"(tol {AUG_RTOL:g}; the augmentation moved values by up to "
        f"{moved:.3f}); backward bitwise equal on two calls; bf16 "
        f"forward {fwd:.3f} ms, forward + backward {both:.3f} ms [{card}]")
    del xb, grads, y, yc, xc

    # p by the rule, and bitwise resume with ada_p
    cfg = training_config(**{**AUG_MODES["bcgfnu"], "aug.kimg": ADA_KIMG})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    rate = float(np.float32(BATCH) / np.float32(ADA_KIMG * 1000))
    gdata = torch.Generator(device="cuda").manual_seed(33)
    reals = [torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gdata,
                           device="cuda", dtype=torch.uint8)
             for _ in range(4)]
    chain = []

    def run(state, first, n):
        stepper = make_lazy_stepper(cfg, phase, initial_step=state.step)
        for i in range(first, first + n):
            p0 = state.ada_p.item()
            state, m = stepper(state, reals[i])
            m = {k: float(v) for k, v in m.items()}
            _check_ada_metrics(f"ada resume step {i}", m, p0, rate)
            chain.append((i, p0, m["aug_rt"], m["aug_p"]))
        return state

    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="ganlab_ada_")
    try:
        whole = run(_dp_state(cfg), 0, 4)
        part = run(_dp_state(cfg), 0, 2)
        mgr = CheckpointManager(root)
        mgr.save(part.step, part)
        del part
        resumed = mgr.restore(create_train_state(cfg, seed=1))
        resumed = run(resumed, 2, 2)
        n = _assert_states_equal("ada resume", whole, resumed)
        if "ada_p" not in state_tensors(resumed):
            raise AssertionError("ada resume: no ada_p in the state")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    log(f"ada: p by the rule at aug.kimg {ADA_KIMG} ({rate:g} a step): "
        + ", ".join(f"step {i} {p0:.4f} -> {p:.4f} (rt {rt:+.4f})"
                    for i, p0, rt, p in chain[:4])
        + f"; 2 steps + checkpoint + 2 resumed steps equal 4 steps on all "
        f"{n} leaves, ada_p {whole.ada_p.item():.6f} (cudnn deterministic)")
    del whole, resumed
    torch.cuda.empty_cache()
    ada_progressive(card)
    phase_dp(card, AUG_MODES["bcgfnu"], "dp ada")


def ada_progressive(card: str) -> None:
    """``cli train --preset stylegan-256 --set aug.mode=ada --set
    aug.categories=bcgfnu`` at full width, batch 32, two steps a phase
    through 8x8 stabilize, the 16x16 and 32x32 fade and stabilize phases
    (the filter's 21-pixel reflection wraps at 8x8 and 16x16): the launch
    counts of each step as without augmentation, and the logged aug_p
    moving by the rule from the logged aug_rt."""
    kimg = 2 * BATCH / 1000.0
    sets = {"data.dataset": "ellipses", "schedule.fade_kimg": kimg,
            "schedule.stabilize_kimg": kimg,
            "schedule.batch_schedule": {2 ** lg: BATCH for lg in range(2, 9)},
            "run.log_every": 1, "aug.mode": "ada",
            "aug.categories": "bcgfnu", "aug.p_init": 0.3,
            "aug.kimg": ADA_KIMG}
    cfg = get_config("stylegan-256", **sets)
    phases = build_phases(cfg.schedule, cfg.model)[:5]
    rate = float(np.float32(BATCH) / np.float32(ADA_KIMG * 1000))
    workdir = tempfile.mkdtemp(prefix="ganlab_ada_cli_")
    try:
        run = run_cli_train("stylegan-256", sets, workdir, max_steps=10)
        with open(os.path.join(workdir, "train.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        saved = torch.load(os.path.join(
            workdir, cfg.run.checkpoint_dir, "ckpt_00000010.pt"),
            weights_only=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    recs = run["records"]
    want_res = [ph.resolution for ph in phases for _ in range(2)]
    if [r["shape"][1] for r in recs] != want_res or len(rows) != 10:
        raise AssertionError(f"ada cli: ran {[r['shape'] for r in recs]}")
    p = 0.3
    for rec, row in zip(recs, rows):
        lg = int(math.log2(rec["shape"][1]))
        want = launch_totals(step_launches(cfg.model, rec["r1"], lg, BATCH))
        if rec["counts"] != want:
            raise AssertionError(f"ada cli step {rec['step']}: launches "
                                 f"{rec['counts']}, derived {want}")
        _check_ada_metrics(f"ada cli step {rec['step']}", row, p, rate)
        p = row["aug_p"]
    if abs(float(saved["ada_p"]) - p) > 1e-7:
        raise AssertionError(f"ada cli: checkpoint ada_p {saved['ada_p']}")
    log(f"ada: cli train --set aug.mode=ada aug.categories=bcgfnu, 10 "
        f"steps 8x8 -> 32x32 at batch {BATCH}: launches as derived, aug_p "
        + " ".join(f"{r['aug_p']:.2f}" for r in rows)
        + f", checkpoint ada_p {float(saved['ada_p']):.4f}; ms a step "
        + " ".join(f"{r['ms']:.1f}" for r in recs) + f" [{card}]")


# -- 14. the projector, cli project, run.profile ---------------------------
PROJ_STEPS = 300
PROJ_RESTARTS = 8
PROJ_POOL = 64


def projector_shapes(mc, steps: int, batch: int = 1,
                     restarts: int = PROJ_RESTARTS,
                     pool: int = PROJ_POOL) -> dict:
    """kernel -> {shape: launches} of ``project`` in W+ at full resolution
    (float32): one pixelnorm over the pool's max(256, pool - 1) z rows, a
    synthesis of the pool, one of the restarts a step with its backward,
    and the final one of the restarts (each synthesis 14 AdaIN and 6
    up+blur at 256²; each backward 6 blur+down with gain 4 at the up+blur
    outputs' shapes)."""
    assert not mc.remat          # remat would recompute blocks
    assert not mc.fused_up_conv  # the composed forms launch no up+blur
    assert not mc.fold_width     # folded blocks launch neither kernel
    n = restarts * batch
    total = {"pixelnorm": {(max(256, pool - 1), mc.latent_dim): 1}}
    for served, times in ((serving_shapes(mc, batch=pool), 1),
                          (serving_shapes(mc, batch=n), steps + 1)):
        _add(total, {name: {s: c * times for s, c in by_shape.items()}
                     for name, by_shape in served.items()
                     if name != "pixelnorm"})
    _add(total, {"blur_downsample_2x": {
        (n, mc.nf(lg - 2), 2 ** lg, 2 ** lg): steps
        for lg in range(3, mc.res_log2 + 1)}})
    return total


def phase_projector(card: str) -> dict:
    """``project`` at full width (stylegan-256, float32 as the JAX package
    projects, TF32 off) in W+ at 256²: 8 restarts from a pool of 64, 300
    steps, on a target the G-EMA made (seeded live weights, as phase 5):
    ms a step (300 steps against 10, by the host clock with a synchronize),
    the loss falling, finite images of the target's shape, the launch
    counts; ``cli project`` on a PNG written here; a ``run.profile``
    trainer run whose trace names the ``ganlab::`` operators and their
    kernels."""
    from ganlab_tpu_torch.utils.image import save_image_grid
    from ganlab_tpu_torch.utils.projector import project

    cfg = get_config("stylegan-256")
    mc = cfg.model
    sampler = make_sampler(cfg)
    g = sampler.g
    nl = 2 * (mc.res_log2 - 1)
    gen = torch.Generator(device="cuda").manual_seed(41)
    with torch.no_grad():
        w = g.map_latents(torch.randn(1, mc.latent_dim, generator=gen,
                                      device="cuda"))
        target = g.synthesize(w[:, None].repeat(1, nl, 1), mc.res_log2, 1.0,
                              generator=gen).float()
    times, results = {}, {}
    totals = {n: 0 for n in KERNELS}
    for steps in (10, PROJ_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = project(cfg, g, sampler.w_avg, target, num_steps=steps, seed=0,
                      num_restarts=PROJ_RESTARTS, num_candidates=PROJ_POOL)
        torch.cuda.synchronize()
        times[steps] = time.perf_counter() - t0
        counts = _launch_counts()
        want = launch_totals(projector_shapes(mc, steps))
        if counts != want:
            raise AssertionError(f"projector: {steps} steps launched "
                                 f"{counts}, derived {want}")
        for n in totals:
            totals[n] += counts[n]
        results[steps] = res
    res = results[PROJ_STEPS]
    losses = res.losses.cpu().numpy()
    mse0 = float((results[10].images - target).square().mean())
    mse = float((res.images - target).square().mean())
    if res.latents.shape != (1, nl, mc.latent_dim) or \
            res.images.shape != target.shape or \
            not bool(res.images.isfinite().all()) or \
            not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"projector: latents {tuple(res.latents.shape)}"
                             f" losses {losses[0]} -> {losses[-1]}")
    ms_step = (times[PROJ_STEPS] - times[10]) / (PROJ_STEPS - 10) * 1e3
    log(f"projector: stylegan-256 W+ at 256², 8 restarts of a pool of 64, "
        f"float32: {times[PROJ_STEPS]:.2f} s for {PROJ_STEPS} steps, "
        f"{times[10]:.2f} s for 10: {ms_step:.2f} ms a step; loss "
        f"{losses[0]:.4f} -> {losses[PROJ_STEPS // 2]:.4f} -> "
        f"{losses[-1]:.4f}; image MSE to the target {mse0:.4f} after 10 "
        f"steps, {mse:.4f} after {PROJ_STEPS}; launches {totals} [{card}]")

    root = tempfile.mkdtemp(prefix="ganlab_project_")
    try:
        png = os.path.join(root, "target.png")
        save_image_grid(target.permute(0, 2, 3, 1).cpu().numpy(), png)
        out = os.path.join(root, "proj")
        t0 = time.perf_counter()
        rc = port_cli.main(["project", "--preset", "stylegan-256",
                            "--workdir", os.path.join(root, "run"),
                            "--images", png, "--steps", "50",
                            "--optimize-noise", "--out", out])
        cli_s = time.perf_counter() - t0
        names = sorted(os.listdir(out)) if rc == 0 else []
        if names != ["latents.npy", "noises.npz", "pairs.png"]:
            raise AssertionError(f"cli project: rc {rc}, wrote {names}")
        check_png(os.path.join(out, "pairs.png"), "cli project")
        lat = np.load(os.path.join(out, "latents.npy"))
        if lat.shape != (1, nl, mc.latent_dim) or not np.isfinite(lat).all():
            raise AssertionError(f"cli project: latents {lat.shape}")
        log(f"projector: cli project --optimize-noise --steps 50 on a PNG "
            f"in {cli_s:.1f} s (a fresh full-width state): {names}")
        profile_run(card, os.path.join(root, "profiled"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del sampler, results
    torch.cuda.empty_cache()
    return dict(ms_step=ms_step, launches=totals)


def profile_run(card: str, workdir: str) -> None:
    """``cli train --set run.profile=True`` at full width, batch 32, four
    steps a phase from 8x8, 21 steps: rank 0 writes the trace of steps
    10-19 at step 20 under ``<workdir>/profile``; it must name the
    ``ganlab::`` operators and hold our kernels' device events."""
    kimg = 4 * BATCH / 1000.0
    sets = {"data.dataset": "ellipses", "schedule.fade_kimg": kimg,
            "schedule.stabilize_kimg": kimg,
            "schedule.batch_schedule": {2 ** lg: BATCH for lg in range(2, 9)},
            "run.profile": True}
    run_cli_train("stylegan-256", sets, workdir, max_steps=21)
    traces = sorted(os.listdir(os.path.join(workdir, "profile")))
    if traces != ["trace_step00000020.json"]:
        raise AssertionError(f"run.profile: wrote {traces}")
    path = os.path.join(workdir, "profile", traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("name", "").startswith(
        "ganlab::")}
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ours = {k for k in kernels if any(n in k for n in PORT_KERNELS)}
    if not {"ganlab::adain", "ganlab::pixel_norm"} <= ops or not ours:
        raise AssertionError(f"run.profile: operators {sorted(ops)}, "
                             f"kernels of ours {sorted(ours)[:4]}")
    log(f"run.profile: trace of steps 10-19 (16x16 and 32x32), "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, {len(events)} events, "
        f"operators {sorted(ops)}, {len(kernels)} kernel names, "
        f"{len(ours)} of ours [{card}]")


# -- 15. the opt-in step recipes -------------------------------------------
RECIPE_ROUNDS = 3              # timed rounds in turns, after a warm-up round
PG_RECIPE_STEPS = 3            # progan-128 reg_separate steps at 128²
RECIPE_CLI_STEPS = 48          # cli train at 8x8: three 16-step cycles


def recipe_sets(recipe: str) -> dict:
    return {} if recipe == "sequential" else {f"loss.{recipe}": True}


def _d_adam_counts(state) -> set:
    return {int(s["step"]) for s in state.opt_d.state.values()}


def phase_recipes(card: str) -> dict:
    """The opt-in step recipes at the bench.py configuration (stylegan-256,
    fixed 256², batch 32, bf16, full width, seeded live weights): the
    sequential step, ``loss.reg_separate``, ``loss.fused_seq`` and
    ``loss.fused_g_step``, R1-off and R1-on, read in turns over
    ``RECIPE_ROUNDS`` rounds after a warm-up round: ms a step, the launches
    of our kernels a step equal to ``step_launches(..., recipe=)``, D's
    Adam count +2 on a ``reg_separate`` R1 step (+1 otherwise), peak
    memory of each step in the last round, one R1-off and one R1-on step
    of each profiled (device busy, idle share). Then ``recipe_checks``."""
    mc = training_config().model
    gdata = torch.Generator(device="cuda").manual_seed(41)
    real = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    runs = {}
    for recipe in RECIPES:
        cfg = training_config(**recipe_sets(recipe))
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        runs[recipe] = dict(
            state=_dp_state(cfg),
            steps={r1: train_steps.build_train_step(
                cfg, phase, penalty_override=r1) for r1 in (False, True)},
            expect={r1: launch_totals(step_launches(mc, r1, recipe=recipe))
                    for r1 in (False, True)},
            ms={False: [], True: []}, peak={})
    totals = {n: 0 for n in KERNELS}
    for rnd in range(RECIPE_ROUNDS + 1):
        for recipe, run in runs.items():
            for r1 in (False, True):
                before = _d_adam_counts(run["state"])
                if rnd == RECIPE_ROUNDS:
                    torch.cuda.reset_peak_memory_stats()
                st, m, ms, counts = _timed_step(run["steps"][r1],
                                                run["state"], real)
                if rnd == RECIPE_ROUNDS:
                    run["peak"][r1] = \
                        torch.cuda.max_memory_allocated() / 2 ** 30
                run["state"] = st
                label = f"recipe {recipe} R1-{'on' if r1 else 'off'} {rnd}"
                _check_accum_step(label, m, counts, run["expect"][r1], r1)
                adds = 2 if recipe == "reg_separate" and r1 else 1
                if _d_adam_counts(st) != {c + adds for c in before or {0}}:
                    raise AssertionError(f"{label}: D's Adam counts "
                                         f"{before} -> {_d_adam_counts(st)}")
                for n in totals:
                    totals[n] += counts[n]
                if rnd:
                    run["ms"][r1].append(ms)
                log(f"recipe: {recipe:12s} R1-{'on ' if r1 else 'off'} round "
                    f"{rnd}: {ms:8.2f} ms, launches {counts}, "
                    + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
    out = {}
    for recipe, run in runs.items():
        row = out[recipe] = {
            "ms_r1_off": statistics.median(run["ms"][False]),
            "ms_r1_on": statistics.median(run["ms"][True]),
            "peak_gib": run["peak"], "launches": run["expect"]}
        for r1 in (False, True):
            def one(run=run, r1=r1):
                run["state"] = run["steps"][r1](run["state"], real)[0]

            prof = profile_call(f"one {recipe} R1-{'on' if r1 else 'off'} "
                                f"step", one, card, top=8)
            row["busy_ms_r1_on" if r1 else "busy_ms_r1_off"] = \
                prof["busy_ms"]
            row["idle_r1_on" if r1 else "idle_r1_off"] = prof["idle_share"]
        log(f"recipe: {recipe:12s}: {row['ms_r1_off']:.2f} ms an R1-off "
            f"step, {row['ms_r1_on']:.2f} ms an R1-on step (medians of "
            f"{RECIPE_ROUNDS}, in turns); device busy "
            f"{row['busy_ms_r1_off']:.2f} / {row['busy_ms_r1_on']:.2f} ms, "
            f"idle share {row['idle_r1_off']:.3f} / {row['idle_r1_on']:.3f}; "
            f"peak memory {row['peak_gib'][False]:.2f} / "
            f"{row['peak_gib'][True]:.2f} GiB (four full-width states "
            f"held); launches a step {row['launches'][False]} / "
            f"{row['launches'][True]} [{card}]")
    seq = out["sequential"]
    for recipe in RECIPES[1:]:
        r = out[recipe]
        log(f"recipe: {recipe} against sequential: R1-off "
            f"{r['ms_r1_off'] - seq['ms_r1_off']:+.2f} ms "
            f"({r['ms_r1_off'] / seq['ms_r1_off'] - 1:+.3f}), R1-on "
            f"{r['ms_r1_on'] - seq['ms_r1_on']:+.2f} ms "
            f"({r['ms_r1_on'] / seq['ms_r1_on'] - 1:+.3f}); busy "
            f"{r['busy_ms_r1_off'] - seq['busy_ms_r1_off']:+.2f} / "
            f"{r['busy_ms_r1_on'] - seq['busy_ms_r1_on']:+.2f} ms; peak "
            f"{r['peak_gib'][False] - seq['peak_gib'][False]:+.2f} / "
            f"{r['peak_gib'][True] - seq['peak_gib'][True]:+.2f} GiB "
            f"[{card}]")
    runs.clear()
    torch.cuda.empty_cache()
    for recipe in RECIPES[1:]:
        for preset, rtol in (("stylegan-256", STEP_GRAD_RTOL),
                             ("stylegan2-256", 1e-3)):
            phase_train_card_vs_cpu(preset, rtol, recipe_sets(recipe))
    extra = recipe_checks(card)
    for n in totals:
        totals[n] += extra[n]
    return dict(out, launches=totals)


def recipe_checks(card: str) -> dict:
    """``reg_separate`` on progan-128 (WGAN-GP and drift every step: two D
    updates a step, the NCHW pixelnorm launched), ``fused_seq`` against
    the sequential step at 1024² (stylegan-1024, remat, batch 4, R1 on:
    peak memory), ``recipe_cli`` (graphed off-runs), and two gloo
    ranks under ``fused_seq`` against one process accumulating two
    (``phase_dp``). Returns the launches of our kernels in all."""
    totals = {n: 0 for n in KERNELS}

    def count(counts):
        for n in totals:
            totals[n] += counts[n]

    # progan-128 at 128², WGAN-GP every step: each step two D updates
    cfg = get_config("progan-128", **{
        "schedule.progressive": False, "schedule.batch_schedule": {128: 8},
        "loss.reg_separate": True})
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    state = _dp_state(cfg)
    stepper = make_lazy_stepper(cfg, phase)
    gdata = torch.Generator(device="cuda").manual_seed(42)
    real = torch.randint(0, 256, (8, 128, 128, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    expect = launch_totals(step_launches(cfg.model, True, batch=8,
                                         recipe="reg_separate"))
    pg_ms = []
    for i in range(PG_RECIPE_STEPS):
        state, m, ms, counts = _timed_step(stepper, state, real)
        _check_accum_step(f"progan reg_separate step {i}", m, counts, expect,
                          True)
        if _d_adam_counts(state) != {2 * (i + 1)} or \
                counts["pixelnorm_nchw"] == 0:
            raise AssertionError(f"progan reg_separate step {i}: D's Adam "
                                 f"counts {_d_adam_counts(state)}, launches "
                                 f"{counts}")
        count(counts)
        pg_ms.append(ms)
    log(f"recipe: progan-128 reg_separate at 128² batch 8, {PG_RECIPE_STEPS} "
        f"steps: every D parameter's Adam count {_d_adam_counts(state)} "
        f"(two updates a step), launches a step {counts} as derived, penalty "
        f"{m['penalty']:.4f}, ms {[round(x, 2) for x in pg_ms]} [{card}]")
    del state
    torch.cuda.empty_cache()

    # fused_seq at 1024²: the shared graph lives through R1's backward
    peaks, ms_1k = {}, {}
    cfg = get_config("stylegan-1024")
    phase = build_phases(cfg.schedule, cfg.model)[-1]
    micro = phase.batch_size
    assert cfg.model.remat and phase.resolution == 1024 and micro == 4
    state = create_train_state(cfg, seed=0)
    state.shown_imgs = phase.start_img
    gdata = torch.Generator(device="cuda").manual_seed(43)
    real = torch.randint(0, 256, (micro, 1024, 1024, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    for recipe in ("sequential", "fused_seq", "fused_seq", "sequential"):
        c = get_config("stylegan-1024", **recipe_sets(recipe))
        step = train_steps.build_train_step(c, phase, penalty_override=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m, ms, counts = _timed_step(step, state, real)
        _check_accum_step(f"1024 {recipe}", m, counts, launch_totals(
            step_launches(c.model, True, batch=micro, recipe=recipe)), True)
        peaks[recipe] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms_1k.setdefault(recipe, []).append(ms)
        count(counts)
    log(f"recipe: stylegan-1024 R1-on step at 1024² (remat, batch {micro}): "
        f"peak memory sequential {peaks['sequential']:.2f} GiB, fused_seq "
        f"{peaks['fused_seq']:.2f} GiB; ms {ms_1k} (first of each warms "
        f"up); launches as derived [{card}]")
    del state
    torch.cuda.empty_cache()

    count(recipe_cli(card))
    dp = phase_dp(card, recipe_sets("fused_seq"), "dp fused_seq")
    count(dp["launches"])
    return totals


def recipe_cli(card: str) -> dict:
    """``cli train --set loss.<recipe>=true`` for each recipe, chunked
    (the default): three cycles at 8x8 (eager, captured, replayed), then
    two single steps at 16x16 fade; each call's launches as derived, the
    rows at the JAX rule's steps. Returns the launches of our kernels."""
    totals = {n: 0 for n in KERNELS}
    for recipe in RECIPES[1:]:
        sets = {"data.dataset": "ellipses",
                "schedule.stabilize_kimg": RECIPE_CLI_STEPS * BATCH / 1000.0,
                "schedule.fade_kimg": 2 * BATCH / 1000.0,
                "schedule.batch_schedule": {2 ** lg: BATCH
                                            for lg in range(2, 9)},
                "run.log_every": 1, **recipe_sets(recipe)}
        cfg = get_config("stylegan-256", **sets)
        phases = build_phases(cfg.schedule, cfg.model)[:2]
        max_steps = RECIPE_CLI_STEPS + 2
        workdir = tempfile.mkdtemp(prefix=f"ganlab_{recipe}_")
        try:
            run = run_cli_train("stylegan-256", sets, workdir,
                                max_steps=max_steps, chunked=True)
            with open(os.path.join(workdir, "train.jsonl")) as f:
                rows = [json.loads(line) for line in f]
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        recs = run["records"]
        want_rows = chunked_row_steps(phases, CHUNK, 1, max_steps)
        if [r["step"] for r in rows] != want_rows or \
                sum(r["n"] for r in recs) != max_steps or \
                max(r["graphs"] for r in recs) != 1 or not all(
                    math.isfinite(v) for r in rows for k, v in r.items()
                    if isinstance(v, float)):
            raise AssertionError(
                f"{recipe} cli: rows at {[r['step'] for r in rows]} (the "
                f"JAX rule's {want_rows}), calls "
                f"{[(r['n'], r['graphs']) for r in recs]}: {rows[-1:]}")
        _add_counts(totals, chunk_launches(f"{recipe} cli", cfg, recs,
                                           recipe))
        log(f"recipe: cli train --set loss.{recipe}=true (run.chunk_steps "
            f"default), {max_steps} steps 8x8 -> 16x16 fade at batch "
            f"{BATCH} in {len(recs)} calls (consumed "
            f"{[r['n'] for r in recs]}; the 8x8 off-run captured once and "
            f"replayed): exit 0, train.jsonl rows at the JAX rule's steps "
            f"and finite, launches as derived, alpha "
            f"{[r['alpha'] for r in rows]}, ms a call "
            + " ".join(f"{r['ms']:.1f}" for r in recs) + f" [{card}]")
    return totals


# -- 16. chunked stepping: the off-run as a CUDA graph -----------------------
CHUNK = 16                     # loss.penalty_every of both presets
CHUNK_TAIL = 2                 # a partial cycle after the last full one
CHUNK_PHASE_STEPS = 56         # cli train: 3 cycles and 8 steps a phase


def _device_stack(n: int, batch: int, res: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (n, batch, res, res, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)


def _pool_bytes(pool) -> int:
    """Bytes of the segments that a CUDA graph pool holds."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def chunk_pair(label: str, cfg, phase, card: str, timed: bool) -> dict:
    """``make_lazy_stepper`` and ``make_chunked_stepper`` from one seed over
    the same cycles and a tail of ``CHUNK_TAIL`` (cycle 0 of the chunked
    side runs eagerly, cycle 1 captures and replays, the rest replay):
    the states bit for bit, the stacked metrics bit for bit, the launches
    of our kernels the same on both sides (a replay adds its captured
    launches). Where ``timed``, four cycles: cycle 2 (the graph's second
    replay) gives each side's ms a step (host clock, a synchronize at each
    end), the host's own time for the cycle (no synchronize), peak memory
    and the launches of our kernels that the cycle added to the counts,
    and the chunked side's cycle 3 runs under ``profile_call`` (device
    busy, idle share; an eager cycle's profile records ~10^5 host events,
    whose reading costs the script tens of seconds: the eager steps' idle
    shares are those of phases 6 and 7); else two cycles. The chunked
    side's capture seconds and graph pool bytes."""
    batch = phase.batch_size
    cycles = 4 if timed else 2
    n_steps = cycles * CHUNK + CHUNK_TAIL
    data = _device_stack(n_steps, batch, phase.resolution, seed=61)
    bounds = [(c * CHUNK, (c + 1) * CHUNK) for c in range(cycles)] + \
        [(cycles * CHUNK, n_steps)]
    sides = {}
    for side in ("eager", "graphed"):
        t0 = time.perf_counter()
        state = create_train_state(cfg, seed=0)
        made_s = time.perf_counter() - t0
        if side == "eager":
            lazy = make_lazy_stepper(cfg, phase)

            def run(lo, hi, state=state, lazy=lazy):
                ms = []
                for i in range(lo, hi):
                    ms.append(lazy(state, data[i])[1])
                return train_steps.stack_metrics(ms, state.device)
        else:
            stepper, k = train_steps.make_chunked_stepper(cfg, phase)
            assert k == CHUNK

            def run(lo, hi, state=state, stepper=stepper):
                m = stepper(state, data[lo:hi])[1]
                if len(m["d_loss"]) != hi - lo:
                    raise AssertionError(f"{label}: the chunked stepper "
                                         f"took {len(m['d_loss'])} of "
                                         f"{hi - lo}")
                return m
        out = sides[side] = {"state": state, "parts": [], "made_s": made_s}
        reset_counts()
        t_side = time.perf_counter()
        for c, (lo, hi) in enumerate(bounds):
            if c == 2 and timed:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = _counts()
                t0 = time.perf_counter()
                out["parts"].append(run(lo, hi))
                out["host_ms"] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                out["ms_step"] = (time.perf_counter() - t0) * 1e3 / CHUNK
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
                out["cycle_launches"] = {n: v - before[n]
                                         for n, v in _counts().items()}
            elif c == 3 and timed and side == "graphed":
                prof = profile_call(f"chunk {label}: one {side} cycle",
                                    lambda: out["parts"].append(
                                        run(lo, hi)), card, top=6)
                out["idle"], out["busy_ms"] = prof["idle_share"], \
                    prof["busy_ms"]
                out["cycle_ms"] = prof["wall_ms"]
            else:
                out["parts"].append(run(lo, hi))
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t_side
        out["counts"] = _counts()
        out["metrics"] = {key: torch.cat([p[key] for p in out["parts"]])
                          for key in out["parts"][0]}
        if side == "graphed":
            graphs = stepper.graphs
            out["capture_s"] = sum(graphs.capture_s.values())
            out["variants"] = len(graphs.capture_s)
            out["pool_bytes"] = _pool_bytes(graphs.pool)
            if not out["pool_bytes"]:
                raise AssertionError(f"{label}: the memory snapshot shows "
                                     "no segment of the graphs' pool")
            stepper.close()
    eager, graphed = sides["eager"], sides["graphed"]
    n = _assert_states_equal(f"chunk {label}", eager["state"],
                             graphed["state"])
    me, mg = eager["metrics"], graphed["metrics"]
    bad = [key for key in me if not torch.equal(me[key], mg[key])]
    if me.keys() != mg.keys() or bad:
        raise AssertionError(f"chunk {label}: stacked metrics differ: {bad}")
    if eager["counts"] != graphed["counts"] or not any(
            graphed["counts"].values()):
        raise AssertionError(f"chunk {label}: launches eager "
                             f"{eager['counts']}, graphed "
                             f"{graphed['counts']}")
    if not all(torch.isfinite(v).all() for v in mg.values()):
        raise AssertionError(f"chunk {label}: non-finite metrics")
    speed = ""
    if timed:
        speed = (
            f"; ms a step over cycle 2: eager {eager['ms_step']:.3f}, "
            f"graphed {graphed['ms_step']:.3f} "
            f"({eager['ms_step'] / graphed['ms_step']:.2f}x); the host's "
            f"time for that cycle {eager['host_ms']:.2f} / "
            f"{graphed['host_ms']:.2f} ms; peak memory "
            f"{eager['peak_gib']:.2f} / {graphed['peak_gib']:.2f} GiB; a "
            f"profiled graphed cycle: wall {graphed['cycle_ms']:.2f} ms, "
            f"device busy {graphed['busy_ms']:.2f} ms, idle share "
            f"{graphed['idle']:.3f}")
    log(f"chunk: {label}: {n} state leaves and {len(mg)} stacked metrics "
        f"over {n_steps} steps bit-equal, eager lazy stepper vs graphed "
        f"chunked stepper; launches of our kernels equal "
        f"({graphed['counts']}); capture {graphed['capture_s']:.2f} s for "
        f"{graphed['variants']} off-run variant(s); graph pool "
        f"{graphed['pool_bytes'] / 2 ** 20:.1f} MiB{speed}; states made "
        f"in {eager['made_s']:.1f} / {graphed['made_s']:.1f} s, stepped "
        f"in {eager['run_s']:.1f} / {graphed['run_s']:.1f} s [{card}]")
    return dict(
        launches=graphed["counts"],
        **{f"{k}_{side}": sides[side][k] for side in sides
           for k in ("ms_step", "host_ms", "peak_gib", "idle", "busy_ms",
                     "cycle_launches")
           if k in sides[side]},
        capture_s=graphed["capture_s"], pool_bytes=graphed["pool_bytes"])


def chunked_row_steps(phases, k: int, every: int, max_steps: int) -> list:
    """The steps at which the JAX package's chunked trainer logs a row
    (``ganlab_tpu/train/loop.py``): a call takes n = min(k, the phase's
    steps left, max_steps left), of which the stepper runs only those up
    to the next cycle head when its counter is mid-cycle; a row where
    step // every moves over the call."""
    step, rows = 0, []
    for ph in phases:
        left = phase_steps(ph)
        while left and step < max_steps:
            n = min(k, left, max_steps - step)
            if step % k:
                n = min(n, k - step % k)
            step, left = step + n, left - n
            if step // every != (step - n) // every:
                rows.append(step)
    return rows


def chunk_cli(card: str, chunked: bool) -> dict:
    """``cli train --preset stylegan-256`` 8x8 -> 32x32 (stabilize, fade,
    stabilize, fade, stabilize) at the preset's batch of 16, the preset's
    ``synthetic`` data and its ``run.chunk_steps`` (True), or with
    ``run.chunk_steps=False``. Phases of ``CHUNK_PHASE_STEPS`` steps:
    phases 1 and 3 start 8 steps into a cycle (8 steps to realign), then
    each runs three cycles (eager, captured, replayed) and, where it
    started on a cycle head, a tail of 8. Chunked: each call of the
    stepper counted (our kernels' launches against those derived for its
    steps), a graph captured in each phase (alpha a graph input in the
    fades), the rows of ``train.jsonl`` at the JAX rule's steps. Returns the loop's img/s a phase (the trainer's own line) and
    the launches."""
    cfg0 = get_config("stylegan-256")
    batch = cfg0.schedule.batch_for(32)
    kimg = CHUNK_PHASE_STEPS * batch / 1000.0
    sets = {"schedule.fade_kimg": kimg, "schedule.stabilize_kimg": kimg,
            "run.log_every": 100, "run.checkpoint_every": 10 ** 6,
            "run.sample_every": 0}
    cfg = get_config("stylegan-256", **sets,
                     **({} if chunked else {"run.chunk_steps": False}))
    phases = build_phases(cfg.schedule, cfg.model)[:5]
    max_steps = sum(phase_steps(ph) for ph in phases)
    assert cfg.chunking == chunked and cfg.data.dataset == "synthetic" \
        and all(ph.batch_size == batch for ph in phases)
    workdir = tempfile.mkdtemp(prefix="ganlab_chunk_cli_")
    try:
        run = run_cli_train("stylegan-256", sets, workdir, max_steps,
                            chunked=chunked)
        with open(os.path.join(workdir, "train.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    img_s = {}
    for line in run["text"].splitlines():
        if " img/s over " in line and line.startswith("phase "):
            img_s[int(line.split()[1])] = float(
                line.split("): ")[1].split()[0])
    launches = {n: 0 for n in KERNELS}
    recs = run["records"]
    if chunked:
        want_rows = chunked_row_steps(phases, CHUNK, 100, max_steps)
        if [r["step"] for r in rows] != want_rows:
            raise AssertionError(f"chunk cli: rows at "
                                 f"{[r['step'] for r in rows]}, the JAX "
                                 f"rule's {want_rows}")
        if sum(c["n"] for c in recs) != max_steps or any(
                max(c["graphs"] for c in recs if c["phase"] == ph.index)
                != 1 for ph in phases):
            raise AssertionError(
                "chunk cli: the calls took "
                f"{[(c['phase'], c['n'], c['graphs']) for c in recs]}")
        launches = chunk_launches("chunk cli", cfg, recs)
        log(f"chunk: cli train (run.chunk_steps default) {max_steps} steps "
            f"in {len(recs)} calls of the chunked stepper (consumed "
            f"{[c['n'] for c in recs]}), one graph captured a phase: "
            f"every call's launches as derived for its steps; train.jsonl "
            f"rows at steps {want_rows} (log_every 100, the JAX package's "
            f"chunk rule)")
    elif [r["step"] for r in rows] != list(range(100, max_steps + 1, 100)):
        raise AssertionError(f"chunk cli: unchunked rows "
                             f"{[r['step'] for r in rows]}")
    for r in rows:
        ph = next(p for p in phases if p.start_img < r["shown_imgs"]
                  <= p.end_img)
        if (r["res"], r["kind"]) != (ph.resolution, ph.kind) or \
                r["shown_imgs"] != r["step"] * batch or \
                not math.isfinite(r["d_loss"]):
            raise AssertionError(f"chunk cli: row {r}")
    if sorted(img_s) != [ph.index for ph in phases]:
        raise AssertionError(f"chunk cli: img/s lines {img_s}")
    return dict(img_s=img_s, wall_s=run["wall_s"], launches=launches,
                phases=[(ph.resolution, ph.kind) for ph in phases])


def capture_failure_raises(card: str) -> None:
    """An off-step that reads a loss on the host cannot be captured: the
    chunked stepper raises at its first graphed cycle, and runs nothing
    eagerly in its place."""
    cfg = get_config("stylegan-256", **{
        "schedule.batch_schedule": {2 ** lg: BATCH for lg in range(2, 9)}})
    phase = build_phases(cfg.schedule, cfg.model)[0]
    build = train_steps.build_train_step

    def host_reading(*a, **k):
        fn = build(*a, **k)

        def step(*args, **kw):
            state, m = fn(*args, **kw)
            float(m["d_loss"])
            return state, m

        step.__dict__.update(fn.__dict__)
        return step

    train_steps.build_train_step = host_reading
    try:
        stepper, _ = train_steps.make_chunked_stepper(cfg, phase)
        state = create_train_state(cfg, seed=0)
        data = _device_stack(2 * CHUNK, BATCH, phase.resolution, seed=62)
        stepper(state, data[:CHUNK])
        step0 = state.step
        try:
            stepper(state, data[CHUNK:])
        except RuntimeError as e:
            log(f"chunk: a step that reads the host raised at capture, as "
                f"it must: {str(e).splitlines()[0][:120]} (the counter "
                f"stays at {state.step} after the head step {step0}) "
                f"[{card}]")
        else:
            raise AssertionError("chunk: a host-reading step was captured")
    finally:
        train_steps.build_train_step = build
        torch.cuda.synchronize()


def adam_capturable_drift(card: str) -> dict:
    """How far capturable Adam (the bias corrections in float32 on the
    card, what a graphed off-run needs) moves an update from the default
    Adam's (Python doubles): D's parameters of the bench configuration,
    one update from the same random moments and gradients at D's learning
    rate, at Adam counts 1, 16, 10^3 and 10^5; the largest |difference| of
    the updated parameters in units of lr."""
    cfg = training_config()
    hp = optimizer_hparams(cfg)[1]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        shapes = [p.shape for p in
                  port_models.build_models(cfg.model)[1].parameters()]
    gen = torch.Generator(device="cuda").manual_seed(71)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {}
    for count in (1, 16, 10 ** 3, 10 ** 5):
        params = [rand(sh) for sh in shapes]
        grads = [rand(sh) for sh in shapes]
        moments = [(rand(sh) * 1e-2, rand(sh).square() * 1e-4)
                   for sh in shapes]
        updated = []
        for capturable in (True, False):
            ps = [torch.nn.Parameter(p.clone()) for p in params]
            opt = torch.optim.Adam(ps, capturable=capturable, **hp)
            for p, g, (m, v) in zip(ps, grads, moments):
                p.grad = g.clone()
                opt.state[p] = {
                    "step": torch.tensor(float(count - 1), device="cuda"
                                         if capturable else "cpu"),
                    "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
            opt.step()
            updated.append(ps)
        with torch.no_grad():
            out[count] = max(float((a - b).abs().max())
                             for a, b in zip(*updated)) / hp["lr"]
    log(f"chunk: capturable Adam against the default on D's "
        f"{sum(math.prod(sh) for sh in shapes)} parameters (bench config, "
        f"lr {hp['lr']:.6g}): largest |difference| of one update, in units "
        f"of lr, at counts "
        + ", ".join(f"{c}: {d:.3g}" for c, d in out.items()) + f" [{card}]")
    return out


def phase_chunked(card: str) -> dict:
    """Chunked stepping with the off-run as a CUDA graph, at full width,
    bf16, deterministic cuDNN: ``chunk_pair`` at the bench.py configuration
    (stylegan-256, fixed 256², batch 32, R1 every 16; a replayed cycle's
    launches of our kernels against those derived for a cycle), at the
    progressive preset's 8x8 and 64x64 stabilize phases at batch 32 (the
    host-bound ones), on stylegan2-256 (batch 8, R1 every 16, path length
    every 4: four 3-step segments a cycle), under ``aug.mode=ada`` with
    ``bcgfnu`` (``ada_p`` chained through the replays) and under
    ``loss.fused_g_step`` at the bench configuration; ``cli train``
    chunked (the default) and unchunked through 8x8 -> 32x32 (img/s a
    phase by the loop's clock), a capture that fails, and capturable Adam
    against the default one."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.perf_counter()
    totals = {n: 0 for n in KERNELS}
    out, spent = {}, {}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out[name] = fn(*args, **kw)
        spent[name] = time.perf_counter() - t0
        return out[name]

    try:
        cfg = training_config()
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        bench = part("bench", chunk_pair, "stylegan-256 256x256 batch 32",
                     cfg, phase, card, timed=True)
        want = launch_totals(step_launches(cfg.model, True))
        for n, v in launch_totals(step_launches(cfg.model, False)).items():
            want[n] += (CHUNK - 1) * v
        if bench["cycle_launches_graphed"] != want or \
                bench["cycle_launches_eager"] != want:
            raise AssertionError(
                f"chunk: a cycle's launches at the bench configuration: "
                f"graphed {bench['cycle_launches_graphed']}, eager "
                f"{bench['cycle_launches_eager']}, derived {want}")
        log(f"chunk: launches of our kernels in cycle 2 of the bench "
            f"configuration (an R1 head and one replay of 15 off-steps), "
            f"as read from the counts: {bench['cycle_launches_graphed']}, "
            f"as derived and as the eager cycle's [{card}]")
        prog = get_config("stylegan-256", **{
            "schedule.batch_schedule": {2 ** lg: BATCH
                                        for lg in range(2, 9)}})
        phases = build_phases(prog.schedule, prog.model)
        for index in (0, 6):
            ph = phases[index]
            part(ph.resolution, chunk_pair,
                 f"stylegan-256 phase {index} ({ph.resolution}x"
                 f"{ph.resolution} {ph.kind}) batch {BATCH}", prog, ph, card,
                 timed=True)
        sg2 = get_config("stylegan2-256")
        part("pl", chunk_pair,
             f"stylegan2-256 256x256 batch {SG2_BATCH} (PL segments)", sg2,
             build_phases(sg2.schedule, sg2.model)[-1], card, timed=False)
        for name, sets, label in (
                ("ada", AUG_MODES["bcgfnu"], "ADA bcgfnu"),
                ("fused_g_step", recipe_sets("fused_g_step"),
                 "loss.fused_g_step")):
            c = training_config(**sets)
            part(name, chunk_pair, f"stylegan-256 256x256 batch 32 {label}",
                 c, build_phases(c.schedule, c.model)[-1], card, timed=False)
        for r in list(out.values()):
            _add_counts(totals, r["launches"])
        torch.cuda.empty_cache()
        cli = {mode: part(f"cli_{mode}", chunk_cli, card, mode)
               for mode in (True, False)}
        _add_counts(totals, cli[True]["launches"])
        for index, (res, kind) in enumerate(cli[True]["phases"]):
            on, off = cli[True]["img_s"][index], cli[False]["img_s"][index]
            log(f"chunk: cli train phase {index} {res}x{res} {kind}: "
                f"{on:.1f} img/s chunked (graphs) against {off:.1f} "
                f"unchunked ({on / off:.2f}x), by the loop's clock "
                f"[{card}]")
        log(f"chunk: cli train wall {cli[True]['wall_s']:.1f} s chunked, "
            f"{cli[False]['wall_s']:.1f} s unchunked [{card}]")
        part("capture_failure", capture_failure_raises, card)
        part("adam", adam_capturable_drift, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"chunk: phase 16 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f" [{card}]")
    return dict(out, launches=totals)


# -- 17. the composed upsample + conv (model.fused_up_conv) -------------------
FUSED_FORMS = {"two_op": False, "dilated": True, "poly": "poly",
               "hybrid": "hybrid"}
FUSED_ROUNDS = 2               # timed rounds in turns, after a warm-up round
FUSED_RTOL = 1e-4              # a form vs the two-op form, f32, of the scale
FUSED_1K_STEPS = 3             # R1-off steps at 1024², the first a warm-up
PG_FUSED_STEPS = 3             # progan-128 steps at 128² a form and round


def _form_sets(form: str) -> dict:
    return {"model.fused_up_conv": FUSED_FORMS[form]}


def fused_op_shapes() -> list:
    """(label, taps, x shape, out channels) of the first conv of every G
    block: stylegan-256 at batch 32, stylegan-1024's 512² and 1024² blocks
    at its batch of 4, progan-128 at batch 8 (nearest taps)."""
    out = []
    for preset, lgs, batch, taps in (
            ("stylegan-256", range(3, 9), BATCH, BLUR_TAPS),
            ("stylegan-1024", (9, 10), 4, BLUR_TAPS),
            ("progan-128", range(3, 8), 8, None)):
        mc = get_config(preset).model
        for lg in lgs:
            out.append((f"{preset} block {2 ** lg}", taps,
                        (batch, mc.nf(lg - 2), 2 ** (lg - 1), 2 ** (lg - 1)),
                        mc.nf(lg - 1)))
    return out


def fused_op_checks() -> dict:
    """Each form of ``up2_conv2d`` at every G block's shape against the
    two-op form on the card (the up+blur kernel or the nearest upsample,
    then ``F.conv2d``), float32 with TF32 off: values within ``FUSED_RTOL``
    of the reference's largest; the hybrid's gradients against autograd
    through the two-op form (``GRAD_RTOL``). Returns the worst value error
    of each form."""
    g = torch.Generator(device="cuda").manual_seed(17)
    worst = {}
    for label, taps, shape, out_ch in fused_op_shapes():
        x = torch.randn(shape, generator=g, device="cuda")
        w = torch.randn((out_ch, shape[1], 3, 3), generator=g,
                        device="cuda") / math.sqrt(9 * shape[1])
        up = port_ops.upsample_nearest_2x if taps is None else \
            port_ops.upsample_blur_2x
        with torch.no_grad():
            ref = F.conv2d(up(x), w, padding=1)
            scale = ref.abs().max().item()
            errs = {}
            for form in ("dilated", "poly") + (("hybrid",) if taps else ()):
                got = port_ops.up2_conv2d_hybrid(x, w) if form == "hybrid" \
                    else port_ops.up2_conv2d(x, w, taps, form == "poly")
                errs[form] = (got - ref).abs().max().item() / scale
                del got
        log(f"fused: {label} {shape} -> {out_ch}: value error of the scale "
            + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
            + f" (tol {FUSED_RTOL:g})")
        for form, e in errs.items():
            worst[form] = max(worst.get(form, 0.0), e)
            if not e <= FUSED_RTOL:
                raise AssertionError(f"fused: {label} {form}: {e}")
        if taps is not None:
            xg, wg = x.requires_grad_(True), w.requires_grad_(True)
            ct = torch.randn(ref.shape, generator=g, device="cuda")
            del ref
            got = torch.autograd.grad(port_ops.up2_conv2d_hybrid(xg, wg),
                                      (xg, wg), ct)
            want = torch.autograd.grad(F.conv2d(up(xg), wg, padding=1),
                                       (xg, wg), ct)
            _assert_grads_close(f"fused hybrid {label}", got, want)
        del x, w
        torch.cuda.empty_cache()
    return worst


def bench_step_turns(card: str, label: str, variants: dict) -> dict:
    """The bench.py step (stylegan-256, fixed 256², batch 32, bf16, seeded
    live weights) under each of ``variants`` (name -> config sets), R1-off
    and R1-on, read in turns over ``FUSED_ROUNDS`` rounds after a warm-up:
    ms a step, the launches of our kernels a step equal to the derived
    ones, peak memory in the last round (a state a variant held), one
    profiled R1-off and R1-on step of each (device busy, idle share)."""
    gdata = torch.Generator(device="cuda").manual_seed(43)
    real = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gdata,
                         device="cuda", dtype=torch.uint8)
    runs = {}
    for form, sets in variants.items():
        cfg = training_config(**sets)
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        runs[form] = dict(
            state=_dp_state(cfg),
            steps={r1: train_steps.build_train_step(
                cfg, phase, penalty_override=r1) for r1 in (False, True)},
            expect={r1: launch_totals(step_launches(cfg.model, r1))
                    for r1 in (False, True)},
            ms={False: [], True: []}, peak={})
    totals = {n: 0 for n in KERNELS}
    for rnd in range(FUSED_ROUNDS + 1):
        for form, run in runs.items():
            for r1 in (False, True):
                if rnd == FUSED_ROUNDS:
                    torch.cuda.reset_peak_memory_stats()
                st, m, ms, counts = _timed_step(run["steps"][r1],
                                                run["state"], real)
                if rnd == FUSED_ROUNDS:
                    run["peak"][r1] = \
                        torch.cuda.max_memory_allocated() / 2 ** 30
                run["state"] = st
                _check_accum_step(f"{label} {form} R1-{'on' if r1 else 'off'} "
                                  f"{rnd}", m, counts, run["expect"][r1], r1)
                _add_counts(totals, counts)
                if rnd:
                    run["ms"][r1].append(ms)
    out = {}
    for form, run in runs.items():
        row = out[form] = {
            "ms_r1_off": statistics.median(run["ms"][False]),
            "ms_r1_on": statistics.median(run["ms"][True]),
            "peak_gib": run["peak"], "launches": run["expect"]}
        for r1 in (False, True):
            def one(run=run, r1=r1):
                run["state"] = run["steps"][r1](run["state"], real)[0]

            prof = profile_call(f"one {form} R1-{'on' if r1 else 'off'} "
                                f"step", one, card, top=6)
            key = "r1_on" if r1 else "r1_off"
            row[f"busy_ms_{key}"], row[f"idle_{key}"] = \
                prof["busy_ms"], prof["idle_share"]
        log(f"{label}: bench step {form:7s}: {row['ms_r1_off']:.2f} ms an "
            f"R1-off step, {row['ms_r1_on']:.2f} ms an R1-on step (medians "
            f"of {FUSED_ROUNDS}, in turns); device busy "
            f"{row['busy_ms_r1_off']:.2f} / {row['busy_ms_r1_on']:.2f} ms, "
            f"idle share {row['idle_r1_off']:.3f} / {row['idle_r1_on']:.3f}; "
            f"peak memory {row['peak_gib'][False]:.2f} / "
            f"{row['peak_gib'][True]:.2f} GiB ({len(variants)} states held); "
            f"launches a step {row['launches'][False]} / "
            f"{row['launches'][True]} [{card}]")
    runs.clear()
    torch.cuda.empty_cache()
    return dict(out, launches=totals)


def served_images(card: str, label: str, variants: dict,
                  f32_rtol: float | None = None) -> dict:
    """``BatchSampler`` of stylegan-256 at batch 32 under each of
    ``variants`` (name -> config sets; one set of seeded weights, as phase
    5's): img/s and batch latency, each variant's launches over those 17
    batches as derived; then 32 images of each variant in bf16 against the
    float32 images of the first variant on the same z and noise maps (TF32
    off): the largest and the mean error no more than twice the first
    variant's own bf16 images' (ROADMAP C, precision). With ``f32_rtol``,
    each variant's float32 images also within ``f32_rtol`` of the scale of
    the first's."""
    samplers = {f: make_sampler(get_config("stylegan-256", **sets))
                for f, sets in variants.items()}
    first = next(iter(variants))
    two = samplers[first]
    lg, mc = two.res_log2, two.g.cfg
    gz = torch.Generator(device="cuda").manual_seed(19)
    z = torch.randn(BATCH, mc.latent_dim, generator=gz, device="cuda")
    noises = [torch.randn(BATCH, 1, h, w, generator=gz, device="cuda")
              for h, w in port_models.noise_shapes(mc, lg)]
    s32 = build_sample_fn(get_config("stylegan-256", **{
        "run.compute_dtype": "float32"}), lg)
    sbf = build_sample_fn(get_config("stylegan-256"), lg)
    errs, f32_errs = {}, {}
    with torch.inference_mode():
        want = s32(two.g, two.w_avg, z, None, 0.7, 1.0, noises)
        scale = want.abs().max().item()
        for form, s in samplers.items():
            d = (sbf(s.g, s.w_avg, z, None, 0.7, 1.0, noises) - want).abs()
            errs[form] = (d.max().item(), d.mean().item())
            if f32_rtol is not None:
                f32_errs[form] = (s32(s.g, s.w_avg, z, None, 0.7, 1.0, noises)
                                  - want).abs().max().item() / scale
    totals = {n: 0 for n in KERNELS}
    out = {}
    for form, s in samplers.items():
        s.warmup()
        reset_counts()
        perf = serving_speed(s)
        counts = _launch_counts()
        _add_counts(totals, counts)
        want_counts = {n: 16 * v for n, v in
                       launch_totals(serving_shapes(s.g.cfg)).items()}
        if {n: counts[n] for n in want_counts} != want_counts:
            raise AssertionError(f"{label}: served {form}: launches "
                                 f"{counts}, derived {want_counts} for 16 "
                                 f"batches")
        out[form] = dict(perf, max_err=errs[form][0], mean_err=errs[form][1],
                         f32_err=f32_errs.get(form))
        log(f"{label}: served {form:7s}: {perf['img_per_s']:.1f} img/s, "
            f"batch latency median {perf['batch_ms_median']:.2f} ms max "
            f"{perf['batch_ms_max']:.2f} ms; bf16 image vs the f32 {first} "
            f"image: max {errs[form][0]:.4e} mean {errs[form][1]:.4e}"
            + (f"; f32 image vs the f32 {first} image: "
               f"{f32_errs[form]:.3e} of the scale (tol {f32_rtol:g})"
               if f32_rtol is not None else "")
            + f"; launches {counts} [{card}]")
    ref = errs[first]
    for form, (mx, mean) in errs.items():
        if not (mx <= 2 * ref[0] and mean <= 2 * ref[1]):
            raise AssertionError(f"{label}: bf16 {form} image error {mx} / "
                                 f"{mean} above twice the {first}'s {ref}")
        if f32_rtol is not None and not f32_errs[form] <= f32_rtol:
            raise AssertionError(f"{label}: f32 {form} image "
                                 f"{f32_errs[form]:.3e} of the scale")
    return dict(out, launches=totals)


def fused_1024(card: str) -> dict:
    """stylegan-1024 at 1024² and its batch of 4, remat off and on, two-op
    and dilated: peak memory above what was held before the state, over
    ``FUSED_1K_STEPS`` R1-off steps, and their ms (the first a warm-up);
    each step's launches of our kernels as derived."""
    out, totals = {}, {n: 0 for n in KERNELS}
    for remat in (False, True):
        for form in ("two_op", "dilated"):
            cfg = get_config("stylegan-1024", **{
                "model.remat": remat, **_form_sets(form)})
            phase = build_phases(cfg.schedule, cfg.model)[-1]
            b = phase.batch_size
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated() / 2 ** 30
            state = create_train_state(cfg, seed=0)
            step = train_steps.build_train_step(cfg, phase,
                                                penalty_override=False)
            real = _device_stack(1, b, 1024, seed=13)[0]
            expect = launch_totals(step_launches(cfg.model, False, batch=b))
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for i in range(FUSED_1K_STEPS):
                state, m, t, counts = _timed_step(step, state, real)
                _check_accum_step(f"fused 1024² {form} remat {remat} {i}",
                                  m, counts, expect, False)
                _add_counts(totals, counts)
                ms.append(t)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 - base
            out[(form, remat)] = dict(peak_gib=peak,
                                      ms=statistics.median(ms[1:]))
            log(f"fused: stylegan-1024 1024² batch {b} {form} remat "
                f"{remat}: R1-off {statistics.median(ms[1:]):.1f} ms "
                f"(median of {FUSED_1K_STEPS - 1}; {ms[0]:.1f} first), peak "
                f"{peak:.3f} GiB above the {base:.2f} GiB held before; "
                f"launches {expect} a step [{card}]")
            del state, step, real
    for remat in (False, True):
        two, dil = out[("two_op", remat)], out[("dilated", remat)]
        log(f"fused: 1024² remat {remat}: dilated against two-op "
            f"{dil['peak_gib'] - two['peak_gib']:+.3f} GiB peak, "
            f"{dil['ms'] - two['ms']:+.1f} ms an R1-off step [{card}]")
    return dict(runs=out, launches=totals)


def fused_progan(card: str) -> dict:
    """progan-128 at 128² and batch 8 (WGAN-GP and drift every step), the
    two-op, dilated and poly forms in turns: ms a step (median over the
    rounds after a warm-up), launches as derived; ``'hybrid'`` raises the
    JAX package's ``ValueError`` when the G is built."""
    try:
        build_generator(get_config("progan-128", **_form_sets("hybrid"))
                        .model)
    except ValueError as e:
        log(f"fused: progan-128 under 'hybrid' raises ValueError: {e}")
    else:
        raise AssertionError("fused: progan-128 built under 'hybrid'")
    runs, totals = {}, {n: 0 for n in KERNELS}
    for form in ("two_op", "dilated", "poly"):
        cfg = get_config("progan-128", **_form_sets(form))
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        assert phase.resolution == 128, phase
        runs[form] = dict(
            state=create_train_state(cfg, seed=0),
            step=train_steps.build_train_step(cfg, phase),
            real=_device_stack(1, phase.batch_size, 128, seed=29)[0],
            expect=launch_totals(step_launches(
                cfg.model, True, phase.res_log2, phase.batch_size)),
            ms=[])
    for rnd in range(FUSED_ROUNDS + 1):
        for form, run in runs.items():
            for _ in range(PG_FUSED_STEPS):
                run["state"], m, ms, counts = _timed_step(
                    run["step"], run["state"], run["real"])
                _check_accum_step(f"fused progan {form} {rnd}", m, counts,
                                  run["expect"], True)
                _add_counts(totals, counts)
                if rnd:
                    run["ms"].append(ms)
    out = {form: statistics.median(run["ms"]) for form, run in runs.items()}
    log(f"fused: progan-128 128² batch 8 (WGAN-GP every step), ms a step "
        f"(median of {FUSED_ROUNDS * PG_FUSED_STEPS}, in turns): "
        + ", ".join(f"{f} {v:.2f}" for f, v in out.items())
        + f"; launches a step {runs['two_op']['expect']} [{card}]")
    runs.clear()
    torch.cuda.empty_cache()
    return dict(ms=out, launches=totals)


def export_check(card: str, label: str, cfg) -> dict:
    """The exported stylegan-256 sampler of ``cfg`` (cuda program, batch
    32) against ``BatchSampler`` of ``cfg`` on the same weights: the same
    bits, and the program's launches a batch as derived."""
    sampler = make_sampler(cfg)
    path = os.path.join(tempfile.mkdtemp(prefix="ganlab_export_"),
                        "sampler.ganlab.zip")
    t0 = time.perf_counter()
    try:
        export_sampler(cfg, types.SimpleNamespace(g_ema=sampler.g,
                                                  w_avg=sampler.w_avg),
                       path, batch_size=BATCH, platforms=("cuda",))
        export_s = time.perf_counter() - t0
        exported = ExportedSampler(path)
        exported.generate(1, seed=0)                    # first call
        reset_counts()
        a = exported.generate(BATCH, seed=3)
        counts = _launch_counts()
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    want = launch_totals(serving_shapes(cfg.model))
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"{label}: exported launches {counts}, derived "
                             f"{want}")
    b = sampler.generate(BATCH, seed=3)
    equal = float((a == b).mean())
    log(f"{label}: exported sampler against BatchSampler, {BATCH} images: "
        f"equal share {equal:.6f}, max level difference "
        f"{np.abs(a.astype(int) - b.astype(int)).max()}; exported in "
        f"{export_s:.1f} s; launches {counts} [{card}]")
    if not np.array_equal(a, b):
        raise AssertionError(f"{label}: the exported sampler's bits differ "
                             "from BatchSampler's")
    return dict(launches=counts, export_s=export_s)


def phase_fused(card: str) -> dict:
    """``model.fused_up_conv`` at full width: ``fused_op_checks`` (each form
    against the two-op form at every block shape, the hybrid's gradients),
    ``bench_step_turns`` (the bench.py step under each form in turns),
    ``served_images`` (served img/s and latency, the bf16 image rule), one
    graphed chunked cycle pair at 256² under the dilated form (eager lazy
    stepper against graphed chunked stepper, bit for bit, deterministic
    cuDNN), ``fused_1024`` (peak memory and ms at 1024², remat off and on),
    ``fused_progan`` and ``export_check`` under the dilated form."""
    t_phase = time.perf_counter()
    out, spent = {}, {}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out[name] = fn(*args, **kw)
        spent[name] = time.perf_counter() - t0
        return out[name]

    variants = {f: _form_sets(f) for f in FUSED_FORMS}
    part("ops", fused_op_checks)
    part("bench", bench_step_turns, card, "fused", variants)
    part("images", served_images, card, "fused", variants)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = training_config(**_form_sets("dilated"))
        part("graphs", chunk_pair, "stylegan-256 256x256 batch 32 dilated",
             cfg, build_phases(cfg.schedule, cfg.model)[-1], card,
             timed=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    part("1024", fused_1024, card)
    part("progan", fused_progan, card)
    part("export", export_check, card, "fused",
         get_config("stylegan-256", **_form_sets("dilated")))
    totals = {n: 0 for n in KERNELS}
    for name in ("bench", "images", "graphs", "1024", "progan", "export"):
        _add_counts(totals, out[name]["launches"])
    log(f"fused: phase 17 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f" [{card}]")
    return dict(out, launches=totals)


# -- 18. model.fold_width ---------------------------------------------------------
FOLD_VARIANTS = {"off": {}, "on": {"model.fold_width": True}}
FOLD_RTOL = 1e-4               # fold on vs off, f32, of the output's scale
FOLD_1K_STEPS = 3              # steps at 1024² a kind, the first a warm-up


def fold_d_scores(card: str) -> dict:
    """The stylegan-256 D (blur + downsample, full width) with fold on and
    off on the same seeded weights (every bias live) and the same 32
    images at 256²: float32 scores (TF32 off) within ``FOLD_RTOL`` of
    their scale; bf16 scores no further from the float32 fold-off scores
    than twice fold off's own bf16 scores."""
    ds = {}
    for name, sets in FOLD_VARIANTS.items():
        torch.manual_seed(0)
        ds[name] = port_models.build_models(
            get_config("stylegan-256", **sets).model)[1]
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for k, v in ds["off"].state_dict().items():
            if k.endswith(".b"):
                v += 0.2 * torch.randn(v.shape, generator=gen)
        ds["on"].load_state_dict(ds["off"].state_dict())
    for d in ds.values():
        d.to("cuda").requires_grad_(False)
    assert ds["on"].block256.fold and not ds["on"].block128.fold
    img = torch.rand(BATCH, 3, 256, 256, generator=torch.Generator(
        device="cuda").manual_seed(8), device="cuda") * 2 - 1
    with torch.inference_mode():
        want = ds["off"](img)
        scale = want.abs().max().item()
        f32 = (ds["on"](img) - want).abs().max().item() / scale
        bf = {k: (d(img.bfloat16()).float() - want).abs().max().item()
              for k, d in ds.items()}
    log(f"fold: D scores at 256², batch {BATCH}: f32 fold on vs off "
        f"{f32:.3e} of the scale (tol {FOLD_RTOL:g}); bf16 vs the f32 off "
        f"scores: off {bf['off']:.4e}, on {bf['on']:.4e} [{card}]")
    if not f32 <= FOLD_RTOL:
        raise AssertionError(f"fold: f32 D scores {f32:.3e} of the scale")
    if not bf["on"] <= 2 * bf["off"]:
        raise AssertionError(f"fold: bf16 D scores {bf}")
    return dict(f32_err=f32, bf16_err=bf)


def fold_1024(card: str) -> dict:
    """stylegan-1024 at 1024² and its batch of 4 with remat, fold off and
    on (six folded blocks: 256², 512², 1024² of G and D): ms of R1-off and
    R1-on steps (medians after a warm-up step of each), peak memory above
    what was held before the state, each step's launches as derived."""
    out, totals = {}, {n: 0 for n in KERNELS}
    for name, sets in FOLD_VARIANTS.items():
        cfg = get_config("stylegan-1024", **{"model.remat": True, **sets})
        phase = build_phases(cfg.schedule, cfg.model)[-1]
        b = phase.batch_size
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 2 ** 30
        state = create_train_state(cfg, seed=0)
        real = _device_stack(1, b, 1024, seed=13)[0]
        torch.cuda.reset_peak_memory_stats()
        row = {}
        for r1 in (False, True):
            step = train_steps.build_train_step(cfg, phase,
                                                penalty_override=r1)
            expect = launch_totals(step_launches(cfg.model, r1, batch=b))
            ms = []
            for i in range(FOLD_1K_STEPS):
                state, m, t, counts = _timed_step(step, state, real)
                _check_accum_step(f"fold 1024² {name} R1 {r1} {i}", m,
                                  counts, expect, r1)
                _add_counts(totals, counts)
                ms.append(t)
            row["ms_r1_on" if r1 else "ms_r1_off"] = statistics.median(
                ms[1:])
            row["launches_r1_on" if r1 else "launches_r1_off"] = expect
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 - base
        out[name] = row
        log(f"fold: stylegan-1024 1024² batch {b} remat, fold {name} "
            f"(folded blocks {[2 ** l for l in range(3, 11) if cfg.model.fold_block(l)]}): "
            f"R1-off {row['ms_r1_off']:.1f} ms, R1-on {row['ms_r1_on']:.1f} "
            f"ms (medians of {FOLD_1K_STEPS - 1}), peak {row['peak_gib']:.3f} "
            f"GiB above the {base:.2f} GiB held before; launches "
            f"{row['launches_r1_off']} / {row['launches_r1_on']} [{card}]")
        del state, step, real
    on, off = out["on"], out["off"]
    log(f"fold: 1024² fold on against off: {on['ms_r1_off'] - off['ms_r1_off']:+.1f} "
        f"ms R1-off, {on['ms_r1_on'] - off['ms_r1_on']:+.1f} ms R1-on, "
        f"{on['peak_gib'] - off['peak_gib']:+.3f} GiB peak [{card}]")
    return dict(runs=out, launches=totals)


def phase_fold(card: str) -> dict:
    """``model.fold_width`` at full width: the bench.py step with fold off
    and on in turns (``bench_step_turns``: ms, busy, idle, peak, launches
    as derived); ``served_images`` (img/s, latency; the float32 G images
    within ``FOLD_RTOL`` of fold off's, bf16 within twice fold off's
    error); ``fold_d_scores``; the exported folded sampler against
    ``BatchSampler``; one graphed chunked cycle pair at 256² under fold
    (bit for bit, deterministic cuDNN); ``fold_1024``; a float32 folded
    step of stylegan-256 and of progan-128 at 32² (every block folded),
    card against CPU, within the unfolded step's limits."""
    t_phase = time.perf_counter()
    out, spent = {}, {}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out[name] = fn(*args, **kw)
        spent[name] = time.perf_counter() - t0
        return out[name]

    part("bench", bench_step_turns, card, "fold", FOLD_VARIANTS)
    part("images", served_images, card, "fold", FOLD_VARIANTS,
         f32_rtol=FOLD_RTOL)
    part("d", fold_d_scores, card)
    part("export", export_check, card, "fold",
         get_config("stylegan-256", **FOLD_VARIANTS["on"]))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = training_config(**FOLD_VARIANTS["on"])
        part("graphs", chunk_pair, "stylegan-256 256x256 batch 32 folded",
             cfg, build_phases(cfg.schedule, cfg.model)[-1], card,
             timed=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    part("1024", fold_1024, card)
    part("f32", lambda: [phase_train_card_vs_cpu(p, sets=FOLD_VARIANTS["on"])
                         for p in ("stylegan-256", "progan-128")])
    totals = {n: 0 for n in KERNELS}
    for name in ("bench", "images", "export", "graphs", "1024"):
        _add_counts(totals, out[name]["launches"])
    log(f"fold: phase 18 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f" [{card}]")
    return dict(out, launches=totals)


# -- 3b. offsets beyond 2^31 elements ------------------------------------------------
LARGE = {"upsample_blur_2x": (64, 32, 512, 512),      # out: 2^31 elements
         "blur_downsample_2x": (128, 16, 1024, 1024),  # in: 2^31 elements
         "adain": (128, 16, 1024, 1024),               # in and out: 2^31
         "pixelnorm_nchw": (1024, 512, 64, 64)}        # in and out: 2^31


# each kernel's other forced paths on the same 2^31-element tensors: the
# split path for AdaIN's cluster planes, the run kernel for the NCHW tiles
LARGE_FORCED = {"adain": [dict(path="split")],
                "pixelnorm_nchw": [dict(tile=-1)]}


def kernel_path(name: str, x, out, **forced) -> str:
    if name == "adain":
        return adain_path(x, out, **forced)
    if name == "pixelnorm_nchw":
        return pixel_norm_nchw_path(x, out, **forced)
    return RESAMPLE_PATHS[name](x, out)


def check_large_offsets() -> float:
    """The kernels on tensors of 2^31 elements (a served batch of 64 at
    512x512 / 128 at 1024x1024, 1024 ProGAN maps of 512 x 64x64, bf16):
    the first and the last planes of
    the output against the plain version on those planes alone, so that
    an offset that wraps at 2^31 shows."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    with torch.inference_mode():
        for name, shape in LARGE.items():
            k = KERNELS[name]
            inp = k["inputs"](shape, torch.bfloat16, g)
            for forced in [{}] + LARGE_FORCED.get(name, []):
                out = k["kernel"](*inp, **forced)
                path = kernel_path(name, inp[0], out, **forced)
                for sl in (slice(0, 1), slice(shape[0] - 1, shape[0])):
                    part = tuple(a[sl] for a in inp)
                    worst = max(worst, _check(
                        f"{name} {shape} bf16 [{path}] image {sl.start}",
                        out[sl], k["plain"](*part), torch.bfloat16,
                        f" ({max(inp[0].numel(), out.numel())} elements)"))
                del out
            del inp
            torch.cuda.empty_cache()
    return worst


def main(kernels_only: bool = False) -> None:
    kind, card = phase_device()
    phase_build()
    mc = get_config("stylegan-256").model
    cfg1k = get_config("stylegan-1024")
    mk, b1k = cfg1k.model, cfg1k.schedule.batch_for(1024)
    mp = get_config("progan-128").model
    m2 = get_config("stylegan2-256").model
    sg2 = sg2_launch_units(m2)
    results = phase_kernels({
        **sg2,
        SERVED: serving_shapes(mc), STEP: step_launches(mc, r1=False),
        SERVED_1K: serving_shapes(mk, batch=SERVE_1K_BATCH),
        STEP_1K: step_launches(mk, r1=False, batch=b1k),
        PG_STEP_64: kernel_units(step_launches(mp, True, 6, 16)),
        PG_STEP_128: kernel_units(step_launches(mp, True, 7, 8)),
        PG_SERVED: kernel_units(progan_g_launches(mp)),
        PROJ: projector_shapes(mc, PROJ_STEPS)}, {
        # the StyleGAN2 G and every D run channels-last
        **{unit: _resample_only(v) for unit, v in sg2.items()},
        STEP: step_launches(mc, r1=False, channels_last=True),
        STEP_1K: step_launches(mk, r1=False, batch=b1k,
                               channels_last=True)})
    large_err = check_large_offsets()
    if kernels_only:
        log(f"--kernels-only: stopping after the kernel phase [{card}]")
        return
    spent = {}

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[fn.__name__] = time.perf_counter() - t0
        return out

    run(phase_gradients)
    serve_counts = run(phase_serving, card)
    train = run(phase_training, card)
    trainer = run(phase_trainer, card)
    user = run(phase_user_data, card)
    progan = run(phase_progan, card)
    sg2 = run(phase_stylegan2, card)
    accum = run(phase_accum, card)
    pl_accum = run(phase_pl_accum, card)
    dp = run(phase_dp, card)
    accum_1k = run(phase_1024_accum, card)
    exported = run(phase_export, card)
    run(phase_inception, card)
    ada = run(phase_ada, card)
    proj = run(phase_projector, card)
    recipes = run(phase_recipes, card)
    chunked = run(phase_chunked, card)
    fused = run(phase_fused, card)
    fold = run(phase_fold, card)
    log("seconds a phase: " + ", ".join(f"{name[6:]} {s:.1f}"
                                        for name, s in spent.items()))
    kernels = []
    for name, k in KERNELS.items():
        r = results[name]
        # the unit a kernel's headline numbers are summed over
        per = next(u for u in (SERVED, STEP, PG_STEP_128) if u in r)
        u = r[per]

        def of(unit, key):
            return r[unit][key] if unit in r else None

        launches = {"serving": serve_counts.get(name, 0),
                    "training": train["launches"][name],
                    "trainer": trainer["launches"][name],
                    "user_path_1024": user["launches"][name],
                    "progan": progan["launches"][name],
                    "stylegan2": sg2["launches"][name],
                    "accum": accum["launches"][name],
                    "pl_accum": pl_accum["launches"][name],
                    "dp_rank0": dp["launches"][name],
                    "accum_1024": accum_1k["launches"][name],
                    "export": exported["launches"][name],
                    "ada": ada["launches"][name],
                    "projector": proj["launches"][name],
                    "recipes": recipes["launches"][name],
                    "chunked": chunked["launches"][name],
                    "fused_up_conv": fused["launches"][name],
                    "fold_width": fold["launches"][name]}
        row = {
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(launches.values()),
            **{f"launches_{n}": v for n, v in launches.items()},
            "launches_per_step": {"r1_off": train["expect"][False][name],
                                  "r1_on": train["expect"][True][name]},
            # a replayed 16-step lazy-R1 cycle of the bench configuration
            # (the eager head step and one graph replay of 15 off-steps),
            # read from the counts; equal to the derived, or phase 16 fails
            "launches_per_cycle":
                chunked["bench"]["cycle_launches_graphed"][name],
            "launches_per_recipe_step": {
                recipe: {"r1_off": recipes[recipe]["launches"][False][name],
                         "r1_on": recipes[recipe]["launches"][True][name]}
                for recipe in RECIPES},
            "launches_per_progan128_step_128": launch_totals(
                step_launches(mp, True, 7, 8))[name],
            # the bench configuration's step under each model.fused_up_conv
            # form, read from the counts in phase 17 (equal to the derived)
            "launches_per_step_by_form": {
                form: {"r1_off": fused["bench"][form]["launches"][False][name],
                       "r1_on": fused["bench"][form]["launches"][True][name]}
                for form in FUSED_FORMS},
            # the same under model.fold_width off / on, phase 18's counts
            "launches_per_step_by_fold": {
                v: {"r1_off": fold["bench"][v]["launches"][False][name],
                    "r1_on": fold["bench"][v]["launches"][True][name]}
                for v in FOLD_VARIANTS},
            "launches_per_stylegan2_step": {
                "neither": launch_totals(stylegan2_step_launches(
                    m2, False, False, batch=SG2_BATCH,
                    pl_batch=SG2_BATCH // 2))[name],
                "pl": launch_totals(stylegan2_step_launches(
                    m2, False, True, batch=SG2_BATCH,
                    pl_batch=SG2_BATCH // 2))[name],
                "r1_pl": launch_totals(stylegan2_step_launches(
                    m2, True, True, batch=SG2_BATCH,
                    pl_batch=SG2_BATCH // 2))[name]},
            "launches_per_stylegan2_served": launch_totals(
                stylegan2_serving_launches(m2))[name],
            "fwd_route": k["route"], "bwd_route": BWD_ROUTE[name],
            "max_abs_err": max(r["max_abs_err"], large_err
                               if name in LARGE else 0.0),
            "ms": u["ms"],
            "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
            "bound_by": u["bound_by"], "library_ms": u["library_ms"],
            "ms_per": per,
            "device_ms": u["device_ms"], "host_us": u["host_us"],
            "wrapper_host_us": u["wrapper_host_us"],
            "library_device_ms": u["library_device_ms"],
            "library_host_us": u["library_host_us"]}
        for unit, suffix in ((STEP, "per_step"), (STEP_1K, "per_step_1024"),
                             (PG_STEP_64, "per_progan128_step_64"),
                             (PG_STEP_128, "per_progan128_step_128"),
                             (PG_SERVED, "per_progan128_served"),
                             (SG2_STEP, "per_stylegan2_step"),
                             (SG2_PL_STEP, "per_stylegan2_pl_step"),
                             (SG2_SERVED, "per_stylegan2_served"),
                             (PROJ, "per_projection")):
            for key in ("ms", "bound_ms", "device_ms", "plain_ms",
                        "library_ms"):
                row[f"{key}_{suffix}"] = of(unit, key)
        kernels.append(row)
    log(f"kernel times (ms, plain_ms, library_ms, device_ms, bound_ms) are "
        f"summed over the launches of one served batch of {BATCH} "
        f"(pixelnorm, AdaIN, up+blur) or one R1-off training step at batch "
        f"{BATCH} (blur+down, mbstd; *_per_step for all of them) of "
        f"stylegan-256, *_per_step_1024 over one R1-off step of "
        f"stylegan-1024 at batch {b1k} (remat), *_per_progan128_step_64 / "
        f"_128 over one progan-128 step at 64x64 (batch 16) / 128x128 "
        f"(batch 8; the headline of pixelnorm_nchw, whose library call is "
        f"F.local_response_norm with a window of 2C - 1 channels), "
        f"*_per_progan128_served over one served progan-128 batch of "
        f"{BATCH}, *_per_stylegan2_step over one stylegan2-256 step with "
        f"neither R1 nor path length at batch {SG2_BATCH}, "
        f"*_per_stylegan2_pl_step over a path-length step (PL batch "
        f"{SG2_BATCH // 2}), *_per_stylegan2_served over one served "
        f"stylegan2-256 batch of {BATCH}, bf16; *_per_projection over "
        f"one {PROJ_STEPS}-step W+ projection of stylegan-256 ("
        f"{PROJ_RESTARTS} restarts, a pool of {PROJ_POOL}), float32; "
        f"host_us is per call "
        f"through the torch.ops.ganlab operator (what the autograd "
        f"Functions call), wrapper_host_us per call of the launching "
        f"wrapper alone [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        raise SystemExit(__doc__)
    main(kernels_only=bool(sys.argv[1:]))
    sys.exit(0)

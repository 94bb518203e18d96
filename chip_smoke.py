#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA C++ kernels from ``ganlab_tpu_torch/csrc``
   with nvcc (build time and ``-Xptxas -v`` output printed).
3. Kernels: each hand-written kernel against its plain PyTorch version at
   every shape the stylegan-256 serving path gives it at batch 32, in
   float32 (TF32 off) and bfloat16; then kernel, plain and one library
   call timed with CUDA events, beside the bound (bytes / 3.35 TB/s).
4. Main path: ``BatchSampler`` at the full stylegan-256 widths (bf16,
   batch 32, seeded random weights with every term made live) serves a few
   requests; the launch counters must show 1 pixelnorm, 14 AdaIN and
   6 up+blur launches per batch; two images in float32 on the card are
   held against the same inputs on the CPU; img/s and batch latency.
5. One JSON line of per-kernel numbers, then the final ``{"ok": true, ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ganlab_tpu_torch import BatchSampler, build_generator, get_config
from ganlab_tpu_torch.models.stylegan import noise_shapes
from ganlab_tpu_torch.ops.kernels import _build
from ganlab_tpu_torch.ops.kernels.adain import adain_ref, adain_triton
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    pixel_norm_ref,
    pixel_norm_triton,
)
from ganlab_tpu_torch.ops.kernels.resample import (
    upsample_blur_2x_cuda,
    upsample_blur_2x_ref,
)
from ganlab_tpu_torch.sample import build_sample_fn

BATCH = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_RTOL = 1e-5                # kernel vs plain, float32, of the output scale
BF16_ULPS = 2                  # kernel vs plain, bf16 ulps of the output scale
IMAGE_ATOL = 2e-3              # card f32 vs CPU f32 image, on [-1, 1]


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
def cuda_time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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


def tolerance(dtype, scale: float) -> float:
    if dtype == torch.float32:
        return F32_RTOL * scale
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    return BF16_ULPS * ulp


def _bsz(dtype):
    return torch.finfo(dtype).bits // 8


def serving_shapes(mc):
    """shape -> launches per batch, for each kernel on the serving path."""
    adain = {}
    for lg in range(2, mc.res_log2 + 1):
        s = (BATCH, mc.nf(lg - 1), 2 ** lg, 2 ** lg)
        adain[s] = adain.get(s, 0) + 2
    up = {(BATCH, mc.nf(lg - 2), 2 ** (lg - 1), 2 ** (lg - 1)): 1
          for lg in range(3, mc.res_log2 + 1)}
    return {"pixelnorm": {(BATCH, mc.latent_dim): 1},
            "adain": adain, "upsample_blur_2x": up}


def _blur_filter(c, dtype):
    t = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda")
    return (torch.outer(t, t) / 16.0).to(dtype).expand(c, 1, 4, 4)


KERNELS = {
    "pixelnorm": dict(
        route="triton",
        source="ganlab_tpu_torch/ops/kernels/pixelnorm.py",
        replaces="ganlab_tpu/ops/pallas/pixelnorm.py:64",
        kernel=pixel_norm_triton,
        plain=pixel_norm_ref,
        inputs=lambda s, dt, g: (
            torch.randn(s, generator=g, device="cuda").to(dt),),
        library=(lambda x: F.rms_norm(x, (x.shape[-1],), eps=1e-8))
        if hasattr(F, "rms_norm") else None,
        nbytes=lambda s, dt: 2 * math.prod(s) * _bsz(dt),
        flops=lambda s: 4 * math.prod(s)),
    "adain": dict(
        route="triton",
        source="ganlab_tpu_torch/ops/kernels/adain.py",
        replaces="ganlab_tpu/ops/pallas/adain.py:77",
        kernel=adain_triton, plain=adain_ref,
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
}


def phase_kernels(mc) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with torch.inference_mode():
        for name, shapes in serving_shapes(mc).items():
            k = KERNELS[name]
            r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     library_ms=0.0 if k["library"] else None,
                     bound_by="bytes", bytes_ms=0.0, ops_ms=0.0)
            for shape, per_batch in shapes.items():
                for dt in (torch.float32, torch.bfloat16):
                    inp = k["inputs"](shape, dt, g)
                    t0 = time.perf_counter()
                    out = k["kernel"](*inp)
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                    ref = k["plain"](*inp)
                    err = (out.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    tol = tolerance(dt, scale)
                    ok = bool(math.isfinite(err) and err <= tol
                              and out.shape == ref.shape
                              and out.dtype == ref.dtype)
                    log(f"check {name} {shape} {str(dt)[6:]}: max_abs "
                        f"{err:.3e} max_rel {err / max(scale, 1e-30):.3e} "
                        f"tol {tol:.3e} first call {first_s:.2f} s "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} {shape} {dt}: kernel "
                                             f"disagrees with plain version")
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                inp = k["inputs"](shape, torch.bfloat16, g)
                t_k = cuda_time_ms(lambda: k["kernel"](*inp))
                t_p = cuda_time_ms(lambda: k["plain"](*inp))
                t_l = None
                if k["library"] is not None:
                    lib_out = k["library"](*inp)
                    lib_err = (lib_out.float() - k["plain"](*inp).float()) \
                        .abs().max().item()
                    t_l = cuda_time_ms(lambda: k["library"](*inp))
                b_ms = k["nbytes"](shape, torch.bfloat16) \
                    / HBM_BYTES_PER_S * 1e3
                o_ms = k["flops"](shape) / F32_FLOPS_PER_S * 1e3
                log(f"time {name} {shape} bf16 x{per_batch}/batch: kernel "
                    f"{t_k:.4f} ms  plain {t_p:.4f} ms  library "
                    f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}"
                    f"{'' if t_l is None else f' (vs plain {lib_err:.2e})'}"
                    f"  bound {max(b_ms, o_ms):.4f} ms "
                    f"({'bytes' if b_ms >= o_ms else 'operations'})")
                r["ms"] += per_batch * t_k
                r["plain_ms"] += per_batch * t_p
                r["bytes_ms"] += per_batch * b_ms
                r["ops_ms"] += per_batch * o_ms
                if r["library_ms"] is not None:
                    r["library_ms"] += per_batch * t_l
            r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] \
                else "operations"
            results[name] = r
    return results


# -- 4. main path ----------------------------------------------------------
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


def phase_main_path(card: str) -> dict:
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
    profile_batch(sampler, card)
    return counts


def profile_batch(sampler: BatchSampler, card: str, top: int = 12) -> None:
    """Where one served batch spends its time: device time by kernel name
    (torch.profiler) against the host-clock wall time of the request."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sampler.generate(BATCH, seed=500)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again
    rows = sorted(((dev_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile: one batch of {BATCH}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.3f}) [{card}]")
    for us, count, key in rows[:top]:
        log(f"profile: {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  "
            f"x{count:<4d} {key[:90]}")


def main() -> None:
    kind, card = phase_device()
    phase_build()
    cfg = get_config("stylegan-256")
    results = phase_kernels(cfg.model)
    counts = phase_main_path(card)
    kernels = []
    for name, k in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"kernel times are per served batch of {BATCH} (bf16), summed over "
        f"the launches of one batch [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)

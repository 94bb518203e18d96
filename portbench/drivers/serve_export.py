"""Serving traffic: closed-loop clients of the program's exported sampler.

Traffic parameters (``traffic/<mix>.json``): ``batch``, the exported
program's batch and every request's size; ``clients`` (1: one client that
calls ``ExportedSampler.generate(batch, seed=...)`` back to back, each
request with its own stream seed drawn from ``--seed``); ``psi`` (null:
the configuration's ``truncation_psi``, which the artifact carries as its
default); ``sample_requests``, how many of the window's requests, drawn
from the seed, are checked against the reference; ``warm_requests``.

Set-up makes the G-EMA weights and the w-average on the device from the
seed, exports the sampler at the traffic's batch for the card only
(``export_sampler``, into memory: nothing is written to disk), loads it
(``ExportedSampler``) and serves ``warm_requests`` requests. A request is
timed from the call until its uint8 (n, H, W, C) array is on the host.
"""

from __future__ import annotations

import gc
import io
import statistics
import time
import types

import numpy as np
import torch

from portbench import inputs
from portbench.reference import model as M
from portbench.reference import serve as ref_serve
from portbench.reference.compare import image_gap
from portbench.work import flops, ops


def export(h, P_g, w_avg):
    """The exported sampler of the generator ``P_g`` with ``w_avg``."""
    from ganlab_tpu_torch.export import ExportedSampler, export_sampler
    from ganlab_tpu_torch.models import build_generator

    with torch.device("meta"):
        g = build_generator(h.cfg.model)
    g = g.to_empty(device=h.device)
    g.load_state_dict(P_g, strict=True)
    g.requires_grad_(False)
    buf = io.BytesIO()
    export_sampler(h.cfg, types.SimpleNamespace(g_ema=g, w_avg=w_avg), buf,
                   batch_size=h.traffic["batch"],
                   platforms=(h.device.type,))
    del g
    buf.seek(0)
    return ExportedSampler(buf, device=h.device)


class Reservoir:
    """A uniform sample of ``size`` of the window's requests, drawn from
    the seed as they complete (reservoir sampling), plus the last one:
    the served arrays of at most ``size`` + 1 requests are held."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), inputs.REQUESTS])
        self.slots: list = []
        self.last = None

    def offer(self, index: int, out) -> None:
        self.last = (index, out)
        if len(self.slots) < self.size:
            self.slots.append((index, out))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.size:
            self.slots[j] = (index, out)

    @property
    def kept(self) -> dict:
        out = dict(self.slots)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def run(h):
    t, m, dev = h.traffic, h.model, h.device
    if t["clients"] != 1:
        raise ValueError("serve_export drives one closed-loop client")
    B = t["batch"]
    psi = t["psi"]
    P_g, _ = inputs.weights(m, h.seed, dev)
    w_avg = inputs.w_avg(m, h.seed, dev)
    sampler = export(h, P_g, w_avg)
    del P_g, w_avg

    def request(i):
        seed = inputs.request_seed(h.seed, i)
        with h.span("serve.request"):
            return sampler.generate(B, seed=seed, psi=psi)

    for i in range(t["warm_requests"]):
        request(2 ** 31 + i)
    h.sync()
    h.setup_done()
    lat = []
    keep = Reservoir(t["sample_requests"], h.seed)
    with h.window():
        t0 = time.perf_counter()
        deadline = t0 + h.seconds
        i = 0
        while True:
            a = time.perf_counter()
            out = request(i)
            b = time.perf_counter()
            lat.append(b - a)
            keep.offer(i, out)
            i += 1
            if b >= deadline:
                break
        window_s = time.perf_counter() - t0
    h.read_memory()
    total = len(lat)
    del sampler
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    images = total * B
    p95 = statistics.quantiles(lat, n=100)[94] if total >= 2 else lat[0]
    h.log(f"window: {total} requests of {B} images in {window_s:.4f} s; "
          f"latency median {statistics.median(lat) * 1e3:.3f} ms, p95 "
          f"{p95 * 1e3:.3f} ms over {total} samples")
    elem = torch.finfo(getattr(torch, h.c["run"]["compute_dtype"])).bits // 8
    least = {name: total * ops.least_seconds(m, kf["passes"], "serve", B,
                                             False, elem, h.peaks)
             if h.peaks else None
             for name, kf in h.kernel_files.items()}
    model_flops = total * flops.serve_batch_flops(m, B)

    # -- the check: sampled requests against the reference ----------------
    gap = reference_gap(h, keep.kept, psi)
    h.log(f"reference: {len(keep.kept)} requests of {B} images")
    return {"end_to_end": {"serve_img_per_s": images / window_s,
                           "serve_p95_ms": p95 * 1e3},
            "attempted": total, "failed": 0,
            "work": {"model_flops": model_flops, "conv_flops": model_flops,
                     "least_s": least, "window_s": window_s},
            "gaps": {"image_gap": gap}}


def reference_gap(h, served: dict, psi, prec=M.F32) -> float:
    """Worst image gap of the served requests ``served`` (index ->
    uint8 array) against the reference."""
    m, dev = h.model, h.device
    if not served:
        return float("inf")
    P_g, _ = inputs.weights(m, h.seed, dev)
    w_avg = inputs.w_avg(m, h.seed, dev)
    dtype = getattr(torch, h.c["run"]["compute_dtype"])
    psi = m["truncation_psi"] if psi is None else psi
    worst = 0.0
    with h.reference_precision():
        for i, got in served.items():
            seed = inputs.request_seed(h.seed, i)
            n = got.shape[0]
            z = ref_serve.latents(n, m["latent_dim"], seed).to(dev)
            noise = ref_serve.noises(m, n, seed, 0, dev, dtype)
            want = ref_serve.sample_u8(P_g, m, w_avg, z, noise, psi, prec)
            worst = max(worst, image_gap(torch.from_numpy(got).to(dev),
                                         want))
    return worst

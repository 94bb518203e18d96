"""The numbers that decide ``correct``, each a gap between the program
and the reference."""

from __future__ import annotations

import math
import statistics
import numpy as np
import torch

GRAD_FLOOR = 1e-3   # a leaf whose reference gradient is under this share
                    # of the median leaf's moves under Adam by round-off
                    # alone: it is left out of the change
SAMPLE = 4096       # elements of a leaf that the gradient and change
                    # checks read, at indices drawn from the run's seed


def sample(tensors: dict, seed: int) -> dict:
    """name -> float32 CPU vector of up to SAMPLE elements of the tensor,
    at indices that the seed and the name fix (every element of a smaller
    leaf); tensors that are None are left out."""
    out = {}
    for name, t in tensors.items():
        if t is None:
            continue
        flat = t.detach().reshape(-1)
        if flat.numel() > SAMPLE:
            key = np.random.SeedSequence([int(seed), *name.encode()])
            gen = torch.Generator().manual_seed(
                int(key.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1))
            idx = torch.randint(flat.numel(), (SAMPLE,), generator=gen)
            flat = flat[idx.to(flat.device)]
        out[name] = flat.to("cpu", torch.float32, copy=True)
    return out


def _pairs(prog: dict, ref: dict, names):
    """(prog, ref) vectors of each name; a side that lacks it reads 0."""
    for n in names:
        p, r = prog.get(n), ref.get(n)
        if p is None and r is None:
            continue
        yield (torch.zeros_like(r) if p is None else p,
               torch.zeros_like(p) if r is None else r)


def rel_err(prog: dict, ref: dict, names=None) -> float:
    """|prog - ref| / |ref| over the named vectors taken together (all
    that either side has by default): first order in the program's
    error."""
    names = set(prog) | set(ref) if names is None else names
    num = den = 0.0
    for p, r in _pairs(prog, ref, names):
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            return math.inf
        num += float((p.double() - r.double()).square().sum())
        den += float(r.double().square().sum())
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return math.sqrt(num / den)


def median_rel(prog: dict, ref: dict, names) -> float:
    """The median over the named vectors' elements of |prog - ref| /
    |ref|: an Adam step of beta1 0 moves most elements by the learning
    rate whatever their gradient's size, so the median reads the step's
    arithmetic, past the few elements whose gradient sign round-off
    decides."""
    errs = []
    for p, r in _pairs(prog, ref, names):
        if p.shape != r.shape:
            return math.inf
        d, a = (p.double() - r.double()).abs(), r.double().abs()
        errs.append(torch.where(a > 0, d / a.clamp_min(1e-300),
                                torch.where(d > 0, math.inf, 0.0)))
    if not errs:
        return 0.0
    e = torch.cat(errs)
    return math.inf if bool(e.isnan().any()) else float(e.median())


def moved(grads: dict) -> set:
    """Leaves whose reference gradient is at least GRAD_FLOOR of the
    median leaf's."""
    if not grads:
        return set()
    med = statistics.median(grads.values())
    return {n for n, v in grads.items() if v >= GRAD_FLOOR * med}


def loss_gap(prog_losses, ref_losses, floor: float = 1e-2) -> float:
    """max over steps and terms of |prog - ref| / max(|ref|, floor)."""
    worst = 0.0
    for p_row, r_row in zip(prog_losses, ref_losses, strict=True):
        for a, b in zip(p_row, r_row, strict=True):
            if not (math.isfinite(a) and math.isfinite(b)):
                return math.inf
            worst = max(worst, abs(a - b) / max(abs(b), floor))
    return worst


def score_gap(prog: list, ref: list, of=max) -> float:
    """D's scores of step 0's real and fake rows, from the initial
    weights: ``of`` (max, or statistics.median) over rows of |prog - ref|
    / the reference scores' root mean square. A row the program did not
    score is a gap without end."""
    if len(prog) != len(ref) or not ref:
        return math.inf
    rms = math.sqrt(sum(r * r for r in ref) / len(ref))
    if not all(math.isfinite(a) for a in prog):
        return math.inf
    return of(abs(a - b) for a, b in zip(prog, ref)) / max(rms, 1e-12)


def stage_gaps(prog: list, ref: list) -> dict:
    """The steps followed from a state of the program's: per step, each
    loss's |prog - ref| / max(|ref|, 1) and each batch-mean score's
    |prog - ref| / the step's larger reference score in magnitude (at
    least 1); the worst of the losses, of the scores, and of both."""
    out = {"stage_loss_err": 0.0, "stage_score_err": 0.0}
    if len(prog) != len(ref) or not ref:
        return {k: math.inf for k in (*out, "stage_err")}
    for p, r in zip(prog, ref):
        size = max(abs(r["real_score"]), abs(r["fake_score"]), 1.0)
        for key in ("d_loss", "g_loss", "real_score", "fake_score"):
            if key not in r:
                continue
            a, b = p.get(key, math.nan), r[key]
            scale = max(abs(b), 1.0) if key.endswith("loss") else size
            gap = abs(a - b) / scale \
                if math.isfinite(a) and math.isfinite(b) else math.inf
            k = "stage_loss_err" if key.endswith("loss") \
                else "stage_score_err"
            out[k] = max(out[k], gap)
    out["stage_err"] = max(out.values())
    return out


def start_gaps(prog: dict, ref: dict) -> dict:
    """Step 0 from the seed: the first gradients (D's with R1, G's), the
    losses, the Adam step of D and G and the G-EMA's step (leaves whose
    reference gradient is under GRAD_FLOOR of the median leaf's left
    out), the w-average (a batch mean of the mapping's output, first
    order in its error)."""
    keep_g, keep_d = moved(ref["grad_norm_g"]), moved(ref["grad_norm_d"])
    pd, rd = prog["delta"], ref["delta"]
    gd = rel_err(prog["grad_d"], ref["grad_d"])
    gg = rel_err(prog["grad_g"], ref["grad_g"])
    w = rel_err({"w": torch.tensor(prog["w_avg"])},
                {"w": torch.tensor(ref["w_avg"])})
    ad = median_rel(pd["d"], rd["d"], keep_d)
    ag = median_rel(pd["g"], rd["g"], keep_g)
    return {"grad_err": max(gd, gg), "grad_d_err": gd, "grad_g_err": gg,
            "loss0_err": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "adam_step_err": max(ad, ag), "adam_step_d_err": ad,
            "adam_step_g_err": ag,
            "ema_step_err": median_rel(pd["g_ema"], rd["g_ema"], keep_g),
            "w_avg_err": w,
            "score_median_gap": score_gap(prog["scores"], ref["scores"],
                                          statistics.median)}


def train_gaps(prog: dict, ref: dict) -> dict:
    """Every number of the training check: the limits file of a cell
    names those compared, the others are printed as readings."""
    out = start_gaps(prog, ref)
    if "stage" in ref:
        out.update(stage_gaps(prog.get("stage", []), ref["stage"]))
    return out


def train_detail(prog: dict, ref: dict) -> list:
    """Lines that show where each training gap comes from."""
    p, r = prog["losses"][0], ref["losses"][0]
    lines = [f"step 0 d_loss/penalty/g_loss program {p[0]:.6g} {p[1]:.6g} "
             f"{p[2]:.6g} reference {r[0]:.6g} {r[1]:.6g} {r[2]:.6g}"]
    for key in ("grad_d", "grad_g"):
        worst = sorted(((rel_err(prog[key], ref[key], [n]), n)
                        for n in ref[key]), reverse=True)[:3]
        lines += [f"{key} {n}: error {e:.4g}" for e, n in worst]
    for i, (a, b) in enumerate(zip(prog.get("stage", []),
                                   ref.get("stage", []))):
        lines.append(f"stage step {i + 1} program "
                     + " ".join(f"{k}={a.get(k, math.nan):.6g}" for k in b)
                     + " reference "
                     + " ".join(f"{k}={v:.6g}" for k, v in b.items()))
    return lines


def image_gap(prog_u8, ref_u8) -> float:
    """Worst image of the mean |prog - ref| over its pixels, in uint8
    levels (tensors (n, H, W, C))."""
    diff = (prog_u8.float() - ref_u8.float()).abs()
    return float(diff.flatten(1).mean(dim=1).max())

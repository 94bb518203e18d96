"""Plain float32 training steps of the StyleGAN2 pair, with lazy R1 and
path-length regularization: the reference that ``stylegan2-f-256``'s
training cell is held to.

One step, as the configuration file states it (``train`` has StyleGAN's;
this adds what StyleGAN2 changes): the real uint8 batch to [-1, 1] with
a per-image horizontal flip; the D update on the non-saturating loss,
with R1 (weight ``penalty_weight`` x k on every k-th step from step 0)
differentiated through D twice; one Adam step of D under the lazy
compensation k / (k + 1); the G update on the non-saturating loss against
the updated D, plus on every ``pl_every``-th step from step 0 the
path-length penalty (StyleGAN2 sec. 3.2 and app. B) at weight
``pl_weight`` x ``pl_every``; one Adam step of G, whose lr and betas take
the compensation ``pl_every`` / (``pl_every`` + 1); the G-EMA with beta
0.5 ** (batch / (ema_kimg x 1000)) and the running w-average.

Path length, on the batch // ``pl_batch_shrink`` rows of the step's own
latents and noise: w = mapping(z), the same w at every style row, the
lengths |J^T y| = sqrt(mean over style rows of the squared gradient of
sum(G(w) * y) with respect to that row), y ~ N(0, 1) / R; the running
mean ``pl_mean`` moves toward the lengths' batch mean by ``pl_decay``
(detached), and the penalty is weight x mean((length - new mean)^2). Its
gradient is taken through the first gradient (a double backward through
every modulated conv, the resampling and the mapping), block by block:
the new mean is detached, so the penalty splits by rows once the lengths'
mean is known (one pass for the lengths, one for the gradient).

Departures from the paper: the path-length weight is the program's
``pl_weight`` x ``pl_every`` with the penalty's batch mean (the official
code sums it over the batch and scales by the lazy interval alike); the
rest as ``stylegan2`` and ``train`` say. The random inputs of a step come
from a device generator seeded as the benchmark seeds the program's, in
the program's order (``draw_step``): flip, the D phase's fake batch,
WGAN-GP's interpolation weights (drawn, unused), the G phase's fake
batch, then the path-length batch on every step, firing or not.

Two checks use it, as ``train``'s: the first step from the seed
(``first_step``) and the steps after a state of the program's own
(``follow``), whose last step is forward only and, on a path-length step,
also computes that step's penalty at the state it starts from.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from portbench.reference import model as M
from portbench.reference import stylegan2 as S2
from portbench.reference import train as T


@dataclasses.dataclass
class PLDraws:
    z: torch.Tensor
    noises: list
    y: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    flip: torch.Tensor
    d: T.GenDraws
    g: T.GenDraws
    pl: PLDraws


def _draw_gen(m, batch, gen, device, dtype) -> T.GenDraws:
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    z1, z2 = normal(batch, m["latent_dim"]), normal(batch, m["latent_dim"])
    use_mix = torch.rand((), generator=gen, device=device) \
        < m["style_mixing_prob"]
    cross = torch.randint(1, S2.num_style_layers(m), (), generator=gen,
                          device=device)
    noises = [normal(batch, 1, h, w) for h, w in S2.noise_shapes(m)]
    return T.GenDraws(z1, z2, use_mix, cross, noises)


def pl_rows(c, batch: int) -> int:
    return max(batch // max(c["loss"]["pl_batch_shrink"], 1), 1)


def draw_step(c, batch, gen, device, dtype) -> StepDraws:
    m = c["model"]
    flip = torch.rand((batch,), generator=gen, device=device) < 0.5
    d = _draw_gen(m, batch, gen, device, dtype)
    torch.rand((batch, 1, 1, 1), generator=gen, device=device, dtype=dtype)
    g = _draw_gen(m, batch, gen, device, dtype)
    nb, r = pl_rows(c, batch), m["resolution"]
    z = torch.randn((nb, m["latent_dim"]), generator=gen, device=device,
                    dtype=dtype)
    noises = [torch.randn((nb, 1, h, w), generator=gen, device=device,
                          dtype=dtype) for h, w in S2.noise_shapes(m)]
    y = torch.randn((nb, m["img_channels"], r, r), generator=gen,
                    device=device) * (1.0 / r)
    return StepDraws(flip, d, g, PLDraws(z, noises, y))


def g_forward(P, m, dr: T.GenDraws, rows: slice, prec):
    """Images and w of rows ``rows`` of a fake batch (style mixing with
    the batch's one draw and crossover)."""
    z1, z2 = dr.z1[rows].float(), dr.z2[rows].float()
    ww = M.mapping(P, m, torch.cat([z1, z2]), prec)
    n, nl = z1.shape[0], S2.num_style_layers(m)
    w1, w2 = ww[:n], ww[n:]
    cross = torch.where(dr.use_mix, dr.cross, torch.full_like(dr.cross, nl))
    idx = torch.arange(nl, device=w1.device)[None, :, None]
    ws = torch.where(idx < cross, w1[:, None], w2[:, None])
    noises = [nz[rows].float() for nz in dr.noises]
    return S2.synthesis(P, m, ws, noises, prec), w1


def _d_update(Pg, Pd, m, real, dr: StepDraws, r1_weight, chunk, prec,
              used=None):
    """D's gradient of the loss (+ R1) over blocks of rows, as
    ``train._d_update`` puts it together, through the residual D."""
    B = real.shape[0]
    n = B if used is None else used
    blocks = T._blocks(B, chunk)
    D = T._leaves(Pd)
    with torch.no_grad():
        fake = torch.cat([g_forward(Pg, m, dr.d, b, prec)[0]
                          for b in blocks])
        h_r = torch.cat([S2.d_trunk(D, m, real[b], prec) for b in blocks])
        h_f = torch.cat([S2.d_trunk(D, m, fake[b], prec) for b in blocks])
    hr, hf = h_r.requires_grad_(True), h_f.requires_grad_(True)
    s_r, s_f = S2.d_head(D, hr, prec), S2.d_head(D, hf, prec)
    d_loss = F.softplus(-s_r[:n]).mean() + F.softplus(s_f[:n]).mean()
    total = d_loss
    penalty = torch.zeros((), device=real.device)
    if r1_weight:
        (u,) = torch.autograd.grad(s_r.sum(), hr, create_graph=True)
        du = torch.zeros_like(u)
        for b in blocks:
            rows = torch.arange(b.start, b.stop, device=real.device) < n
            x = real[b].detach().requires_grad_(True)
            ub = u[b].detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(S2.d_trunk(D, m, x, prec), x,
                                        grad_outputs=ub, create_graph=True)
            r = (r1_weight * 0.5 / n) * (
                gx.square().sum(dim=(1, 2, 3)) * rows).sum()
            r.backward()
            du[b] = ub.grad
            penalty = penalty + r.detach()
        total = total + (u * du).sum()
    total.backward()
    for b in blocks:
        S2.d_trunk(D, m, real[b], prec).backward(hr.grad[b])
        S2.d_trunk(D, m, fake[b], prec).backward(hf.grad[b])
    scores = torch.cat([s_r.detach(), s_f.detach()])
    return {k: v.grad for k, v in D.items()}, d_loss.detach(), penalty, \
        scores


@torch.no_grad()
def _d_scores(Pg, Pd, m, real, dr: StepDraws, chunk, prec):
    blocks = T._blocks(real.shape[0], chunk)
    fake = torch.cat([g_forward(Pg, m, dr.d, b, prec)[0] for b in blocks])
    return tuple(S2.d_head(Pd, torch.cat([S2.d_trunk(Pd, m, x[b], prec)
                                          for b in blocks]), prec)
                 for x in (real, fake))


def _pl_lengths(P, m, dr: PLDraws, rows: slice, prec, create_graph):
    """The path lengths of rows ``rows`` (float32)."""
    w = M.mapping(P, m, dr.z[rows].float(), prec)
    ws = w[:, None, :].repeat(1, S2.num_style_layers(m), 1)
    if not ws.requires_grad:
        ws.requires_grad_(True)
    img = S2.synthesis(P, m, ws, [nz[rows].float() for nz in dr.noises],
                       prec)
    (gw,) = torch.autograd.grad((img * dr.y[rows]).sum(), ws,
                                create_graph=create_graph)
    return gw.square().sum(dim=2).mean(dim=1).sqrt()


def path_length(P, m, dr: PLDraws, pl_mean, weight, decay, chunk, prec,
                used=None, grad=True):
    """(penalty, new pl_mean, lengths) at ``weight``; with ``grad`` the
    penalty's gradient is accumulated into the leaves of ``P``. ``used``
    rows (a planted fault): the lengths' mean and the penalty's over the
    first ``used`` rows only."""
    nb = dr.z.shape[0]
    n = nb if used is None else used
    blocks = T._blocks(nb, chunk)
    lens = torch.cat([_pl_lengths(P, m, dr, b, prec, False).detach()
                      for b in blocks])
    new_mean = pl_mean + decay * (lens[:n].mean() - pl_mean)
    if not grad:
        return weight * (lens[:n] - new_mean).square().mean(), new_mean, lens
    penalty = torch.zeros((), device=lens.device)
    for b in blocks:
        keep = torch.arange(b.start, b.stop, device=lens.device) < n
        part = (weight / n) * ((_pl_lengths(P, m, dr, b, prec, True)
                                - new_mean).square() * keep).sum()
        part.backward()
        penalty = penalty + part.detach()
    return penalty, new_mean, lens


def _g_update(Pg, Pd, m, dr: StepDraws, pl, chunk, prec, used=None,
              pl_used=None, pl_grad=True):
    """G's gradient of mean softplus(-D(G(z))) against a fixed D, plus the
    path-length penalty's where ``pl`` = (weight, decay, pl_mean) is given
    (and ``pl_grad``); also the batch mean of w1, and the penalty and new
    mean (or None)."""
    B = dr.g.z1.shape[0]
    n = B if used is None else used
    blocks = T._blocks(B, chunk)
    G = T._leaves(Pg)
    Dd = {k: v.detach() for k, v in Pd.items()}
    with torch.no_grad():
        h = torch.cat([S2.d_trunk(Dd, m, g_forward(G, m, dr.g, b, prec)[0],
                                  prec) for b in blocks])
    h.requires_grad_(True)
    g_loss = F.softplus(-S2.d_head(Dd, h, prec)[:n]).mean()
    (gh,) = torch.autograd.grad(g_loss, h)
    w_sum = torch.zeros(m["latent_dim"], device=h.device)
    for b in blocks:
        img, w1 = g_forward(G, m, dr.g, b, prec)
        S2.d_trunk(Dd, m, img, prec).backward(gh[b])
        w_sum += w1.detach()[:max(0, n - b.start)].sum(dim=0)
    pl_pen = new_mean = None
    if pl is not None:
        weight, decay, pl_mean = pl
        pl_pen, new_mean, _ = path_length(G, m, dr.pl, pl_mean, weight,
                                          decay, chunk, prec, pl_used,
                                          pl_grad)
    return {k: v.grad for k, v in G.items()}, g_loss.detach(), w_sum / n, \
        pl_pen, new_mean


def hparams(c):
    """(lr, beta1, beta2, eps) of G and of D: the lazy compensation
    k / (k + 1) on D from ``penalty_every``, on G from ``pl_every``."""
    o, lc = c["optim"], c["loss"]

    def ratio(k, active):
        return k / (k + 1.0) if (o["lazy_adjust"] and active and k > 1) \
            else 1.0

    rg = ratio(lc["pl_every"], lc["pl_weight"] > 0)
    rd = ratio(lc["penalty_every"], True)
    return ((o["lr_g"] * rg, o["beta1"] ** rg, o["beta2"] ** rg, o["eps"]),
            (o["lr_d"] * rd, o["beta1"] ** rd, o["beta2"] ** rd, o["eps"]))


@dataclasses.dataclass
class State(T.State):
    """``train.State`` with the running mean of the path lengths."""
    pl_mean: torch.Tensor | None = None

    def snapshot(self) -> dict:
        return dict(super().snapshot(), pl_mean=self.pl_mean)


def resume(c, snap: dict, device) -> State:
    """A state from a program's snapshot (``train.resume``'s format, and
    ``pl_mean``)."""
    hp_g, hp_d = hparams(c)
    opt_g, opt_d = T.Adam(*hp_g), T.Adam(*hp_d)
    opt_g.load(snap["moments_g"], device)
    opt_d.load(snap["moments_d"], device)
    gen = torch.Generator(device=device)
    gen.set_state(snap["gen"])
    return State({n: t.to(device, torch.float32).clone()
                  for n, t in snap["g"].items()},
                 {n: t.to(device, torch.float32).clone()
                  for n, t in snap["d"].items()}, opt_g, opt_d, gen,
                 pl_mean=snap["pl_mean"].to(device, torch.float32).clone())


def fires(every: int, i: int) -> bool:
    return every <= 1 or i % every == 0


def step(c, st: State, u8, i: int, device, chunk, prec=M.F32, fault=None,
         forward_only=False):
    """Step ``i`` on the uint8 batch ``u8``: its metrics (``pl_penalty``
    0 where path length does not fire) and (d grads, g grads, D's scores).
    Forward only: the D phase's losses and scores and, on a path-length
    step, its penalty at the state; nothing updated. ``fault``: a planted
    fault, ``half_batch`` (every batch mean after the forward over the
    first half of the rows, the path lengths' too), ``unchanged`` (the
    optimizers, the G-EMA and the w-average do not move), ``pl_off`` (the
    penalty computed and reported, its gradient left out of G's) or
    ``pl_half`` (the path lengths' means over the first half of their
    rows)."""
    m, lc = c["model"], c["loss"]
    dtype = getattr(torch, c["run"]["compute_dtype"])
    k, pe = lc["penalty_every"], lc["pl_every"]
    B = u8.shape[0]
    dr = draw_step(c, B, st.gen, device, dtype)
    real = T.preprocess(u8.to(device), dr.flip, c["data"]["hflip"])
    used = B // 2 if fault == "half_batch" else None
    pl_used = pl_rows(c, B) // 2 if fault in ("half_batch", "pl_half") \
        else None
    pl = None
    if lc["pl_weight"] > 0 and fires(pe, i):
        pl = (lc["pl_weight"] * max(pe, 1), lc["pl_decay"], st.pl_mean)
    if forward_only:
        s_r, s_f = _d_scores(st.Pg, st.Pd, m, real, dr, chunk, prec)
        n = B if used is None else used
        d_loss = F.softplus(-s_r[:n]).mean() + F.softplus(s_f[:n]).mean()
        row = {"d_loss": float(d_loss), "real_score": float(s_r.mean()),
               "fake_score": float(s_f.mean())}
        if pl is not None:
            weight, decay, pl_mean = pl
            row["pl_penalty"] = float(path_length(
                st.Pg, m, dr.pl, pl_mean, weight, decay, chunk, prec,
                pl_used, grad=False)[0])
        return row, None
    r1 = lc["penalty_weight"] * k if fires(k, i) else 0.0
    gd, d_loss, pen, scores = _d_update(st.Pg, st.Pd, m, real, dr, r1, chunk,
                                        prec, used)
    moves = fault != "unchanged"
    if moves:
        st.opt_d.step(st.Pd, gd)
    gg, g_loss, w_mean, pl_pen, new_mean = _g_update(
        st.Pg, st.Pd, m, dr, pl, chunk, prec, used, pl_used,
        fault != "pl_off")
    if moves:
        st.opt_g.step(st.Pg, gg)
    if new_mean is not None:
        st.pl_mean = new_mean.detach()
    if moves and st.ema is not None:
        b = torch.tensor(0.5 ** (B / (c["optim"]["ema_kimg"] * 1000.0)),
                         dtype=torch.float32)
        wb = torch.tensor(m["w_avg_beta"], dtype=torch.float32,
                          device=device)
        with torch.no_grad():
            for n in st.ema:
                st.ema[n].mul_(b.item()).add_(st.Pg[n],
                                              alpha=(1.0 - b).item())
            st.w_avg = st.w_avg * wb + w_mean * (1.0 - wb)
    row = {"d_loss": float(d_loss), "penalty": float(pen),
           "g_loss": float(g_loss), "real_score": float(scores[:B].mean()),
           "fake_score": float(scores[B:].mean()),
           "pl_penalty": 0.0 if pl_pen is None else float(pl_pen)}
    return row, (gd, gg, scores)


def first_step(c, Pg0, Pd0, u8, gen_seed, device, chunk, sample, prec=M.F32,
               fault=None, keep_state=False) -> dict:
    """Step 0 from the parameters ``Pg0`` / ``Pd0`` (R1 and path length
    both fire), as ``train.first_step`` reads it, with the path-length
    penalty (``pl``) and the running mean it leaves (``pl_mean``)."""
    hp_g, hp_d = hparams(c)
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    st = State({n: t.detach().clone() for n, t in Pg0.items()},
               {n: t.detach().clone() for n, t in Pd0.items()},
               T.Adam(*hp_g), T.Adam(*hp_d), gen,
               ema={n: t.detach().clone() for n, t in Pg0.items()},
               w_avg=torch.zeros(c["model"]["latent_dim"], device=device),
               pl_mean=torch.zeros((), device=device))
    row, (gd, gg, scores) = step(c, st, u8, 0, device, chunk, prec, fault)
    out = {"losses": [[row["d_loss"], row["penalty"], row["g_loss"]]],
           "pl": [row["pl_penalty"]], "pl_mean": float(st.pl_mean),
           "scores": scores.tolist(),
           "grad_d": sample(gd), "grad_g": sample(gg),
           "grad_norm_d": T.norms(gd), "grad_norm_g": T.norms(gg),
           "delta": {
               "d": sample({n: st.Pd[n] - Pd0[n] for n in st.Pd}),
               "g": sample({n: st.Pg[n] - Pg0[n] for n in st.Pg}),
               "g_ema": sample({n: st.ema[n] - Pg0[n] for n in st.ema})},
           "w_avg": st.w_avg.tolist()}
    if keep_state:
        out["state"] = st.snapshot()
    return out


def follow(c, snap: dict, reals: list, device, chunk, prec=M.F32,
           fault=None) -> list:
    """The steps after a snapshot (step indices 1, 2, ... of a cycle) on
    the uint8 batches ``reals``: each but the last a whole step, the last
    forward only. Returns each step's metrics."""
    st = resume(c, snap, device)
    rows = []
    for j, u8 in enumerate(reals):
        row, _ = step(c, st, u8, j + 1, device, chunk, prec, fault,
                      forward_only=j == len(reals) - 1)
        rows.append(row)
    return rows

"""Plain float32 training steps of the StyleGAN pair: the reference that
the training cells' steps are held to.

One step, as the configuration file states it: the real uint8 batch to
[-1, 1] with a per-image horizontal flip; the D update on the
non-saturating loss, with R1 (weight ``penalty_weight`` x k on every k-th
step from step 0, none between) differentiated through D twice; one Adam
step of D (lr and betas under the lazy-regularization compensation
k / (k + 1)); the G update on the non-saturating loss against the updated
D; one Adam step of G; the G-EMA with beta 0.5 ** (batch / (ema_kimg x
1000)) and the running w-average with ``w_avg_beta``.

The random inputs of a step (flip mask, latents, style-mixing draw and
crossover, noise images) are drawn from a generator on the device seeded
as the benchmark seeds the program's, in the order the program documents
(``draw_step``): they are inputs that the benchmark's seed fixes, made
here again, not read from the program.

Two checks use it (``first_step``, ``follow``): the first step from the
weights and draws of the seed, and the steps after a state of the
program's own (its parameters, Adam moments and generator state), which
the reference follows step by step because a bfloat16 run parts from a
float32 one after its first, sign-like Adam step.

The discriminator runs in blocks of rows so that 1024^2 fits in float32:
its trunk (every layer before the minibatch statistic) block by block, its
output block over the whole batch. The gradient of the whole batch is put
back together exactly, R1's double backward included (``_d_update``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from portbench.reference import model as M


@dataclasses.dataclass
class GenDraws:
    z1: torch.Tensor
    z2: torch.Tensor
    use_mix: torch.Tensor
    cross: torch.Tensor
    noises: list


@dataclasses.dataclass
class StepDraws:
    flip: torch.Tensor
    d: GenDraws
    g: GenDraws


def _draw_gen(m, batch, gen, device, dtype) -> GenDraws:
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    z1, z2 = normal(batch, m["latent_dim"]), normal(batch, m["latent_dim"])
    use_mix = torch.rand((), generator=gen, device=device) \
        < m["style_mixing_prob"]
    cross = torch.randint(1, M.num_style_layers(m), (), generator=gen,
                          device=device)
    noises = [normal(batch, 1, h, w) for h, w in M.noise_shapes(m)]
    return GenDraws(z1, z2, use_mix, cross, noises)


def draw_step(m, batch, gen, device, dtype) -> StepDraws:
    """A step's draws in the program's order: flip, the D phase's fake
    batch, WGAN-GP's interpolation weights (drawn, unused under R1), the G
    phase's fake batch."""
    flip = torch.rand((batch,), generator=gen, device=device) < 0.5
    d = _draw_gen(m, batch, gen, device, dtype)
    torch.rand((batch, 1, 1, 1), generator=gen, device=device, dtype=dtype)
    g = _draw_gen(m, batch, gen, device, dtype)
    return StepDraws(flip, d, g)


def preprocess(real_u8, flip, hflip=True):
    x = real_u8.float() * (2.0 / 255.0) - 1.0
    x = x.permute(0, 3, 1, 2)
    if hflip:
        x = torch.where(flip[:, None, None, None], x.flip(3), x)
    return x.contiguous()


def g_forward(P, m, dr: GenDraws, rows: slice, prec):
    """Images and w of rows ``rows`` of a fake batch (style mixing with
    the batch's one draw and crossover)."""
    z1, z2 = dr.z1[rows].float(), dr.z2[rows].float()
    ww = M.mapping(P, m, torch.cat([z1, z2]), prec)
    n, nl = z1.shape[0], M.num_style_layers(m)
    w1, w2 = ww[:n], ww[n:]
    cross = torch.where(dr.use_mix, dr.cross, torch.full_like(dr.cross, nl))
    idx = torch.arange(nl, device=w1.device)[None, :, None]
    ws = torch.where(idx < cross, w1[:, None], w2[:, None])
    noises = [nz[rows].float() for nz in dr.noises]
    return M.synthesis(P, m, ws, noises, prec), w1


def _blocks(n, chunk):
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def _leaves(P):
    return {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}


def _d_update(Pg, Pd, m, real, dr: StepDraws, r1_weight, chunk, prec,
              used=None):
    """D's gradient of mean softplus(-D(real)) + mean softplus(D(fake))
    (+ R1), over blocks of rows. With h = trunk(x) per row and u the
    gradient of sum D(real) w.r.t. h (the output block couples the rows),
    R1 = c sum_i |J_i^T u_i|^2: its gradient is that at fixed u, taken
    block by block (which also gives dR1/du), plus <dR1/du, du/dtheta>,
    taken through the output block and then the trunk, block by block.

    ``used`` rows < B (a planted fault): the means of the loss and of R1
    over the first ``used`` rows only, every row run."""
    B = real.shape[0]
    n = B if used is None else used
    blocks = _blocks(B, chunk)
    D = _leaves(Pd)
    with torch.no_grad():
        fake = torch.cat([g_forward(Pg, m, dr.d, b, prec)[0]
                          for b in blocks])
        h_r = torch.cat([M.d_trunk(D, m, real[b], prec) for b in blocks])
        h_f = torch.cat([M.d_trunk(D, m, fake[b], prec) for b in blocks])
    hr, hf = h_r.requires_grad_(True), h_f.requires_grad_(True)
    s_r, s_f = M.d_head(D, hr, prec), M.d_head(D, hf, prec)
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
            (gx,) = torch.autograd.grad(M.d_trunk(D, m, x, prec), x,
                                        grad_outputs=ub, create_graph=True)
            r = (r1_weight * 0.5 / n) * (
                gx.square().sum(dim=(1, 2, 3)) * rows).sum()
            r.backward()
            du[b] = ub.grad
            penalty = penalty + r.detach()
        total = total + (u * du).sum()
    total.backward()
    for b in blocks:
        M.d_trunk(D, m, real[b], prec).backward(hr.grad[b])
        M.d_trunk(D, m, fake[b], prec).backward(hf.grad[b])
    scores = torch.cat([s_r.detach(), s_f.detach()])
    return {k: v.grad for k, v in D.items()}, d_loss.detach(), penalty, \
        scores


@torch.no_grad()
def _d_scores(Pg, Pd, m, real, dr: StepDraws, chunk, prec):
    """D's scores of the real rows and of the D phase's fake rows."""
    blocks = _blocks(real.shape[0], chunk)
    fake = torch.cat([g_forward(Pg, m, dr.d, b, prec)[0] for b in blocks])
    return tuple(M.d_head(Pd, torch.cat([M.d_trunk(Pd, m, x[b], prec)
                                         for b in blocks]), prec)
                 for x in (real, fake))


def _g_update(Pg, Pd, m, dr: GenDraws, chunk, prec, used=None):
    """G's gradient of mean softplus(-D(G(z))) against a fixed D, over
    blocks of rows; also the batch mean of w1 (both means over the first
    ``used`` rows: a planted fault)."""
    B = dr.z1.shape[0]
    n = B if used is None else used
    blocks = _blocks(B, chunk)
    G = _leaves(Pg)
    Dd = {k: v.detach() for k, v in Pd.items()}
    with torch.no_grad():
        h = torch.cat([M.d_trunk(Dd, m, g_forward(G, m, dr, b, prec)[0],
                                 prec) for b in blocks])
    h.requires_grad_(True)
    g_loss = F.softplus(-M.d_head(Dd, h, prec)[:n]).mean()
    (gh,) = torch.autograd.grad(g_loss, h)
    w_sum = torch.zeros(m["latent_dim"], device=h.device)
    for b in blocks:
        img, w1 = g_forward(G, m, dr, b, prec)
        M.d_trunk(Dd, m, img, prec).backward(gh[b])
        w_sum += w1.detach()[:max(0, n - b.start)].sum(dim=0)
    return {k: v.grad for k, v in G.items()}, g_loss.detach(), w_sum / n


class Adam:
    """torch.optim.Adam's arithmetic (per-parameter step counts from the
    first gradient; a parameter without a gradient is not stepped)."""

    def __init__(self, lr, b1, b2, eps):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, {}

    def load(self, moments: dict, device) -> None:
        """Moments name -> (exp_avg, exp_avg_sq, step), as a program's
        state holds them."""
        for k, (m, v, t) in moments.items():
            self.m[k] = m.to(device, torch.float32).clone()
            self.v[k] = v.to(device, torch.float32).clone()
            self.t[k] = int(t)

    @torch.no_grad()
    def step(self, P, grads):
        for k, g in grads.items():
            if g is None:
                continue
            t = self.t[k] = self.t.get(k, 0) + 1
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(1.0 - self.b2 ** t) + self.eps
            P[k] -= (self.lr / (1.0 - self.b1 ** t)) * m / denom


def hparams(c):
    """(lr, beta1, beta2, eps) of G and of D, the lazy compensation k/(k+1)
    on D."""
    o, k = c["optim"], c["loss"]["penalty_every"]
    r = k / (k + 1.0) if (o["lazy_adjust"] and k > 1) else 1.0
    return ((o["lr_g"], o["beta1"], o["beta2"], o["eps"]),
            (o["lr_d"] * r, o["beta1"] ** r, o["beta2"] ** r, o["eps"]))


def norms(tensors: dict) -> dict:
    """name -> float norm of each tensor that is not None."""
    keys = [k for k, v in tensors.items() if v is not None]
    if not keys:
        return {}
    vals = torch.stack([tensors[k].float().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


@dataclasses.dataclass
class State:
    """What the reference steps: parameters, the two Adams, the draws'
    generator, and (from the seed only) the G-EMA and the w-average."""
    Pg: dict
    Pd: dict
    opt_g: Adam
    opt_d: Adam
    gen: torch.Generator
    ema: dict | None = None
    w_avg: torch.Tensor | None = None

    def snapshot(self) -> dict:
        """The state in the format of a program's snapshot (``resume``)."""
        def moments(opt):
            return {k: (opt.m[k], opt.v[k], opt.t[k]) for k in opt.t}

        return {"g": self.Pg, "d": self.Pd, "moments_g": moments(self.opt_g),
                "moments_d": moments(self.opt_d),
                "gen": self.gen.get_state().clone()}


def resume(c, snap: dict, device) -> State:
    """A state from a snapshot: parameters and moments (name -> tensor,
    name -> (exp_avg, exp_avg_sq, step)) and the generator's state."""
    hp_g, hp_d = hparams(c)
    opt_g, opt_d = Adam(*hp_g), Adam(*hp_d)
    opt_g.load(snap["moments_g"], device)
    opt_d.load(snap["moments_d"], device)
    gen = torch.Generator(device=device)
    gen.set_state(snap["gen"])
    return State({n: t.to(device, torch.float32).clone()
                  for n, t in snap["g"].items()},
                 {n: t.to(device, torch.float32).clone()
                  for n, t in snap["d"].items()}, opt_g, opt_d, gen)


def step(c, st: State, u8, i: int, device, chunk, prec=M.F32, fault=None,
         forward_only=False):
    """Step ``i`` (R1 where k divides it) on the uint8 batch ``u8``:
    returns its metrics and (d grads, g grads, D's scores). Forward only:
    the D phase's losses and scores, nothing updated. ``fault``: a planted
    fault, ``half_batch`` (every batch mean after the forward over the
    first half of the rows) or ``unchanged`` (the optimizers, the G-EMA
    and the w-average do not move)."""
    m, lc = c["model"], c["loss"]
    dtype = getattr(torch, c["run"]["compute_dtype"])
    k = lc["penalty_every"]
    B = u8.shape[0]
    dr = draw_step(m, B, st.gen, device, dtype)
    real = preprocess(u8.to(device), dr.flip, c["data"]["hflip"])
    used = B // 2 if fault == "half_batch" else None
    if forward_only:
        s_r, s_f = _d_scores(st.Pg, st.Pd, m, real, dr, chunk, prec)
        n = B if used is None else used
        d_loss = F.softplus(-s_r[:n]).mean() + F.softplus(s_f[:n]).mean()
        return {"d_loss": float(d_loss), "real_score": float(s_r.mean()),
                "fake_score": float(s_f.mean())}, None
    r1 = lc["penalty_weight"] * k if (k <= 1 or i % k == 0) else 0.0
    gd, d_loss, pen, scores = _d_update(st.Pg, st.Pd, m, real, dr, r1, chunk,
                                        prec, used)
    moves = fault != "unchanged"
    if moves:
        st.opt_d.step(st.Pd, gd)
    gg, g_loss, w_mean = _g_update(st.Pg, st.Pd, m, dr.g, chunk, prec, used)
    if moves:
        st.opt_g.step(st.Pg, gg)
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
           "fake_score": float(scores[B:].mean())}
    return row, (gd, gg, scores)


def first_step(c, Pg0, Pd0, u8, gen_seed, device, chunk, sample, prec=M.F32,
               fault=None, keep_state=False) -> dict:
    """Step 0 from the parameters ``Pg0`` / ``Pd0`` on the uint8 batch
    ``u8``, the draws from a device generator seeded ``gen_seed``: its
    losses, D's scores of its real and fake rows, each leaf's first
    gradient (``sample``d, and its norm) and change after the step (G, D,
    G-EMA: ``sample``d; the w-average whole). ``keep_state``: also the
    state after the step (``State.snapshot``)."""
    hp_g, hp_d = hparams(c)
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    st = State({n: t.detach().clone() for n, t in Pg0.items()},
               {n: t.detach().clone() for n, t in Pd0.items()},
               Adam(*hp_g), Adam(*hp_d), gen,
               ema={n: t.detach().clone() for n, t in Pg0.items()},
               w_avg=torch.zeros(c["model"]["latent_dim"], device=device))
    row, (gd, gg, scores) = step(c, st, u8, 0, device, chunk, prec, fault)
    out = {"losses": [[row["d_loss"], row["penalty"], row["g_loss"]]],
           "scores": scores.tolist(),
           "grad_d": sample(gd), "grad_g": sample(gg),
           "grad_norm_d": norms(gd), "grad_norm_g": norms(gg),
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
    its D phase's forward. Returns each step's metrics."""
    st = resume(c, snap, device)
    rows = []
    for j, u8 in enumerate(reals):
        row, _ = step(c, st, u8, j + 1, device, chunk, prec, fault,
                      forward_only=j == len(reals) - 1)
        rows.append(row)
    return rows

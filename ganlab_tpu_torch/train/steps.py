"""The sequential G/D training step with lazy regularization, on PyTorch.

Port of the sequential branch of ``ganlab_tpu/train/steps.py``
(``build_train_step`` with ``make_lazy_stepper``), for every ported family.
One step:

1. real uint8 NHWC batch -> NCHW [-1, 1] in the compute dtype, with a
   per-sample horizontal flip (``_preprocess``);
2. D update: a fake batch from G (no grad), D on real and on fake, the
   loss, and on a penalty step R1 or WGAN-GP through a double backward of
   D (a third D forward, on the real batch or on the interpolates), plus
   the drift term where ``loss.drift_weight`` is set; loss + penalty
   minimized with one backward and one Adam step;
3. G update against the updated D, differentiating only G's parameters;
   on a path-length step (``loss.pl_weight`` > 0, style families) the
   objective adds the path-length penalty (``path_length_penalty``) and
   the state's ``pl_mean`` takes its updated running mean;
4. G-EMA with ``optim.ema_beta_for(batch)`` and, for the style families,
   the running w-average;
5. counters.

The generator forward of the style families maps concat([z1, z2]) once,
mixes styles and draws noise; ProGAN and ResNet-GAN map z straight to
images. n-critic (``loss.d_steps_per_g`` = n > 1): D is updated every step,
G, G-EMA and the w-average only on steps with ``state.step % n == n - 1``,
and ``g_loss`` reads 0 on the others (the JAX package's ``lax.cond``).

In a fade phase alpha = clip((shown - phase start) / fade images, 0, 1) from
the state's shown-image count before the step, one value for the D step,
the penalty's critic and the G step, and every forward of G and D takes
the fade branch, whatever alpha's value.

The host picks one step function per step (lazy regularization): the D
penalty fires with weight x ``loss.penalty_every`` every
``penalty_every``-th step, path-length regularization with weight x
``loss.pl_every`` every ``pl_every``-th step, and each pair of the two
that occurs is one step function (k = 16 and pl_every = 4: three). Every
random draw (latents, mixing, crossover, noise maps, flip mask, WGAN-GP
interpolation, the path-length batch) comes from the state's generator, or
is injected through ``draws=`` (``StepDraws``), which the parity tests
use.

Options this port does not run raise ``NotImplementedError`` (ROADMAP.md
A): the fused steps, two-phase regularization, augmentation and gradient
accumulation. Entry:
``create_train_state`` -> ``make_lazy_stepper(cfg, phase)`` ->
``stepper(state, real_u8)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ganlab_tpu_torch.config import Config
from ganlab_tpu_torch.models import is_style, noise_shapes
from ganlab_tpu_torch.models.stylegan import mix_styles, num_style_layers
from ganlab_tpu_torch.ops import losses as L
from ganlab_tpu_torch.train.schedule import PhaseSpec
from ganlab_tpu_torch.train.state import (
    TrainState,
    optimizer_hparams,
    seed_new_moments,
)


def _dtype_of(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.run.compute_dtype)


def _moved(obj, device):
    """A copy of a draws dataclass with every tensor on ``device``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, list):
            v = [t.to(device) for t in v]
        elif dataclasses.is_dataclass(v):
            v = _moved(v, device)
        out[f.name] = v
    return type(obj)(**out)


@dataclasses.dataclass
class GenDraws:
    """The random inputs of one generator forward. The families without a
    mapping network draw z1 only; the other fields stay None / empty."""

    z1: torch.Tensor                # (N, latent) compute dtype
    z2: torch.Tensor | None = None  # (N, latent), the mixing latent
    use_mix: torch.Tensor | None = None  # () bool, Bernoulli(mixing prob)
    cross: torch.Tensor | None = None    # () int64 crossover in [1, L)
    noises: list = dataclasses.field(default_factory=list)  # per noise
                                    # layer (N, 1, H, W)


@dataclasses.dataclass
class PLDraws:
    """The random inputs of the path-length term, at the batch
    N // ``loss.pl_batch_shrink``."""

    z: torch.Tensor                 # (N, latent) compute dtype
    noises: list                    # per noise layer (N, 1, H, W)
    y: torch.Tensor                 # (N, C, H, W) float32, N(0, 1) / 2^lg


@dataclasses.dataclass
class StepDraws:
    """Every random input of one training step."""

    flip: torch.Tensor              # (N,) bool: flip this real image
    d: GenDraws                     # the D phase's fake batch
    g: GenDraws                     # the G phase's fake batch
    gp_eps: torch.Tensor            # (N, 1, 1, 1) WGAN-GP interpolation
    pl: PLDraws | None = None       # when ``cfg.pl_active``

    def to(self, device) -> "StepDraws":
        return _moved(self, device)


def draw_generator(cfg: Config, res_log2: int, batch: int,
                   gen: torch.Generator, device) -> GenDraws:
    dtype = _dtype_of(cfg)
    zdim = cfg.model.latent_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    if not is_style(cfg.model):
        return GenDraws(normal(batch, zdim))
    z1, z2 = normal(batch, zdim), normal(batch, zdim)
    use_mix = torch.rand((), generator=gen, device=device) \
        < cfg.model.style_mixing_prob
    cross = torch.randint(1, num_style_layers(res_log2), (), generator=gen,
                          device=device)
    noises = [normal(batch, 1, h, w)
              for h, w in noise_shapes(cfg.model, res_log2)]
    return GenDraws(z1, z2, use_mix, cross, noises)


def pl_batch(cfg: Config, batch: int) -> int:
    """The path-length term's batch: batch // ``loss.pl_batch_shrink``."""
    return max(batch // max(cfg.loss.pl_batch_shrink, 1), 1)


def draw_pl(cfg: Config, res_log2: int, batch: int, gen: torch.Generator,
            device) -> PLDraws:
    nb, res = pl_batch(cfg, batch), 2 ** res_log2
    dtype = _dtype_of(cfg)
    z = torch.randn((nb, cfg.model.latent_dim), generator=gen,
                    device=device, dtype=dtype)
    noises = [torch.randn((nb, 1, h, w), generator=gen, device=device,
                          dtype=dtype)
              for h, w in noise_shapes(cfg.model, res_log2)]
    # the projection's 1/sqrt(H W) = 1/2^lg for a square image
    y = torch.randn((nb, cfg.model.img_channels, res, res), generator=gen,
                    device=device) * (1.0 / res)
    return PLDraws(z, noises, y)


def draw_step(cfg: Config, res_log2: int, batch: int, gen: torch.Generator,
              device) -> StepDraws:
    """All draws of one step, in a fixed order, from ``gen``. The
    path-length draws come last and only where ``cfg.pl_active`` (on every
    step, whether or not the term fires), so the streams of the other
    configurations stay as they were."""
    flip = torch.rand((batch,), generator=gen, device=device) < 0.5
    d = draw_generator(cfg, res_log2, batch, gen, device)
    gp_eps = torch.rand((batch, 1, 1, 1), generator=gen, device=device,
                        dtype=_dtype_of(cfg))
    g = draw_generator(cfg, res_log2, batch, gen, device)
    pl = draw_pl(cfg, res_log2, batch, gen, device) if cfg.pl_active \
        else None
    return StepDraws(flip, d, g, gp_eps, pl)


def _preprocess(real_u8: torch.Tensor, hflip: bool, flip: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """uint8 (N, H, W, C) -> NCHW [-1, 1] in ``dtype``, each image flipped
    along W where ``flip`` is set (when ``hflip``)."""
    x = real_u8.to(torch.float32) * (2.0 / 255.0) - 1.0
    x = x.permute(0, 3, 1, 2)
    if hflip:
        x = torch.where(flip[:, None, None, None], x.flip(3), x)
    return x.to(dtype).contiguous()


@torch.no_grad()
def _ema_update(ema: torch.nn.Module, model: torch.nn.Module,
                beta: float) -> None:
    """ema <- ema * beta + model * (1 - beta), in place, parameter-wise,
    with beta and 1 - beta rounded to float32 as the JAX package does."""
    b = torch.tensor(beta, dtype=torch.float32)
    e = list(ema.parameters())
    p = [t.to(x.dtype) for t, x in zip(model.parameters(), e)]
    torch._foreach_mul_(e, b.item())
    torch._foreach_add_(e, p, alpha=(1.0 - b).item())


def build_generator_forward(cfg: Config, res_log2: int) -> Callable:
    """(g, GenDraws, alpha, fade) -> (fake images NCHW, w_mean float32).

    Style families: one mapping pass over concat([z1, z2]); with
    probability ``style_mixing_prob`` (one draw per batch) the styles cross
    over from w1 to w2 at the drawn layer; w_mean is the batch mean of w1.
    The other families: z1 straight to images, w_mean None."""
    if not is_style(cfg.model):
        def plain_forward(g, dr: GenDraws, alpha, fade=None):
            return g(dr.z1, res_log2, alpha, fade), None

        return plain_forward
    nl = num_style_layers(res_log2)

    def forward(g, dr: GenDraws, alpha, fade=None):
        batch = dr.z1.shape[0]
        ww = g.map_latents(torch.cat([dr.z1, dr.z2], dim=0))
        w1, w2 = ww[:batch], ww[batch:]
        crossover = torch.where(dr.use_mix, dr.cross,
                                torch.full_like(dr.cross, nl))
        ws = mix_styles(w1, w2, crossover, nl)
        img = g.synthesize(ws, res_log2, alpha, dr.noises, fade=fade)
        return img, w1.float().mean(dim=0)

    return forward


def _check_supported(cfg: Config, phase: PhaseSpec) -> None:
    lc = cfg.loss
    for what, on in (("loss.fused_g_step", lc.fused_g_step),
                     ("loss.fused_seq", lc.fused_seq),
                     ("loss.reg_separate", lc.reg_separate),
                     ("aug.mode (ADA)", cfg.aug_active),
                     ("optim.grad_accum > 1", cfg.optim.grad_accum > 1)):
        if on:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet (ROADMAP.md A)")
    if cfg.pl_active and lc.d_steps_per_g > 1:
        # the PL cadence would be independent of the G cadence
        raise ValueError("loss.pl_weight > 0 requires d_steps_per_g == 1")


def phase_alpha(phase: PhaseSpec, shown_imgs: int,
                dtype: torch.dtype = torch.float32) -> float:
    """The fade-in weight of a step that starts at ``shown_imgs``: 1.0 in
    a stabilize phase, clip((shown - start) / fade images, 0, 1) in a fade
    phase, computed in float32 and rounded to ``dtype`` (the blend's
    dtype), as the JAX package's step and ``fade_in`` do. Host arithmetic
    on the host's counter: no device work."""
    if phase.kind != "fade":
        return 1.0
    a = (np.float32(shown_imgs) - np.float32(phase.start_img)) \
        / np.float32(max(phase.fade_images, 1))
    a = float(np.clip(a, np.float32(0.0), np.float32(1.0)))
    return a if dtype == torch.float32 else float(torch.tensor(a).to(dtype))


def path_length_penalty(g, pl_mean: torch.Tensor, dr: PLDraws,
                        res_log2: int, alpha, *, weight: float, decay: float,
                        fade: bool = False):
    """(penalty, new pl_mean, lengths) of path-length regularization
    (StyleGAN2 app. B): lengths |J_w^T y| of the synthesis at the mapped
    ``dr.z`` with the noise ``dr.noises`` against the projection ``dr.y``,
    the running mean moved toward their mean by ``decay`` (detached), and
    ``weight * mean((length - new mean)^2)``.

    The gradient with respect to the per-layer styles keeps its graph, and
    the styles stay attached to the mapping network, so the penalty's
    gradient reaches every layer of G, the mapping layers too."""
    w = g.map_latents(dr.z)
    ws = w[:, None, :].repeat(1, num_style_layers(res_log2), 1)
    img = g.synthesize(ws, res_log2, alpha, dr.noises, fade=fade)
    (gw,) = torch.autograd.grad((img.float() * dr.y).sum(), ws,
                                create_graph=True)
    pl_len = gw.float().square().sum(dim=2).mean(dim=1).sqrt()
    new_mean = (pl_mean + decay * (pl_len.mean() - pl_mean)).detach()
    return weight * (pl_len - new_mean).square().mean(), new_mean, pl_len


def build_train_step(cfg: Config, phase: PhaseSpec,
                     penalty_override: bool | None = None,
                     pl_override: bool | None = None) -> Callable:
    """``step(state, real_u8, draws=None) -> (state, metrics)`` for a phase.

    ``penalty_override``: None applies the configured penalty every step
    at its plain weight; True applies it with weight x ``penalty_every``;
    False leaves it out. ``pl_override`` does the same for path-length
    regularization (weight x ``pl_every`` when True), which only a
    ``cfg.pl_active`` configuration has. The step runs on the state's
    device; ``real_u8`` and injected ``draws`` are moved there. The
    function carries its two weights as ``pen_weight`` and ``pl_weight``
    (0.0 where the term is off)."""
    _check_supported(cfg, phase)
    if pl_override and not cfg.pl_active:
        raise ValueError("pl_override=True needs loss.pl_weight > 0 and a "
                         "style family")
    res_log2 = phase.res_log2
    gen_forward = build_generator_forward(cfg, res_log2)
    dtype = _dtype_of(cfg)
    lc = cfg.loss
    d_loss_fn, g_loss_fn = L.D_LOSSES[lc.loss], L.G_LOSSES[lc.loss]
    hp_g, hp_d = optimizer_hparams(cfg, phase.resolution)
    has_penalty = lc.penalty in ("wgan-gp", "r1")
    with_penalty = has_penalty if penalty_override is None \
        else penalty_override
    pen_weight = lc.penalty_weight * (
        lc.penalty_every if penalty_override is True else 1)
    fade = phase.kind == "fade"
    style = is_style(cfg.model)
    n_critic = max(1, lc.d_steps_per_g)
    w_beta = torch.tensor(cfg.model.w_avg_beta, dtype=torch.float32)
    with_pl = cfg.pl_active if pl_override is None else pl_override
    pl_weight = lc.pl_weight * (lc.pl_every if pl_override is True else 1)

    def ema_beta(batch: int, shown: int) -> float:
        o = cfg.optim
        if o.ema_rampup is not None:
            nimg = min(o.ema_kimg * 1000.0, shown * o.ema_rampup)
            return 0.5 ** (batch / max(nimg, 1.0))
        return o.ema_beta_for(batch)

    def penalty_term(d, real, fake, draws, real_s, alpha):
        penalty = torch.zeros((), device=real.device)
        if with_penalty:
            def critic(x):
                return d(x, res_log2, alpha, fade).float()

            if lc.penalty == "wgan-gp":
                penalty = L.wgan_gp(critic, real, fake, None, pen_weight,
                                    eps=draws.gp_eps)
            else:
                penalty = L.r1_penalty(critic, real, pen_weight)
        if lc.drift_weight:
            penalty = penalty + L.drift_penalty(real_s, lc.drift_weight)
        return penalty

    def set_hparams(opt, hp):
        for group in opt.param_groups:
            group.update(hp)

    def step(state: TrainState, real_u8: torch.Tensor,
             draws: StepDraws | None = None):
        dev = state.device
        batch = real_u8.shape[0]
        if draws is None:
            draws = draw_step(cfg, res_log2, batch, state.generator, dev)
        else:
            draws = draws.to(dev)
        g, d = state.g, state.d
        alpha = phase_alpha(phase, state.shown_imgs, dtype)
        real = _preprocess(real_u8.to(dev), cfg.data.hflip, draws.flip,
                           dtype)

        # -- D step --------------------------------------------------------
        with torch.no_grad():
            fake_d, _ = gen_forward(g, draws.d, alpha, fade)
        real_s = d(real, res_log2, alpha, fade).float()
        fake_s = d(fake_d, res_log2, alpha, fade).float()
        d_loss = d_loss_fn(real_s, fake_s)
        penalty = penalty_term(d, real, fake_d, draws, real_s, alpha)
        state.opt_d.zero_grad(set_to_none=True)
        (d_loss + penalty).backward()
        set_hparams(state.opt_d, hp_d)
        seed_new_moments(state.opt_d, state.step - state.opt_step0)
        state.opt_d.step()

        # -- G step, against the updated D (every n-th step with n-critic)
        if state.step % n_critic == n_critic - 1:
            d.requires_grad_(False)
            try:
                fake, w_mean = gen_forward(g, draws.g, alpha, fade)
                g_loss = g_loss_fn(d(fake, res_log2, alpha, fade).float())
                objective = g_loss
                if with_pl:
                    if draws.pl is None:
                        raise ValueError("a path-length step needs "
                                         "StepDraws.pl")
                    pl_pen, pl_mean, _ = path_length_penalty(
                        g, state.pl_mean, draws.pl, res_log2, alpha,
                        weight=pl_weight, decay=lc.pl_decay, fade=fade)
                    objective = g_loss + pl_pen
                state.opt_g.zero_grad(set_to_none=True)
                objective.backward()
            finally:
                d.requires_grad_(True)
            set_hparams(state.opt_g, hp_g)
            # G's Adam count: the G updates since the moments began
            seed_new_moments(state.opt_g, state.step // n_critic
                             - state.opt_step0 // n_critic)
            state.opt_g.step()
            if with_pl:
                state.pl_mean = pl_mean

            with torch.no_grad():
                _ema_update(state.g_ema, g,
                            ema_beta(batch, state.shown_imgs))
                if style:
                    wb = w_beta.to(dev)
                    state.w_avg.copy_(state.w_avg * wb
                                      + w_mean * (1.0 - wb))
        else:
            g_loss = torch.zeros((), device=dev)
        state.step += 1
        state.shown_imgs += batch
        metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                   "penalty": penalty.detach(),
                   "real_score": real_s.detach().mean(),
                   "fake_score": fake_s.detach().mean(), "alpha": alpha}
        if cfg.pl_active:
            # only path-length configurations carry the metric, as in JAX
            metrics["pl_penalty"] = pl_pen.detach() if with_pl \
                else torch.zeros((), device=dev)
        return state, metrics

    step.pen_weight = pen_weight if with_penalty else 0.0
    step.pl_weight = pl_weight if with_pl else 0.0
    return step


def _lazy_combos(cfg: Config):
    """(d_override, pl_override) per step index for the lazy dispatch.

    ``combo_at(i)`` maps the optimizer-step counter to the override pair:
    None = as configured every step (plain weight), True = fire with
    interval-scaled weight, False = the non-fire step."""
    lc = cfg.loss
    has_pen = lc.penalty in ("wgan-gp", "r1")
    k = lc.penalty_every
    pl_active = cfg.pl_active
    pe = lc.pl_every

    def combo_at(i: int):
        if not has_pen:
            dpen = False
        elif k <= 1:
            dpen = None
        else:
            dpen = (i % k) == 0
        if not pl_active:
            pl = False
        elif pe <= 1:
            pl = None
        else:
            pl = (i % pe) == 0
        return dpen, pl

    lazy = (has_pen and k > 1) or (pl_active and pe > 1)
    return combo_at, lazy


def make_lazy_stepper(cfg: Config, phase: PhaseSpec,
                      initial_step: int = 0) -> Callable:
    """Host-side lazy-regularization dispatcher:
    ``stepper(state, real_u8, draws=None) -> (state, metrics)``.

    Builds the step variants that occur, one per (D penalty, path length)
    pair of overrides, when first needed, and picks one per step from its
    own counter, seeded with ``initial_step`` on resume. No laziness -> one
    step function. The stepper's ``programs`` maps each pair to its step
    function."""
    combo_at, lazy = _lazy_combos(cfg)
    cache: dict = {}

    def get(dpen, pl):
        if (dpen, pl) not in cache:
            cache[(dpen, pl)] = build_train_step(
                cfg, phase, penalty_override=dpen, pl_override=pl)
        return cache[(dpen, pl)]

    if not lazy:
        return get(*combo_at(0))

    counter = {"i": int(initial_step)}

    def stepper(state, real_u8, draws=None):
        fn = get(*combo_at(counter["i"]))
        counter["i"] += 1
        return fn(state, real_u8, draws)

    stepper.programs = cache
    return stepper

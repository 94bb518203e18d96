"""The G/D training step with lazy regularization, on PyTorch.

Port of ``ganlab_tpu/train/steps.py`` (``build_train_step`` with
``make_lazy_stepper``), for every family. One sequential step:

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

Gradient accumulation (``optim.grad_accum`` = A > 1; the JAX package's
``step_accum``): the step takes A microbatches of the phase's batch, one
after the other, and makes one update. Each microbatch is what one device
of a data-parallel run sees: its own flips, latents, noise, minibatch
stddev and penalties. D's gradients are summed over A backward passes
(one microbatch's activations live at a time) and divided by A, then the
same for G against the updated D; the metrics and the batch mean of w are
averaged over the microbatches; on a path-length step ``pl_mean`` is
moved once a microbatch with the decay 1 - (1 - ``pl_decay``)^(1/A), so
that its horizon per step is the configured one.

Data parallelism (``parallel/dist.py``): under a process group of N
ranks each rank runs the step on its own shard and the step averages
over the ranks what the JAX step ``pmean``s over its mesh: D's and G's
gradients (one flat all-reduce a network an update), the metrics, the
batch mean of w and the mean path length; the G-EMA's beta and the
shown-image count take the global batch, micro x A x N. Accumulation and
data parallelism compose.

Randomness: with A = 1 and one process every draw comes from the state's
generator, in ``draw_step``'s order. Otherwise the generator advances by
one draw a step and microbatch j of rank r draws from a generator seeded
from the state generator's state and the index r x A + j
(``fork_generators``): the ranks' draws differ, the state stays the same
on every rank, and microbatch j of an accumulating step draws what rank j
of a data-parallel run with A = 1 draws (the JAX package folds the
microbatch index where it folds the device's).

Discriminator augmentation (``aug.mode`` ``fixed`` / ``ada``;
``ops/augment.py``): D sees only augmented images. Each microbatch draws
three ``AugParams`` at the step's strength p, last in ``draw_step``: its
reals and D's fakes are augmented before the D loss and the penalty (R1,
WGAN-GP and drift read the augmented reals), and G's fakes before D in the
G loss, the gradient flowing through the augmentation into G. With
``aug.mode=ada`` p is the state's ``ada_p`` (a 0-d float32 tensor on the
device): the D step measures rt = mean(sign(D(augmented reals))), averaged
over the microbatches and then over the replicas, and after the D update p
moves by sign(rt - ``aug.target``) x global batch / (``aug.kimg`` x 1000),
clipped to [0, ``aug.p_max``], on the device with no host read; the step's
metrics gain ``aug_p`` (the new p) and ``aug_rt``. ``fixed`` gates at
``aug.p_init`` and keeps no state. Every draw of a step, G's included, is
gated with the p the step starts from.

The opt-in step recipes (all off in every preset):

* ``loss.reg_separate`` (the official StyleGAN2-ADA Dmain / Dreg
  structure): on a penalty step D takes two Adam steps, first the main
  loss (plus drift) at the step's weights, then R1 or WGAN-GP alone at the
  post-main weights on the same augmented reals, fakes and ``gp_eps``;
  the ``penalty`` metric is the second pass's value. Every D parameter's
  Adam count then advances by two on such a step, so a head seeded late
  takes the steps since the moments began plus the penalty steps among
  them (``penalty_ticks``). Off a penalty step it is the sequential step
  bit for bit. Refused with accumulation (by the config).
* ``loss.fused_seq``: G's update scores the D step's fake batch, drawn
  from ``StepDraws.d``, against the updated D (G's augmentation stays
  ``aug[2]``); D's update is the sequential one bit for bit. On a step
  that updates G with one microbatch the D phase runs that G forward with
  autograd on, gives D the detached images and hands the graph to the G
  phase, which runs no G forward of its own; with accumulation each
  microbatch's G phase recomputes it from ``StepDraws.d``.
* ``loss.fused_g_step`` (the JAX package's ``step_fused``): one objective
  d_loss + penalty + g_loss (+ path length) gives both networks'
  gradients, G scored against the pre-update D; then both Adam steps,
  the G-EMA and the w-average. The fakes come from ``StepDraws.d`` and
  under augmentation take ``aug[1]`` once for both losses (the reals
  ``aug[0]``); ``StepDraws.g`` and ``aug[2]`` are drawn and not read. One
  D forward of the attached fakes serves both losses: D's gradient is
  taken over D's parameters with the graph kept, then G's over G's, so
  neither loss reaches the other network. Refused with accumulation and
  with n-critic.

``draw_step`` draws every field under every recipe, in the same order, so
one seed gives one stream whatever the recipe. Entry:
``create_train_state`` -> ``make_lazy_stepper(cfg, phase)`` ->
``stepper(state, real_u8)``, where ``real_u8`` holds A microbatches; or
``make_chunked_stepper(cfg, phase)`` -> ``stepper(state, stack)`` over a
lazy-regularization cycle of stacked batches, its off-run a CUDA graph on
a card (``train/graphs.py``). So that a graph can hold a step, the step
updates the state's tensors in place (``pl_mean`` and ``ada_p`` too),
makes its float32 constants on the device at its first call, and takes
alpha and the G-EMA's beta as tensors where they move (``step(...,
alpha=, beta=)``; the eager default reads the host's counters).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Sequence

import numpy as np
import torch

from ganlab_tpu_torch.config import Config
from ganlab_tpu_torch.models import is_style, noise_shapes
from ganlab_tpu_torch.models.stylegan import mix_styles, num_style_layers
from ganlab_tpu_torch.ops import losses as L
from ganlab_tpu_torch.ops.augment import (
    AugParams,
    apply_augment,
    sample_params,
)
from ganlab_tpu_torch.ops.layout import memory_format
from ganlab_tpu_torch.parallel import dist as pdist
from ganlab_tpu_torch.train.schedule import PhaseSpec
from ganlab_tpu_torch.train.state import (
    TrainState,
    graphs_capture,
    optimizer_hparams,
    seed_new_moments,
)
from ganlab_tpu_torch.utils.spans import span


def _dtype_of(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.run.compute_dtype)


def _moved(obj, device):
    """A copy of a draws dataclass with every tensor on ``device``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (torch.Tensor, AugParams)):
            v = v.to(device)
        elif isinstance(v, (list, tuple)):
            v = type(v)(t.to(device) for t in v)
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
    # when ``cfg.aug_active``: the reals', D's fakes' and G's fakes'
    aug: tuple[AugParams, AugParams, AugParams] | None = None

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
              device, aug_p=None) -> StepDraws:
    """All draws of one step, in a fixed order, from ``gen``. The
    path-length draws come next and only where ``cfg.pl_active`` (on every
    step, whether or not the term fires), then the three augmentations at
    strength ``aug_p`` (default ``aug.p_init``) only where
    ``cfg.aug_active``, so the streams of the other configurations stay as
    they were."""
    flip = torch.rand((batch,), generator=gen, device=device) < 0.5
    d = draw_generator(cfg, res_log2, batch, gen, device)
    gp_eps = torch.rand((batch, 1, 1, 1), generator=gen, device=device,
                        dtype=_dtype_of(cfg))
    g = draw_generator(cfg, res_log2, batch, gen, device)
    pl = draw_pl(cfg, res_log2, batch, gen, device) if cfg.pl_active \
        else None
    aug = None
    if cfg.aug_active:
        p = cfg.aug.p_init if aug_p is None else aug_p
        aug = tuple(sample_params(gen, batch, 2 ** res_log2, p,
                                  cfg.aug.categories, cfg.model.img_channels)
                    for _ in range(3))
    return StepDraws(flip, d, g, gp_eps, pl, aug)


def fork_generators(gen: torch.Generator, indices: Sequence[int],
                    device) -> list[torch.Generator]:
    """One generator on ``device`` per index, seeded from ``gen``'s state
    and the index; ``gen`` then advances by one draw. Every rank holds the
    same ``gen``, so each derives the same seeds and advances alike: the
    ranks' draws differ by index while their states stay identical. Reads
    the generator's state on the host (no device synchronization)."""
    base = hashlib.blake2b(gen.get_state().numpy().tobytes(),
                           digest_size=16).digest()
    gens = []
    for i in indices:
        seed = int.from_bytes(hashlib.blake2b(
            base + int(i).to_bytes(8, "little"), digest_size=8).digest(),
            "little") & (2 ** 63 - 1)
        gens.append(torch.Generator(device=device).manual_seed(seed))
    torch.randint(0, 2, (1,), generator=gen, device=gen.device)
    return gens


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
                beta) -> None:
    """ema <- ema * beta + model * (1 - beta), in place, parameter-wise,
    with beta and 1 - beta rounded to float32 as the JAX package does.
    ``beta`` is a number, or a 0-d float32 tensor on the parameters'
    device (``optim.ema_rampup``, whose beta moves every step: a CUDA
    graph reads it from the tensor at each replay)."""
    e = list(ema.parameters())
    p = [t.to(x.dtype) for t, x in zip(model.parameters(), e)]
    if isinstance(beta, torch.Tensor):
        torch._foreach_mul_(e, beta)
        torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - beta))
        return
    b = torch.tensor(beta, dtype=torch.float32)
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
    if lc.fused_g_step and cfg.optim.grad_accum > 1:
        raise ValueError(
            "optim.grad_accum > 1 requires a sequential recipe "
            "(loss.fused_g_step=False; fused_seq is supported)")
    if lc.fused_g_step and lc.d_steps_per_g > 1:
        raise ValueError("loss.fused_g_step requires d_steps_per_g == 1")
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
                        fade: bool = False, mean_over: Callable = None):
    """(penalty, new pl_mean, lengths) of path-length regularization
    (StyleGAN2 app. B): lengths |J_w^T y| of the synthesis at the mapped
    ``dr.z`` with the noise ``dr.noises`` against the projection ``dr.y``,
    the running mean moved toward their mean by ``decay`` (detached), and
    ``weight * mean((length - new mean)^2)``. ``mean_over`` maps the batch
    mean of the lengths to its mean over the data-parallel replicas
    before the running mean takes it (``parallel.dist.mean``), so that
    ``pl_mean`` stays the same on every replica.

    The gradient with respect to the per-layer styles keeps its graph, and
    the styles stay attached to the mapping network, so the penalty's
    gradient reaches every layer of G, the mapping layers too.

    The projection enters as the image's output gradient, ``dr.y`` cast to
    the image's dtype and memory layout: the values that the gradient of
    ``sum(img.float() * dr.y)`` gives it, in the layout the synthesis's
    backward runs in."""
    w = g.map_latents(dr.z)
    ws = w[:, None, :].repeat(1, num_style_layers(res_log2), 1)
    img = g.synthesize(ws, res_log2, alpha, dr.noises, fade=fade)
    y = dr.y.to(img.dtype, memory_format=memory_format(img))
    (gw,) = torch.autograd.grad(img, ws, grad_outputs=y, create_graph=True)
    pl_len = gw.float().square().sum(dim=2).mean(dim=1).sqrt()
    len_mean = pl_len.mean().detach()
    if mean_over is not None:
        len_mean = mean_over(len_mean)
    new_mean = (pl_mean + decay * (len_mean - pl_mean)).detach()
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
    device; ``real_u8`` (``optim.grad_accum`` microbatches, one after the
    other along the batch axis) and injected ``draws`` (a ``StepDraws``,
    or one a microbatch) are moved there. The
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
    # two D updates on a penalty step: the main loss, then the penalty
    reg_separate = lc.reg_separate and has_penalty
    pen_weight = lc.penalty_weight * (
        lc.penalty_every if penalty_override is True else 1)
    fade = phase.kind == "fade"
    style = is_style(cfg.model)
    n_critic = max(1, lc.d_steps_per_g)
    w_beta = torch.tensor(cfg.model.w_avg_beta, dtype=torch.float32)
    with_pl = cfg.pl_active if pl_override is None else pl_override
    pl_weight = lc.pl_weight * (lc.pl_every if pl_override is True else 1)
    accum = cfg.optim.grad_accum
    aug_active, ada_active, ac = cfg.aug_active, cfg.ada_active, cfg.aug
    # chained once a microbatch: (1 - decay)^A = 1 - pl_decay per step
    pl_decay = lc.pl_decay if accum == 1 \
        else 1.0 - (1.0 - lc.pl_decay) ** (1.0 / accum)

    def ema_beta(batch: int, shown: int) -> float:
        """From the global batch: with ``ema_kimg`` the horizon is the
        same whatever the batch, accumulation and replica count."""
        o = cfg.optim
        if o.ema_rampup is not None:
            nimg = min(o.ema_kimg * 1000.0, shown * o.ema_rampup)
            return 0.5 ** (batch / max(nimg, 1.0))
        return o.ema_beta_for(batch)

    # float32 constants on the state's device, made at a step's first
    # call (eager: a CUDA graph captures no copy from the host)
    on_device: dict = {}

    def w_beta_on(dev) -> torch.Tensor:
        if dev not in on_device:
            on_device[dev] = w_beta.to(dev)
        return on_device[dev]

    def penalty_term(d, real, fake, draws, real_s, alpha, reg=True):
        """R1 or WGAN-GP at ``pen_weight`` where ``reg``, plus drift
        where ``real_s`` (the real scores) is given."""
        penalty = torch.zeros((), device=real.device)
        if reg:
            def critic(x):
                return d(x, res_log2, alpha, fade).float()

            if lc.penalty == "wgan-gp":
                penalty = L.wgan_gp(critic, real, fake, None, pen_weight,
                                    eps=draws.gp_eps)
            else:
                penalty = L.r1_penalty(critic, real, pen_weight)
        if lc.drift_weight and real_s is not None:
            penalty = penalty + L.drift_penalty(real_s, lc.drift_weight)
        return penalty

    def set_hparams(opt, hp):
        for group in opt.param_groups:
            group.update(hp)

    def step_draws(state, micro, world, rank, draws):
        """The A microbatches' draws: injected (one StepDraws, or one a
        microbatch), or drawn (module docstring, Randomness)."""
        dev = state.device
        if draws is not None:
            draws = [draws] if isinstance(draws, StepDraws) else list(draws)
            if len(draws) != accum:
                raise ValueError(f"draws: {accum} microbatches take "
                                 f"{accum} StepDraws, got {len(draws)}")
            if aug_active and any(d.aug is None for d in draws):
                raise ValueError("aug.mode: the step needs StepDraws.aug")
            return [d.to(dev) for d in draws]
        p = state.ada_p if ada_active else None     # None: aug.p_init
        if accum == 1 and world == 1:
            return [draw_step(cfg, res_log2, micro, state.generator, dev, p)]
        gens = fork_generators(state.generator,
                               [rank * accum + j for j in range(accum)], dev)
        return [draw_step(cfg, res_log2, micro, gen, dev, p) for gen in gens]

    def ada_p_after(state, rt, batch: int) -> torch.Tensor:
        """p moved toward the target by the global batch's step, clipped
        (float32 throughout, as the JAX package's ``ada_update``)."""
        rate = float(np.float32(batch) / np.float32(ac.kimg * 1000.0))
        return (state.ada_p + torch.sign(rt - ac.target) * rate).clamp(
            0.0, ac.p_max)

    def averaged(values):
        """The mean of one value per microbatch (the value itself for
        one)."""
        return values[0] if accum == 1 else torch.stack(values).mean(dim=0)

    def finish_grads(module):
        """Sum over microbatches -> mean, then the mean over replicas."""
        if accum > 1:
            torch._foreach_div_([p.grad for p in module.parameters()
                                 if p.grad is not None], float(accum))
        pdist.all_reduce_grads_(module)

    def update_d(state, count: int) -> None:
        """One Adam step of D on its summed gradients; ``count`` is the
        Adam count of a parameter that has no moments yet (D's updates
        since the moments began)."""
        finish_grads(state.d)
        set_hparams(state.opt_d, hp_d)
        seed_new_moments(state.opt_d, count)
        state.opt_d.step()

    def update_g(state) -> None:
        finish_grads(state.g)
        set_hparams(state.opt_g, hp_g)
        # G's Adam count: the G updates since the moments began
        seed_new_moments(state.opt_g, state.step // n_critic
                         - state.opt_step0 // n_critic)
        state.opt_g.step()

    @torch.no_grad()
    def ema_and_w_avg(state, w_means, batch: int, beta=None) -> None:
        """``beta``: the G-EMA's beta as a 0-d tensor (a CUDA graph's
        input), or None to take it from the host's counters; under
        ``optim.ema_rampup`` it is a tensor either way."""
        if beta is None:
            beta = ema_beta(batch, state.shown_imgs)
            if cfg.optim.ema_rampup is not None:
                beta = torch.full((), beta, dtype=torch.float32,
                                  device=state.device)
        _ema_update(state.g_ema, state.g, beta)
        if style:
            w_mean = pdist.mean(averaged(w_means))
            wb = w_beta_on(state.device)
            state.w_avg.copy_(state.w_avg * wb + w_mean * (1.0 - wb))

    def finish(state, batch: int, alpha, d_parts, g_loss, pl_pens, ada):
        """Counters, the metrics (averaged over the replicas) and ADA's
        p; ``d_parts`` is (d_loss, penalty, real score, fake score),
        ``ada`` (new p, rt) under ``aug.mode=ada``."""
        dev = state.device
        state.step += 1
        state.shown_imgs += batch
        d_loss, penalty, real_score, fake_score = d_parts
        metrics = {"d_loss": d_loss,
                   "g_loss": torch.zeros((), device=dev) if g_loss is None
                   else g_loss,
                   "penalty": penalty, "real_score": real_score,
                   "fake_score": fake_score, "alpha": alpha}
        if cfg.pl_active:
            # only path-length configurations carry the metric, as in JAX
            metrics["pl_penalty"] = averaged(pl_pens) if pl_pens \
                else torch.zeros((), device=dev)
        pdist.all_reduce_mean_(v for k, v in metrics.items() if k != "alpha")
        if ada_active:
            # only ADA configurations; both are the same on every replica.
            # p moves in place: a CUDA graph's next replay reads it there
            new_p, metrics["aug_rt"] = ada
            state.ada_p.copy_(new_p)
            metrics["aug_p"] = new_p
        return state, metrics

    def run_step(state: TrainState, real_u8: torch.Tensor, draws=None,
                 alpha=None, beta=None):
        dev = state.device
        world, rank = pdist.world_size(), pdist.rank()
        total = real_u8.shape[0]
        if total % accum:
            raise ValueError(f"optim.grad_accum={accum}: a batch of {total} "
                             "does not split into equal microbatches")
        micro = total // accum
        draws = step_draws(state, micro, world, rank, draws)
        if alpha is None:
            alpha = phase_alpha(phase, state.shown_imgs, dtype)
        real_u8 = real_u8.to(dev)
        if lc.fused_g_step:
            return fused_step(state, real_u8, draws[0], alpha, micro * world,
                              beta)
        g, d = state.g, state.d
        do_g = state.step % n_critic == n_critic - 1
        # loss.fused_seq on a step that updates G with one microbatch: the
        # D phase's G forward keeps its graph and is the G phase's too
        share = lc.fused_seq and do_g and accum == 1
        shared, reg_inputs = None, None

        # -- D step: A microbatches' gradients summed, then averaged -------
        state.opt_d.zero_grad(set_to_none=True)
        parts, rts = [], []
        for j, dr in enumerate(draws):
            real = _preprocess(real_u8[j * micro:(j + 1) * micro],
                               cfg.data.hflip, dr.flip, dtype)
            with torch.set_grad_enabled(share):
                fake, w_mean = gen_forward(g, dr.d, alpha, fade)
            if share:
                shared = (fake, w_mean)
            with torch.no_grad():
                fake_d = fake.detach()
                if aug_active:
                    # D sees only augmented images, in the loss and the
                    # penalty
                    real = apply_augment(real, dr.aug[0])
                    fake_d = apply_augment(fake_d, dr.aug[1])
            real_s = d(real, res_log2, alpha, fade).float()
            fake_s = d(fake_d, res_log2, alpha, fade).float()
            d_loss = d_loss_fn(real_s, fake_s)
            penalty = penalty_term(d, real, fake_d, dr, real_s, alpha,
                                   reg=with_penalty and not reg_separate)
            (d_loss + penalty).backward()
            parts.append((d_loss.detach(), penalty.detach(),
                          real_s.detach().mean(), fake_s.detach().mean()))
            if ada_active:
                rts.append(torch.sign(real_s.detach()).mean())
            if reg_separate and with_penalty:     # one microbatch
                reg_inputs = (real, fake_d, dr)
            del real, fake, fake_d, real_s, fake_s
        count = state.step - state.opt_step0
        if reg_separate:
            count += penalty_ticks(cfg, state.opt_step0, state.step)
        update_d(state, count)
        d_parts = [averaged(list(v)) for v in zip(*parts)]
        if reg_inputs is not None:
            # Dreg: the penalty alone, at the post-main weights, on the
            # main pass's reals, fakes and interpolation draws, through
            # the same Adam (a second count on this step). Gradients are
            # zeroed, not dropped: a parameter the penalty does not reach
            # (D's output bias) takes a zero gradient and its Adam step,
            # as optax steps every leaf of the tree
            real, fake_d, dr = reg_inputs
            state.opt_d.zero_grad(set_to_none=False)
            penalty = penalty_term(d, real, fake_d, dr, None, alpha)
            penalty.backward()
            update_d(state, count + 1)
            d_parts[1] = penalty.detach()
            del reg_inputs, real, fake_d, penalty
        ada = None
        if ada_active:
            rt = pdist.mean(averaged(rts))
            ada = (ada_p_after(state, rt, micro * accum * world), rt)

        # -- G step, against the updated D (every n-th step with n-critic)
        g_loss, pl_pens = None, []
        if do_g:
            pl_mean, g_losses, w_means = state.pl_mean, [], []
            d.requires_grad_(False)
            try:
                state.opt_g.zero_grad(set_to_none=True)
                for dr in draws:
                    if shared is not None:
                        (fake, w_mean), shared = shared, None
                    else:
                        fake, w_mean = gen_forward(
                            g, dr.d if lc.fused_seq else dr.g, alpha, fade)
                    if aug_active:      # the gradient flows through into G
                        fake = apply_augment(fake, dr.aug[2])
                    g_loss = g_loss_fn(d(fake, res_log2, alpha, fade).float())
                    objective = g_loss
                    if with_pl:
                        if dr.pl is None:
                            raise ValueError("a path-length step needs "
                                             "StepDraws.pl")
                        pl_pen, pl_mean, _ = path_length_penalty(
                            g, pl_mean, dr.pl, res_log2, alpha,
                            weight=pl_weight, decay=pl_decay, fade=fade,
                            mean_over=pdist.mean)
                        objective = g_loss + pl_pen
                        pl_pens.append(pl_pen.detach())
                    objective.backward()
                    g_losses.append(g_loss.detach())
                    w_means.append(w_mean)
                    del fake, objective
            finally:
                d.requires_grad_(True)
            update_g(state)
            if with_pl:
                # in place, as ada_p: a CUDA graph's next replay reads it
                state.pl_mean.copy_(pl_mean)
            g_loss = averaged(g_losses)
            ema_and_w_avg(state, w_means, micro * accum * world, beta)
        return finish(state, micro * accum * world, alpha, d_parts, g_loss,
                      pl_pens, ada)

    def fused_step(state, real_u8, dr: StepDraws, alpha, batch: int,
                   beta):
        """``loss.fused_g_step`` (the JAX package's ``step_fused``): one
        objective d_loss + penalty + g_loss (+ path length) gives both
        networks' gradients, G scored against the pre-update D; then both
        Adam steps, the G-EMA and the w-average."""
        g, d = state.g, state.d
        state.opt_d.zero_grad(set_to_none=True)
        state.opt_g.zero_grad(set_to_none=True)
        real = _preprocess(real_u8, cfg.data.hflip, dr.flip, dtype)
        fake, w_mean = gen_forward(g, dr.d, alpha, fade)
        if aug_active:
            with torch.no_grad():
                real = apply_augment(real, dr.aug[0])
            # one draw for the fakes, shared by D's loss and G's
            fake = apply_augment(fake, dr.aug[1])
        real_s = d(real, res_log2, alpha, fade).float()
        # one D forward of the fakes serves both losses: D's gradient and
        # G's are taken over disjoint parameter sets, so the D loss puts
        # nothing into G and the G loss nothing into D
        fake_s = d(fake, res_log2, alpha, fade).float()
        d_loss = d_loss_fn(real_s, fake_s)
        penalty = penalty_term(d, real, fake.detach(), dr, real_s, alpha,
                               reg=with_penalty)
        g_loss = g_loss_fn(fake_s)
        g_objective, pl_pens = g_loss, []
        if with_pl:
            if dr.pl is None:
                raise ValueError("a path-length step needs StepDraws.pl")
            pl_pen, pl_mean, _ = path_length_penalty(
                g, state.pl_mean, dr.pl, res_log2, alpha, weight=pl_weight,
                decay=pl_decay, fade=fade, mean_over=pdist.mean)
            g_objective = g_loss + pl_pen
            pl_pens.append(pl_pen.detach())
        torch.autograd.backward(d_loss + penalty, inputs=list(d.parameters()),
                                retain_graph=True)
        g_objective.backward(inputs=list(g.parameters()))
        d_parts = (d_loss.detach(), penalty.detach(),
                   real_s.detach().mean(), fake_s.detach().mean())
        ada = None
        if ada_active:
            rt = pdist.mean(torch.sign(real_s.detach()).mean())
            ada = (ada_p_after(state, rt, batch), rt)
        del real, fake, real_s, fake_s, g_objective
        update_d(state, state.step - state.opt_step0)
        update_g(state)
        if with_pl:
            state.pl_mean.copy_(pl_mean)
        ema_and_w_avg(state, [w_mean], batch, beta)
        return finish(state, batch, alpha, d_parts, g_loss.detach(), pl_pens,
                      ada)

    span_name = "step.reg" if with_penalty else \
        "step.pl" if with_pl else "step.plain"

    def step(state: TrainState, real_u8: torch.Tensor, draws=None,
             alpha=None, beta=None):
        """``alpha`` / ``beta``: the fade-in weight (compute dtype) and the
        G-EMA's beta (float32) as 0-d tensors on the device, which a
        CUDA graph of the step reads at each replay; None (the eager
        default) takes them from the host's counters."""
        with span(span_name):
            return run_step(state, real_u8, draws, alpha, beta)

    step.pen_weight = pen_weight if with_penalty else 0.0
    step.pl_weight = pl_weight if with_pl else 0.0
    # what a CUDA graph of the step takes from its inputs at each replay
    # (train/graphs.py): alpha in a fade phase, beta under ema_rampup, and
    # the host's values of both for a step that starts at ``shown``
    step.alpha_moves = fade
    step.beta_moves = cfg.optim.ema_rampup is not None
    step.compute_dtype = dtype
    step.scalars = lambda shown, batch: (phase_alpha(phase, shown, dtype),
                                         ema_beta(batch, shown))
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


def penalty_ticks(cfg: Config, start: int, stop: int) -> int:
    """How many of the step indices [start, stop) the lazy dispatch runs
    with the D penalty on (``_lazy_combos``: every step with
    ``penalty_every`` <= 1, every k-th from 0 otherwise)."""
    lc = cfg.loss
    if lc.penalty not in ("wgan-gp", "r1") or stop <= start:
        return 0
    k = lc.penalty_every
    if k <= 1:
        return stop - start
    return -(-stop // k) + (-start // k)     # ceil(stop/k) - ceil(start/k)


def _program_cache(cfg: Config, phase: PhaseSpec):
    """``get(dpen, pl)``: the step function of one pair of overrides,
    built at its first request; ``get.programs`` maps each pair built."""
    cache: dict = {}

    def get(dpen, pl):
        if (dpen, pl) not in cache:
            cache[(dpen, pl)] = build_train_step(
                cfg, phase, penalty_override=dpen, pl_override=pl)
        return cache[(dpen, pl)]

    get.programs = cache
    return get


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
    get = _program_cache(cfg, phase)
    if not lazy:
        return get(*combo_at(0))

    counter = {"i": int(initial_step)}

    def stepper(state, real_u8, draws=None):
        fn = get(*combo_at(counter["i"]))
        counter["i"] += 1
        return fn(state, real_u8, draws)

    stepper.programs = get.programs
    return stepper


def stack_metrics(ms: Sequence[dict], device) -> dict[str, torch.Tensor]:
    """Per-step metrics in step order -> one (n,) float32 tensor a key on
    ``device`` (a number, as a stabilize phase's alpha, becomes a fill)."""
    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.full((), float(v), dtype=torch.float32, device=device)

    return {k: torch.stack([f32(m[k]) for m in ms]) for k in ms[0]}


def run_steps(fn: Callable, state: TrainState, stack: torch.Tensor,
              draws=None, alphas=None, betas=None):
    """``fn`` over the batches of ``stack`` in turn: (state, stacked
    metrics). ``draws`` / ``alphas`` / ``betas`` hold one entry a step, or
    are None (the step's own draws; the host's alpha and beta)."""
    ms = []
    for j in range(stack.shape[0]):
        state, m = fn(state, stack[j], None if draws is None else draws[j],
                      alpha=None if alphas is None else alphas[j],
                      beta=None if betas is None else betas[j])
        ms.append(m)
    return state, stack_metrics(ms, state.device)


def make_chunked_stepper(cfg: Config, phase: PhaseSpec,
                         initial_step: int = 0):
    """Chunked lazy-regularization stepper: ``(stepper, k)``, k =
    ``loss.penalty_every``. Port of the JAX package's
    ``make_chunked_stepper``.

    ``stepper(state, stack, draws=None) -> (state, metrics)`` takes a
    (<= k, B, H, W, C) uint8 stack (``draws``: one ``StepDraws`` a batch,
    for parity tests) and returns each metric stacked (n_consumed,) in step
    order as float32: the caller reads the consumed count from their
    length. On an aligned full cycle (the step counter at a multiple of k
    and k batches) the cycle-head step (the D penalty, and path length
    where it fires) runs through the lazy dispatcher's step functions,
    then the off-run: the k - 1 steps on which nothing fires, or with lazy
    path length (``pl_every`` dividing k) a segment of ``pl_every`` - 1
    such steps after each path-length step. At a misaligned counter
    (a resume, or a phase that starts mid-cycle) it runs only the steps
    that realign it and drops the rest of the stack; a partial stack runs
    step by step.

    The off-run is the step function of the lazy dispatcher's "nothing
    fires" variant. Where ``state.graphs_capture`` holds (a CUDA state,
    ``run.chunk_steps``, one process, ``optim.grad_accum`` = 1) and with
    the step's own draws, each off-run
    variant (its length and, with n-critic, its pattern of G updates) is
    a CUDA graph of those steps (``train/graphs.py``): the first aligned
    cycle of the phase runs eagerly (the warm-up), each later cycle
    replays, one launch a segment; a capture that fails raises. On the
    CPU, with ``run.chunk_steps=False``, with accumulation, under data
    parallelism (the gloo and NCCL all-reduces, and ``fork_generators``,
    which reads the generator on the host) and with injected draws, the
    off-run is the same steps run one after another. ``stepper.graphs``
    is the ``OffRunGraphs`` once made (None before); ``stepper.close()``
    releases the graphs.
    """
    lc = cfg.loss
    k = lc.penalty_every
    if lc.penalty not in ("wgan-gp", "r1") or k <= 1:
        raise ValueError("chunked stepping needs lazy regularization: "
                         "loss.penalty r1 or wgan-gp with penalty_every > 1")
    if cfg.pl_active and lc.pl_every > 1:
        if k % lc.pl_every:
            raise ValueError("chunked stepping with lazy path length needs "
                             "loss.pl_every to divide loss.penalty_every")
        seg = lc.pl_every - 1
    else:
        seg = k - 1
    combo_at, _ = _lazy_combos(cfg)
    get = _program_cache(cfg, phase)
    # index 1 of a cycle is always an off-step (k > 1, pl_every > 1)
    off_fn = get(*combo_at(1))
    n_critic = max(1, lc.d_steps_per_g)
    counter = {"i": int(initial_step)}
    warm: set = set()       # off-run variants an eager aligned cycle ran

    def graphable(state, draws) -> bool:
        return draws is None and graphs_capture(cfg, state.device)

    def off_run(state, stack, draws, seen: set):
        if not graphable(state, draws):
            return run_steps(off_fn, state, stack, draws)
        if stepper.graphs is None:
            from ganlab_tpu_torch.train.graphs import OffRunGraphs

            stepper.graphs = OffRunGraphs(state.device, off_fn)
        key = (stack.shape[0], tuple(
            (state.step + j) % n_critic == n_critic - 1
            for j in range(stack.shape[0])))
        if key in warm:
            return stepper.graphs.replay(key, state, stack)
        seen.add(key)
        return stepper.graphs.warm_up(state, stack)

    def stepper(state, stack, draws=None):
        with span("train.chunk"):
            return chunk(state, stack, draws)

    def chunk(state, stack, draws):
        n = stack.shape[0]
        if draws is not None and len(draws) < n:
            raise ValueError(f"draws: {n} batches take {n} StepDraws, got "
                             f"{len(draws)}")
        parts = []

        def single(i):
            nonlocal state
            state, m = get(*combo_at(counter["i"]))(
                state, stack[i], None if draws is None else draws[i])
            counter["i"] += 1
            parts.append(stack_metrics([m], state.device))

        pos = counter["i"] % k
        if pos == 0 and n == k:
            seen: set = set()
            for head in range(0, k, seg + 1):
                single(head)
                lo, hi = head + 1, head + 1 + seg
                state, m = off_run(state, stack[lo:hi],
                                   None if draws is None else draws[lo:hi],
                                   seen)
                counter["i"] += seg
                parts.append(m)
            warm.update(seen)
        else:
            # realign: only the steps up to the next cycle head (the
            # stack's rest is dropped); a partial stack step by step
            for i in range(min(n, k - pos) if pos else n):
                single(i)
        return state, {key: torch.cat([p[key] for p in parts])
                       for key in parts[0]}

    def close():
        if stepper.graphs is not None:
            stepper.graphs.close()
            stepper.graphs = None
            warm.clear()        # a new stream warms up again

    stepper.graphs = None
    stepper.close = close
    return stepper, k

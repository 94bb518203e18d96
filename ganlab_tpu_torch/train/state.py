"""The training state: G, D, G-EMA, two Adams, w-average, counters, RNG.

Port of ``ganlab_tpu/train/state.py``, for every ported family (ResNet-GAN,
ProGAN, StyleGAN, StyleGAN2). The JAX package keeps an immutable
pytree that a jitted step maps to a new one; here ``TrainState`` holds the
modules and optimizers, and a step updates them in place and returns the
same object. Parameters stay float32; every random draw of a step comes
from the state's own ``torch.Generator`` on the state's device.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ganlab_tpu_torch.config import Config
from ganlab_tpu_torch.models import build_models
from ganlab_tpu_torch.parallel import dist as pdist


@dataclasses.dataclass
class TrainState:
    g: torch.nn.Module              # the generator of any family
    d: torch.nn.Module
    g_ema: torch.nn.Module          # no grad; updated by the step
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    w_avg: torch.Tensor             # (latent_dim,) float32 running W mean
                                    # (kept, and left at 0, for the
                                    # families without a mapping network)
    generator: torch.Generator      # the step's random draws
    step: int = 0                   # optimizer-step counter
    shown_imgs: int = 0             # images shown so far
    opt_step0: int = 0              # ``step`` when the Adam moments were
                                    # last (re)initialized
    pl_mean: torch.Tensor | None = None  # () float32 running mean of the
                                    # path lengths when ``cfg.pl_active``
    ada_p: torch.Tensor | None = None  # () float32 augmentation strength
                                    # when ``cfg.ada_active``

    @property
    def device(self) -> torch.device:
        return self.w_avg.device


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor and counter of the state, by name: the parameters of G,
    D and G-EMA, each parameter's Adam state, the w-average, the path-length
    mean and the augmentation strength (when the state has them), the
    generator's state and the counters.
    Two states are the same training run at the same point exactly when
    these agree."""
    out = {"w_avg": state.w_avg, "generator": state.generator.get_state(),
           "counters": torch.tensor([state.step, state.shown_imgs,
                                     state.opt_step0])}
    if state.pl_mean is not None:
        out["pl_mean"] = state.pl_mean
    if state.ada_p is not None:
        out["ada_p"] = state.ada_p
    for net in ("g", "d", "g_ema"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v
    for name, net in (("opt_g", state.g), ("opt_d", state.d)):
        opt = getattr(state, name)
        for pname, p in net.named_parameters():
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{pname}.{k}"] = v
    return out


def optimizer_hparams(cfg: Config, resolution: int | None = None
                      ) -> tuple[dict, dict]:
    """Adam hyperparameters (lr, betas, eps) of G and of D.

    ``resolution`` applies the per-phase lr multiplier
    (``optim.lr_mult_by_res``). Lazy-regularization compensation (official
    StyleGAN2 ``training_loop.py``): a network whose regularizer runs every
    k-th step trains with lr * k/(k+1) and betas ** (k/(k+1)); D takes k
    from ``loss.penalty_every``, G from ``loss.pl_every`` when path-length
    regularization is on. ``optim.lazy_adjust=False`` keeps the raw values.
    """
    o, lc = cfg.optim, cfg.loss

    def ratio(active: bool, k: int) -> float:
        return k / (k + 1.0) if (o.lazy_adjust and active and k > 1) else 1.0

    mb_d = ratio(lc.penalty in ("wgan-gp", "r1"), lc.penalty_every)
    mb_g = ratio(cfg.pl_active, lc.pl_every)
    mult = o.lr_mult_by_res.get(resolution, 1.0) if resolution else 1.0

    def hp(lr, mb):
        return dict(lr=lr * mult * mb, betas=(o.beta1 ** mb, o.beta2 ** mb),
                    eps=o.eps)

    return hp(o.lr_g, mb_g), hp(o.lr_d, mb_d)


def make_optimizers(cfg: Config, g: torch.nn.Module, d: torch.nn.Module,
                    resolution: int | None = None
                    ) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    """The Adam pair of ``optimizer_hparams``.

    torch's Adam steps by lr * m_hat / (sqrt(v_hat) + eps) with the bias
    corrections m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t): the update
    of ``optax.adam`` term for term (tests/test_torch_train_step.py holds
    the two against each other on the same gradients).

    Where the chunked stepper will replay its off-runs as CUDA graphs
    (``graphs_capture``) both are ``capturable``, so that a graph can hold
    their steps: the step counts then live on the card and the bias
    corrections are computed there in float32, where the default Adam
    takes them in Python doubles. The eager steps and the graphed ones
    share these optimizers, so their arithmetic is the same. Everywhere
    else (the CPU, ProGAN's and ResNet-GAN's every-step penalties,
    ``run.chunk_steps=False``, accumulation, data parallelism) Adam stays
    the default one, whose eager step issues fewer kernels.
    """
    hp_g, hp_d = optimizer_hparams(cfg, resolution)
    opts = (torch.optim.Adam(g.parameters(), **hp_g),
            torch.optim.Adam(d.parameters(), **hp_d))
    device = next(d.parameters()).device
    for opt in opts:
        fit_optimizer(opt, graphs_capture(cfg, device))
    return opts


def graphs_capture(cfg: Config, device: torch.device) -> bool:
    """Whether the chunked stepper replays the off-runs of a state of
    ``cfg`` on ``device`` as CUDA graphs: chunked stepping on
    (``Config.chunking``), a card, one process and no accumulation (the
    all-reduces and ``fork_generators`` read the host)."""
    return (torch.device(device).type == "cuda" and cfg.chunking
            and cfg.optim.grad_accum == 1 and pdist.world_size() == 1)


def fit_optimizer(opt: torch.optim.Adam, capturable: bool) -> None:
    """Set ``opt``'s ``capturable`` flag and put each parameter's step
    count where that asks: float32 on the parameter's device when
    capturable, on the host otherwise. Called when the optimizers are made
    and after a state dict is loaded into them (``load_state_dict`` takes
    the flag from the saved groups, so a checkpoint written by a graphed
    run would otherwise carry it to the CPU, and one written on the CPU
    would drop it on the card)."""
    for group in opt.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            st = opt.state.get(p)
            if st is not None and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if capturable else "cpu",
                    dtype=torch.float32)


def step_count(opt: torch.optim.Adam, p: torch.nn.Parameter,
               count: int) -> torch.Tensor:
    """A parameter's Adam step count ``count`` as ``opt`` keeps it."""
    group = next(g for g in opt.param_groups
                 if any(q is p for q in g["params"]))
    # a fill, not a copy from the host: no wait for the card's queue
    return torch.full((), float(count), dtype=torch.float32,
                      device=p.device if group["capturable"] else "cpu")


def seed_new_moments(opt: torch.optim.Adam, count: int) -> None:
    """Give every parameter that has a gradient but no Adam state yet zero
    moments and the step count ``count`` (optimizer steps since the moments
    were initialized). torch's Adam counts steps per parameter from its
    first gradient; the JAX package's optax Adam keeps one count for the
    whole tree, so a head or block that a progressive phase switches on
    late is bias-corrected there with the run's count, not with 1. Called
    before ``opt.step()``, it makes the two agree."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is not None and p not in opt.state:
                opt.state[p] = {
                    "step": step_count(opt, p, count),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}


def reset_moments(state: TrainState) -> None:
    """Drop both optimizers' moments and restart their step count, as
    ``optim.reset_moments_on_phase`` does at a phase boundary."""
    state.opt_g.state.clear()
    state.opt_d.state.clear()
    state.opt_step0 = state.step


def create_train_state(cfg: Config, seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """Every resolution's parameters up front, initialized from ``seed``
    (on the CPU, so a seed gives the same weights on every device), then
    moved to ``device``; the step's generator is seeded from ``seed`` too.
    ``pl_mean`` is a float32 zero where path-length regularization is
    configured (``cfg.pl_active``), and ``ada_p`` a float32 ``aug.p_init``
    where adaptive augmentation is (``cfg.ada_active``), else None, as in
    the JAX package."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_train_state: device 'cuda' requested but "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' to train on the CPU")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g, d = build_models(cfg.model)
    g, d = g.to(device), d.to(device)
    g_ema = copy.deepcopy(g).requires_grad_(False)
    opt_g, opt_d = make_optimizers(cfg, g, d)
    return TrainState(
        g=g, d=d, g_ema=g_ema, opt_g=opt_g, opt_d=opt_d,
        w_avg=torch.zeros(cfg.model.latent_dim, device=device),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        pl_mean=torch.zeros((), device=device) if cfg.pl_active else None,
        ada_p=torch.tensor(cfg.aug.p_init, dtype=torch.float32,
                           device=device) if cfg.ada_active else None)

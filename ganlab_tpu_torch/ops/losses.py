"""GAN losses and gradient penalties.

Port of ``ganlab_tpu/ops/losses.py``. Each d_loss takes (real_scores,
fake_scores), each g_loss fake_scores; scores are float32 (N,). The
penalties differentiate the critic with respect to its input images with
``torch.autograd.grad(..., create_graph=True)``, so the penalty's own
gradient with respect to the critic's parameters is the double backward.
As in the JAX package, the gradient of the summed critic output keeps the
cross-example coupling that minibatch-stddev introduces.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Critic = Callable[[torch.Tensor], torch.Tensor]  # images -> scores (N,)


def d_loss_wgan(real_scores, fake_scores):
    """Wasserstein critic loss: E[D(fake)] - E[D(real)]."""
    return fake_scores.mean() - real_scores.mean()


def g_loss_wgan(fake_scores):
    return -fake_scores.mean()


def d_loss_nonsaturating(real_scores, fake_scores):
    """-log sigmoid(D(real)) - log(1 - sigmoid(D(fake))), softplus form."""
    return F.softplus(-real_scores).mean() + F.softplus(fake_scores).mean()


def g_loss_nonsaturating(fake_scores):
    """-log sigmoid(D(fake)) (the 'non-saturating' generator loss)."""
    return F.softplus(-fake_scores).mean()


def d_loss_minimax(real_scores, fake_scores):
    """Original GAN discriminator loss (same as nonsaturating for D)."""
    return F.softplus(-real_scores).mean() + F.softplus(fake_scores).mean()


def g_loss_minimax(fake_scores):
    """Minimax generator loss: +log(1 - sigmoid(D(fake)))."""
    return -F.softplus(fake_scores).mean()


D_LOSSES = {
    "wgan": d_loss_wgan,
    "wgan-gp": d_loss_wgan,  # penalty added separately
    "nonsaturating": d_loss_nonsaturating,
    "minimax": d_loss_minimax,
}

G_LOSSES = {
    "wgan": g_loss_wgan,
    "wgan-gp": g_loss_wgan,
    "nonsaturating": g_loss_nonsaturating,
    "minimax": g_loss_minimax,
}


def _input_grad(critic: Critic, x: torch.Tensor) -> torch.Tensor:
    """d sum(critic(x)) / dx, kept in the graph for the double backward."""
    x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(x).sum(), x, create_graph=True)
    return grads


def wgan_gp(critic: Critic, real: torch.Tensor, fake: torch.Tensor,
            generator: torch.Generator | None = None,
            lambda_gp: float = 10.0,
            eps: torch.Tensor | None = None) -> torch.Tensor:
    """WGAN-GP (Gulrajani et al.): lambda * E[(||grad D(x_hat)|| - 1)^2].

    x_hat = eps*real + (1-eps)*fake with per-example eps ~ U[0, 1), drawn
    from ``generator`` unless given as ``eps`` (N, 1, 1, 1).
    """
    if eps is None:
        eps = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                         device=real.device, dtype=real.dtype)
    x_hat = eps * real + (1.0 - eps) * fake
    grads = _input_grad(critic, x_hat)
    g2 = grads.float().square().sum(dim=(1, 2, 3))
    norms = torch.sqrt(g2 + 1e-12)
    return lambda_gp * (norms - 1.0).square().mean()


def r1_penalty(critic: Critic, real: torch.Tensor,
               gamma: float = 10.0) -> torch.Tensor:
    """R1 (Mescheder et al.): gamma/2 * E[||grad D(real)||^2]."""
    grads = _input_grad(critic, real)
    g2 = grads.float().square().sum(dim=(1, 2, 3))
    return (gamma * 0.5) * g2.mean()


def drift_penalty(real_scores: torch.Tensor,
                  eps_drift: float = 1e-3) -> torch.Tensor:
    """ProGAN's drift term eps * E[D(real)^2] keeping scores near zero."""
    return eps_drift * real_scores.square().mean()

"""Return/advantage estimators: GAE, lambda-returns (counterpart of
`repro.rl.returns`), the "algorithm-specific terms" the paper's DataServer
computes before learning (§3.2 Learner).

Every estimator here is one instance of the reverse discounted recursion

    y_t = delta_t + decay_t * y_{t+1}

and routes through `repro_torch.kernels.dispatch.reverse_scan`: the CUDA
scan kernel over the whole (B, T) minibatch on the card, its plain loop on
the CPU.

Conventions: arrays are (B, T); `discounts` is gamma * (1 - done_t), zero
at episode boundaries; `bootstrap` is V(s_T) (B,).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def _next(values, bootstrap):
    """v_{t+1}: values shifted left by one, the bootstrap at T-1."""
    return torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)


def gae(rewards, values, discounts, bootstrap, lam=0.95):
    """Generalized Advantage Estimation. Returns (advantages, value_targets).

    adv_t = delta_t + (gamma_t * lam) adv_{t+1},
    delta_t = r_t + gamma_t V_{t+1} - V_t.
    """
    deltas = rewards + discounts * _next(values, bootstrap) - values
    advantages = dispatch.reverse_scan(deltas, discounts * lam)
    return advantages, advantages + values


def lambda_return(rewards, values, discounts, bootstrap, lam=0.95):
    """TD(lambda) targets: G_t = r_t + gamma [ (1-lam) V_{t+1} + lam G_{t+1} ],
    seeded at G_T = bootstrap."""
    deltas = rewards + discounts * (1.0 - lam) * _next(values, bootstrap)
    return dispatch.reverse_scan(deltas, discounts * lam, bootstrap)


def discounted_return(rewards, discounts, bootstrap):
    """Plain discounted Monte-Carlo return, seeded at the bootstrap value."""
    return dispatch.reverse_scan(rewards, discounts, bootstrap)

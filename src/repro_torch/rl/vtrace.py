"""V-trace (IMPALA) off-policy corrected targets [Espeholt et al. 2018]
(counterpart of `repro.rl.vtrace`), the paper's second proxy-RL algorithm.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.rl.returns import _next


def vtrace(behavior_logp, target_logp, rewards, values, discounts, bootstrap,
           *, lam=1.0, clip_rho=1.0, clip_c=1.0):
    """All per-step arrays (B, T); bootstrap (B,).

    Returns (vs, pg_advantages), both detached:
      rho_t = min(clip_rho, pi/mu);  c_t = lam * min(clip_c, pi/mu)
      delta_t = rho_t (r_t + gamma_t v_{t+1} - v_t)
      vs_t = v_t + delta_t + gamma_t c_t (vs_{t+1} - v_{t+1})
      adv_t = rho_t (r_t + gamma_t vs_{t+1} - v_t)

    The correction sum acc_t = vs_t - v_t satisfies the reverse discounted
    recursion acc_t = delta_t + (gamma_t c_t) acc_{t+1}, so it runs through
    the dispatch layer's (B, T) scan like GAE does.
    """
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp(rho, max=clip_rho)
    c = lam * torch.clamp(rho, max=clip_c)
    deltas = rho_c * (rewards + discounts * _next(values, bootstrap) - values)
    vs = values + dispatch.reverse_scan(deltas, discounts * c)
    pg_adv = rho_c * (rewards + discounts * _next(vs, bootstrap) - values)
    return vs.detach(), pg_adv.detach()

"""PPO-clip loss (counterpart of `repro.rl.ppo`; the paper's primary
proxy-RL, structure from openai/baselines' ppo2 as the paper did).

Every sum over the batch goes through `batch_sum`: inside a sharded step's
data-parallel scope it spans the data axes, so the advantage statistics
and the loss are the global batch's on every rank."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import batch_sum
from repro_torch.rl.distributions import categorical_entropy, categorical_kl, categorical_logp
from repro_torch.rl.returns import gae


@dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    clip_value: bool = True
    normalize_adv: bool = True
    teacher_kl_coef: float = 0.0   # KL(pi || teacher), paper §InfServer hook


def ppo_loss(logits, values, traj, hp: PPOConfig, teacher_logits=None):
    """logits: (B,T,A) fp32; values: (B,T) fp32.

    traj fields (B,T): actions, behavior_logp, behavior_values, rewards,
    discounts; bootstrap_value (B,); mask (B,T) valid steps.
    Returns (loss, metrics).
    """
    actions = traj["actions"]
    mask = traj.get("mask")
    if mask is None:
        mask = torch.ones_like(traj["rewards"])
    msum = torch.clamp(batch_sum(mask.sum()), min=1.0)

    logp = categorical_logp(logits, actions)
    ratio = torch.exp(logp - traj["behavior_logp"])

    adv, v_targ = gae(traj["rewards"], traj["behavior_values"], traj["discounts"],
                      traj["bootstrap_value"], lam=hp.lam)
    adv = adv.detach()
    v_targ = v_targ.detach()
    if hp.normalize_adv:
        mean = batch_sum((adv * mask).sum()) / msum
        var = batch_sum((torch.square(adv - mean) * mask).sum()) / msum
        adv = (adv - mean) * torch.rsqrt(var + 1e-8)

    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - hp.clip_eps, 1.0 + hp.clip_eps) * adv
    pg_loss = -batch_sum((torch.minimum(unclipped, clipped) * mask).sum()) / msum

    v_err = torch.square(values - v_targ)
    if hp.clip_value:
        v_clip = traj["behavior_values"] + torch.clamp(
            values - traj["behavior_values"], -hp.clip_eps, hp.clip_eps)
        v_err = torch.maximum(v_err, torch.square(v_clip - v_targ))
    v_loss = 0.5 * batch_sum((v_err * mask).sum()) / msum

    ent = batch_sum((categorical_entropy(logits) * mask).sum()) / msum
    loss = pg_loss + hp.value_coef * v_loss - hp.entropy_coef * ent

    metrics = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
               "ratio_mean": batch_sum((ratio * mask).sum()) / msum,
               "clip_frac": batch_sum((((ratio - 1.0).abs() > hp.clip_eps) * mask).sum()) / msum}
    if teacher_logits is not None and hp.teacher_kl_coef:
        kl = batch_sum((categorical_kl(logits, teacher_logits) * mask).sum()) / msum
        loss = loss + hp.teacher_kl_coef * kl
        metrics["teacher_kl"] = kl
    return loss, metrics

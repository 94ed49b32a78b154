"""V-trace actor-critic loss (counterpart of `repro.rl.vtrace_loss`; the
IMPALA learner, tleague.learners.VtraceLearner, loss structure from
deepmind/trfl as the paper did). Sums over the batch go through
`batch_sum`, as in `ppo`."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import batch_sum
from repro_torch.rl.distributions import categorical_entropy, categorical_logp
from repro_torch.rl.vtrace import vtrace


@dataclass(frozen=True)
class VTraceConfig:
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 1.0
    clip_rho: float = 1.0
    clip_c: float = 1.0


def vtrace_loss(logits, values, traj, hp: VTraceConfig):
    actions = traj["actions"]
    mask = traj.get("mask")
    if mask is None:
        mask = torch.ones_like(traj["rewards"])
    msum = torch.clamp(batch_sum(mask.sum()), min=1.0)

    logp = categorical_logp(logits, actions)
    vs, pg_adv = vtrace(traj["behavior_logp"], logp.detach(),
                        traj["rewards"], values, traj["discounts"],
                        traj["bootstrap_value"], lam=hp.lam,
                        clip_rho=hp.clip_rho, clip_c=hp.clip_c)
    pg_loss = -batch_sum((logp * pg_adv * mask).sum()) / msum
    v_loss = 0.5 * batch_sum((torch.square(values - vs) * mask).sum()) / msum
    ent = batch_sum((categorical_entropy(logits) * mask).sum()) / msum
    loss = pg_loss + hp.value_coef * v_loss - hp.entropy_coef * ent
    return loss, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent}

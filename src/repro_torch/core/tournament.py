"""Round-robin tournament over the frozen pool: fills the payoff matrix and
ranks models — the league-evaluation tooling the GameMgr's opponent
sampling consumes (and how a finished league is analyzed, cf. the paper's
win-rate tables and AlphaStar's league payoff plots).

Rankings:
  - Elo (incremental, from PayoffMatrix)
  - mean win-rate (row average of the payoff matrix)
  - Nash-averaging-lite: iterative proportional fitness (replicator steps
    on the empirical payoff), far cheaper than an LP and adequate for
    ranking a pool of tens of models.

Counterpart of `repro.core.tournament`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.core.payoff import PayoffMatrix
from repro_torch.core.types import MatchResult, ModelKey


def round_robin(payoff: PayoffMatrix, models: Sequence[ModelKey],
                play: Callable[[ModelKey, ModelKey, int], int],
                episodes_per_pair: int = 4, seed: int = 0) -> PayoffMatrix:
    """play(a, b, episode_idx) -> outcome (+1 a wins / 0 / -1). Fills the
    payoff matrix with every unordered pair."""
    for m in models:
        payoff.add_model(m)
    for i, a in enumerate(models):
        for b in models[i + 1:]:
            for ep in range(episodes_per_pair):
                out = play(a, b, ep)
                payoff.record(MatchResult(learner_key=a, opponent_keys=(b,),
                                          outcome=int(out)))
    return payoff


def replicator_ranking(payoff: PayoffMatrix, iters: int = 200,
                       lr: float = 0.5) -> Dict[ModelKey, float]:
    """Replicator-dynamics fixed point on the win-rate matrix: the mass a
    model holds at convergence is its equilibrium weight (Nash-averaging
    lite). Uniform for an empty matrix."""
    models = payoff.models
    n = len(models)
    if n == 0:
        return {}
    W = payoff.matrix() - 0.5          # antisymmetric advantage matrix
    p = np.ones(n) / n
    for _ in range(iters):
        fitness = W @ p
        p = p * np.exp(lr * fitness)
        p = np.clip(p, 1e-12, None)
        p /= p.sum()
    return dict(zip(models, p))


def league_report(payoff: PayoffMatrix) -> dict:
    models = payoff.models
    M = payoff.matrix()
    mean_wr = {m: float(M[i].sum() - M[i, i]) / max(len(models) - 1, 1)
               for i, m in enumerate(models)}
    nash = replicator_ranking(payoff)
    return {
        "models": [str(m) for m in models],
        "elo": {str(m): round(payoff.elo[m], 1) for m in models},
        "mean_winrate": {str(m): round(v, 3) for m, v in mean_wr.items()},
        "nash_weight": {str(m): round(float(v), 3) for m, v in nash.items()},
        "best_by_elo": str(max(models, key=lambda m: payoff.elo[m])) if models else None,
        "best_by_nash": str(max(nash, key=nash.get)) if nash else None,
    }

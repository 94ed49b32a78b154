"""League-protocol datatypes — the inter-module message contract (§3.3).

In the paper these are the private ZeroMQ RPC messages between LeagueMgr,
Actor, Learner and ModelPool; here they are the same protocol as dataclasses
passed over in-process queues (the transport adaptation).

Counterpart of `repro.core.types`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

Outcome = int  # +1 win, 0 tie, -1 loss (from the learning agent's perspective)


@dataclass(frozen=True)
class ModelKey:
    """Identifies a frozen (or currently-learning) policy in the pool."""
    agent_id: str          # which learning agent produced it ("main", "exploiter:0", ...)
    version: int           # freeze counter within that agent's lineage

    def __str__(self):
        return f"{self.agent_id}:{self.version:04d}"


@dataclass
class Hyperparam:
    """Per-model hyperparameters the HyperMgr manages (and PBT perturbs)."""
    learning_rate: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    entropy_coef: float = 0.01
    clip_eps: float = 0.2
    # opponent-sampling knobs
    elo_sigma: float = 200.0        # Gaussian Elo-matching variance (PBT/Quake-III)
    pfsp_weighting: str = "squared"  # 'linear' | 'squared' | 'variance'

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


@dataclass(frozen=True)
class FreezeGate:
    """When a learning model theta freezes into the opponent pool M.

    AlphaStar-style strength gating instead of a fixed period count: freeze
    once theta's aggregate winrate against the frozen pool reaches `winrate`
    (tau) with at least `min_games` of evidence, or after `timeout_steps`
    learner steps regardless. `step_gate`, when set, overrides everything
    with a pure step-count gate — the deterministic mode the sync/async
    equivalence tests rely on.
    """
    winrate: float = 0.7           # tau: freeze when pool winrate >= tau
    min_games: int = 16            # evidence needed before trusting winrate
    min_steps: int = 8             # never freeze before this many steps
    timeout_steps: int = 512       # freeze anyway after this many steps
    step_gate: Optional[int] = None  # pure step-count gate (determinism)

    def check(self, steps: int, pool_winrate: float,
              pool_games: float) -> Optional[str]:
        """Returns a freeze reason string, or None to keep training."""
        if self.step_gate is not None:
            return f"step_gate@{steps}" if steps >= self.step_gate else None
        if steps < self.min_steps:
            return None
        if pool_games >= self.min_games and pool_winrate >= self.winrate:
            return f"winrate@{pool_winrate:.3f}"
        if steps >= self.timeout_steps:
            return f"timeout@{steps}"
        return None

    def to_dict(self) -> Dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: Dict) -> "FreezeGate":
        return cls(**d)


@dataclass(frozen=True)
class Task:
    """What LeagueMgr hands to an Actor (and, consistently, to the Learner):
    who learns, against whom, with which hyperparameters."""
    learner_key: ModelKey
    opponent_keys: Tuple[ModelKey, ...]   # >=1; FSP extends to multi-opponent
    hyperparam: Hyperparam
    task_id: int = 0


@dataclass(frozen=True)
class MatchResult:
    """Episode outcome reported by an Actor at episode end.

    `task_id` echoes the Task the episode was played under; -1 marks
    legacy/eval traffic that never held a lease. The LeagueMgr's lease
    plane uses it as a generation guard: results quoting a reaped lease
    are dropped instead of corrupting the payoff matrix."""
    learner_key: ModelKey
    opponent_keys: Tuple[ModelKey, ...]
    outcome: Outcome
    episode_len: int = 0
    info: Optional[Dict] = None
    task_id: int = -1

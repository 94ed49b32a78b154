"""GameMgr: opponent-sampling algorithms over the pool (§3.1-3.2).

phi ~ Q(M). Implemented Q's, each matching a published scheme cited by the
paper:
  UniformGameMgr        — uniform over the (most recent N) historical models
                          [Bansal et al. 2017; the paper's ViZDoom run, N=50]
  PFSPGameMgr           — prioritized FSP, weight f(P[win]) with 'linear'
                          (1-p), 'squared' (1-p)^2, 'variance' p(1-p)
                          [Vinyals et al. 2019]
  SelfPlayPFSPGameMgr   — mixture: 35% current self, 65% PFSP — how the
                          AlphaStar Main Agent samples; the paper's
                          Pommerman experiment (§4.3) uses exactly this.
  EloMatchGameMgr       — probabilistic Elo-score matching, Gaussian kernel
                          over rating difference [Jaderberg et al. 2019, PBT]
  ExploiterGameMgr      — Agent-Exploiter: always plays the main agent's
                          current model [Vinyals et al. 2019]

Extension point mirrors the paper (§3.6): derive and implement
get_player()/add_player().

Counterpart of `repro.core.game_mgr`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.payoff import PayoffMatrix
from repro_torch.core.types import MatchResult, ModelKey

GAME_MGRS = {}


def register_game_mgr(name):
    def deco(cls):
        GAME_MGRS[name] = cls
        cls.name = name
        return cls
    return deco


class GameMgr:
    """Base class: maintains the payoff matrix; subclasses choose opponents."""

    def __init__(self, payoff: Optional[PayoffMatrix] = None, seed: int = 0):
        self.payoff = payoff or PayoffMatrix()
        self.rng = random.Random(seed)

    # -- paper API -------------------------------------------------------------
    def add_player(self, key: ModelKey, parent: Optional[ModelKey] = None):
        self.payoff.add_model(key, init_elo=self.payoff.elo.get(parent) if parent else None)

    def on_match_result(self, result: MatchResult):
        self.payoff.record(result)

    def get_player(self, learner_key: ModelKey, candidates: Sequence[ModelKey]) -> ModelKey:
        raise NotImplementedError

    def get_opponent(self, learner_key: ModelKey,
                     candidates: Sequence[ModelKey]) -> ModelKey:
        if not candidates:
            return learner_key          # pure self-play until the pool grows
        return self.get_player(learner_key, candidates)

    def _choice(self, candidates: Sequence[ModelKey], probs: np.ndarray) -> ModelKey:
        probs = np.asarray(probs, np.float64)
        probs = probs / probs.sum() if probs.sum() > 0 else np.ones(len(candidates)) / len(candidates)
        idx = self.rng.choices(range(len(candidates)), weights=probs, k=1)[0]
        return candidates[idx]


@register_game_mgr("uniform")
class UniformGameMgr(GameMgr):
    """Uniform over the most recent `recent_n` frozen models (paper §4.2:
    ViZDoom used uniform over the most recent 50)."""

    def __init__(self, recent_n: int = 50, **kw):
        super().__init__(**kw)
        self.recent_n = recent_n

    def get_player(self, learner_key, candidates):
        cand = list(candidates)[-self.recent_n:]
        return self.rng.choice(cand)


@register_game_mgr("pfsp")
class PFSPGameMgr(GameMgr):
    """Prioritized FSP: harder opponents sampled more often."""

    WEIGHTINGS = {
        "linear": lambda p: 1.0 - p,
        "squared": lambda p: (1.0 - p) ** 2,
        "variance": lambda p: p * (1.0 - p),
    }

    def __init__(self, weighting: str = "squared", **kw):
        super().__init__(**kw)
        self.weighting = weighting

    def get_player(self, learner_key, candidates):
        p = self.payoff.winrates_vs(learner_key, candidates)
        w = self.WEIGHTINGS[self.weighting](p) + 1e-6
        return self._choice(list(candidates), w)


@register_game_mgr("sp_pfsp")
class SelfPlayPFSPGameMgr(PFSPGameMgr):
    """35% pure self-play vs current, 65% PFSP vs the pool — the AlphaStar
    Main-Agent mixture; used by the paper's Pommerman experiment."""

    def __init__(self, self_play_frac: float = 0.35, **kw):
        super().__init__(**kw)
        self.self_play_frac = self_play_frac

    def get_opponent(self, learner_key, candidates):
        if not candidates or self.rng.random() < self.self_play_frac:
            return learner_key
        return self.get_player(learner_key, candidates)


@register_game_mgr("elo_match")
class EloMatchGameMgr(GameMgr):
    """Quake-III/PBT style: sample opponents with probability proportional to
    a Gaussian kernel over Elo difference (sigma from the HyperMgr)."""

    def __init__(self, sigma: float = 200.0, **kw):
        super().__init__(**kw)
        self.sigma = sigma

    def get_player(self, learner_key, candidates):
        r0 = self.payoff.elo.get(learner_key, self.payoff.init_elo)
        diffs = np.array([self.payoff.elo.get(c, self.payoff.init_elo) - r0
                          for c in candidates])
        w = np.exp(-0.5 * (diffs / self.sigma) ** 2) + 1e-9
        return self._choice(list(candidates), w)


@register_game_mgr("league_pfsp")
class LeagueExploiterGameMgr(PFSPGameMgr):
    """League-Exploiter [Vinyals et al. 2019]: PFSP over the ENTIRE frozen
    pool, every lineage included — it hunts systemic weaknesses of the whole
    league rather than the main agent specifically. AlphaStar uses the
    'linear' (1-p) weighting here, softer than the main agent's squared."""

    def __init__(self, weighting: str = "linear", **kw):
        super().__init__(weighting=weighting, **kw)


@register_game_mgr("minimax")
class MinimaxExploiterGameMgr(GameMgr):
    """Minimax-Exploiter [arXiv:2311.17190]: a data-efficient exploiter
    curriculum over the target lineage. Instead of always attacking the
    newest (strongest) main model, walk the target's frozen history from
    oldest to newest and play the first model not yet beaten (pool winrate
    < `beat_threshold`) — easy wins first give a dense learning signal, and
    the curriculum advances one rung per conquest until the newest model is
    the only one left."""

    def __init__(self, target_agent_id: str = "main",
                 beat_threshold: float = 0.7, **kw):
        super().__init__(**kw)
        self.target_agent_id = target_agent_id
        self.beat_threshold = beat_threshold

    def get_opponent(self, learner_key, candidates):
        targets = sorted((c for c in candidates
                          if c.agent_id == self.target_agent_id),
                         key=lambda k: k.version)
        if not targets:
            return learner_key
        for t in targets:
            if learner_key not in self.payoff or t not in self.payoff:
                return t                      # no evidence yet: start here
            if self.payoff.winrate(learner_key, t) < self.beat_threshold:
                return t                      # current curriculum rung
        return targets[-1]                    # beat them all: press the newest

    def get_player(self, learner_key, candidates):
        return self.get_opponent(learner_key, candidates)


@register_game_mgr("exploiter")
class ExploiterGameMgr(GameMgr):
    """Agent-Exploiter: always targets the main agent's current model."""

    def __init__(self, target_agent_id: str = "main", **kw):
        super().__init__(**kw)
        self.target_agent_id = target_agent_id

    def get_opponent(self, learner_key, candidates):
        targets = [c for c in candidates if c.agent_id == self.target_agent_id]
        if not targets:
            return learner_key
        return targets[-1]   # most recent main model

    def get_player(self, learner_key, candidates):
        return self.get_opponent(learner_key, candidates)

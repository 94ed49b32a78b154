"""Payoff matrix + Elo ratings over the model pool (GameMgr's state, §3.2).

Maintains win/tie/loss counts for every (row=learner lineage model,
col=opponent model) pair, exposes win-rates (ties = half win, as the paper's
Pommerman evaluation counts them) and incremental Elo updates used by
PBT/Elo-matched opponent sampling [Jaderberg et al. 2019].

Storage is a set of preallocated (cap, cap) count arrays with amortized
geometric growth (add_model is O(1) amortized, not a full reallocation per
model), queries are pure NumPy array ops over the live (n, n) views, and
`record_many` ingests tournament result floods with one `np.add.at` per
count matrix instead of a per-result Python loop.

Counterpart of `repro.core.payoff`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.types import MatchResult, ModelKey


class _EloView:
    """Dict-like view over the rating vector (keeps the paper-era
    `payoff.elo[key]` API while the storage is a NumPy array)."""

    def __init__(self, payoff: "PayoffMatrix"):
        self._p = payoff

    def __getitem__(self, key: ModelKey) -> float:
        return float(self._p._elo[self._p._index[key]])

    def __setitem__(self, key: ModelKey, value: float) -> None:
        self._p._elo[self._p._index[key]] = value

    def get(self, key: ModelKey, default=None):
        i = self._p._index.get(key)
        return default if i is None else float(self._p._elo[i])

    def __contains__(self, key: ModelKey) -> bool:
        return key in self._p._index

    def __len__(self) -> int:
        return len(self._p.models)

    def __iter__(self) -> Iterator[ModelKey]:
        return iter(self._p.models)

    def items(self) -> Iterator[Tuple[ModelKey, float]]:
        for k in self._p.models:
            yield k, self[k]

    def values(self) -> Iterator[float]:
        for k in self._p.models:
            yield self[k]

    def keys(self) -> Iterator[ModelKey]:
        return iter(self._p.models)


class PayoffMatrix:
    def __init__(self, elo_k: float = 16.0, init_elo: float = 1200.0):
        self.models: List[ModelKey] = []
        self._index: Dict[ModelKey, int] = {}
        self._cap = 0
        self._wins = np.zeros((0, 0), np.float64)
        self._ties = np.zeros((0, 0), np.float64)
        self._losses = np.zeros((0, 0), np.float64)
        self._elo = np.zeros((0,), np.float64)
        self.elo = _EloView(self)
        self.elo_k = elo_k
        self.init_elo = init_elo

    # -- pool growth ---------------------------------------------------------
    def _grow_to(self, cap: int) -> None:
        new_cap = max(4, self._cap)
        while new_cap < cap:
            new_cap *= 2
        if new_cap == self._cap:
            return
        n = len(self.models)
        for name in ("_wins", "_ties", "_losses"):
            m = getattr(self, name)
            grown = np.zeros((new_cap, new_cap), np.float64)
            grown[:n, :n] = m[:n, :n]
            setattr(self, name, grown)
        elo = np.full((new_cap,), self.init_elo, np.float64)
        elo[:n] = self._elo[:n]
        self._elo = elo
        self._cap = new_cap

    def add_model(self, key: ModelKey, init_elo: float | None = None):
        if key in self._index:
            return
        i = len(self.models)
        if i >= self._cap:
            self._grow_to(i + 1)
        self._index[key] = i
        self.models.append(key)
        self._elo[i] = self.init_elo if init_elo is None else init_elo

    def __contains__(self, key: ModelKey):
        return key in self._index

    def __len__(self):
        return len(self.models)

    # -- live (n, n) count views ----------------------------------------------
    @property
    def wins(self) -> np.ndarray:
        n = len(self.models)
        return self._wins[:n, :n]

    @property
    def ties(self) -> np.ndarray:
        n = len(self.models)
        return self._ties[:n, :n]

    @property
    def losses(self) -> np.ndarray:
        n = len(self.models)
        return self._losses[:n, :n]

    # -- updates ---------------------------------------------------------------
    def record(self, result: MatchResult):
        self.record_many((result,))

    def record_many(self, results: Iterable[MatchResult]) -> None:
        """Batched ingest for tournament result floods: one `np.add.at`
        scatter per count matrix. Elo stays sequential over results (each
        update reads the ratings the previous one wrote), but operates on
        the rating array directly."""
        ii: List[int] = []
        jj: List[int] = []
        oo: List[int] = []
        elo = self._elo
        k_factor = self.elo_k
        for r in results:
            i = self._index[r.learner_key]
            for opp in r.opponent_keys:
                j = self._index[opp]
                ii.append(i)
                jj.append(j)
                oo.append(r.outcome)
                ra, rb = elo[i], elo[j]
                ea = 1.0 / (1.0 + 10 ** ((rb - ra) / 400.0))
                sa = 0.5 + 0.5 * r.outcome
                elo[i] = ra + k_factor * (sa - ea)
                elo[j] = rb + k_factor * ((1.0 - sa) - (1.0 - ea))
        if not ii:
            return
        i_arr, j_arr = np.asarray(ii), np.asarray(jj)
        o_arr = np.asarray(oo)
        w, t, l = o_arr > 0, o_arr == 0, o_arr < 0
        np.add.at(self._wins, (i_arr[w], j_arr[w]), 1.0)
        np.add.at(self._wins, (j_arr[l], i_arr[l]), 1.0)
        np.add.at(self._losses, (i_arr[l], j_arr[l]), 1.0)
        np.add.at(self._losses, (j_arr[w], i_arr[w]), 1.0)
        np.add.at(self._ties, (i_arr[t], j_arr[t]), 1.0)
        np.add.at(self._ties, (j_arr[t], i_arr[t]), 1.0)

    # -- queries -----------------------------------------------------------------
    def games(self, a: ModelKey, b: ModelKey) -> float:
        i, j = self._index[a], self._index[b]
        return float(self._wins[i, j] + self._ties[i, j] + self._losses[i, j])

    def winrate(self, a: ModelKey, b: ModelKey, prior: float = 0.5,
                prior_games: float = 2.0) -> float:
        """P(a beats b), ties half-counted, with a Beta-style prior so unseen
        pairs look 50/50 instead of 0 or NaN."""
        i, j = self._index[a], self._index[b]
        w = self._wins[i, j] + 0.5 * self._ties[i, j] + prior * prior_games
        n = self.games(a, b) + prior_games
        return float(w / n)

    def winrates_vs(self, a: ModelKey, opponents: Sequence[ModelKey],
                    prior: float = 0.5, prior_games: float = 2.0) -> np.ndarray:
        """Vectorized winrate(a, o) over a candidate list (PFSP hot path)."""
        i = self._index[a]
        js = np.fromiter((self._index[o] for o in opponents), np.intp,
                         count=len(opponents))
        w = self._wins[i, js] + 0.5 * self._ties[i, js] + prior * prior_games
        g = self._wins[i, js] + self._ties[i, js] + self._losses[i, js]
        return w / (g + prior_games)

    def aggregate_vs(self, a: ModelKey,
                     opponents: Sequence[ModelKey]) -> Tuple[float, float]:
        """(winrate, games) of `a` aggregated over all games against
        `opponents` — the freeze-gate signal (ties half-counted; 0.5 with
        zero evidence). Unknown keys contribute nothing."""
        i = self._index.get(a)
        js = [self._index[o] for o in opponents
              if o in self._index and o != a]
        if i is None or not js:
            return 0.5, 0.0
        js = np.asarray(js, np.intp)
        w = float(self._wins[i, js].sum())
        t = float(self._ties[i, js].sum())
        g = w + t + float(self._losses[i, js].sum())
        return ((w + 0.5 * t) / g if g > 0 else 0.5), g

    def matrix(self, prior: float = 0.5, prior_games: float = 2.0) -> np.ndarray:
        """Full win-rate matrix (rows beat cols), one array expression:
        played off-diagonal pairs get the prior-smoothed rate, everything
        else (unseen pairs and the diagonal) sits at 0.5."""
        n = len(self.models)
        W, T, L = self.wins, self.ties, self.losses
        G = W + T + L
        rate = (W + 0.5 * T + prior * prior_games) / (G + prior_games)
        played = G > 0
        np.fill_diagonal(played, False)
        return np.where(played, rate, 0.5)

    def to_state(self) -> dict:
        return {
            "models": [str(m) for m in self.models],
            "wins": self.wins.copy(), "ties": self.ties.copy(),
            "losses": self.losses.copy(),
            "elo": {str(k): v for k, v in self.elo.items()},
        }

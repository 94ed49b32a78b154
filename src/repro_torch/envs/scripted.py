"""Scripted (rule-based) opponents — the evaluation baselines; a copy of
`repro.envs.scripted`, which is plain numpy (the port imports nothing of
`repro`).

The paper evaluates against ViZDoom builtin bots (Tables 1-2) and
Pommerman's SimpleAgent (Fig. 4). These are the analogues, operating on the
same token observations the learned policies see.
"""
from __future__ import annotations

import numpy as np

VIEW = 5
C = VIEW // 2  # center index


def _grid(obs_row):
    return np.asarray(obs_row[:VIEW * VIEW]).reshape(VIEW, VIEW)


def duel_bot(obs, rng: np.random.Generator):
    """Turn toward the nearest visible enemy and fire when aligned.
    obs: (k, L) token obs -> (k,) actions {0 idle,1 fwd,2 turn-L,3 turn-R,4 fire}."""
    acts = []
    for row in np.asarray(obs):
        g = _grid(row)
        facing = int(row[VIEW * VIEW] - 8)        # 0 N,1 E,2 S,3 W
        enemies = np.argwhere(g == 6)
        if len(enemies) == 0:
            acts.append(int(rng.integers(1, 4)))  # wander
            continue
        er, ec = enemies[np.abs(enemies - C).sum(1).argmin()]
        dr, dc = er - C, ec - C
        # desired facing
        if abs(dr) >= abs(dc):
            want = 0 if dr < 0 else 2
        else:
            want = 3 if dc < 0 else 1
        if want == facing:
            aligned = (dr == 0) or (dc == 0)
            acts.append(4 if aligned else 1)
        else:
            diff = (want - facing) % 4
            acts.append(3 if diff <= 2 else 2)    # turn toward
    return np.array(acts, np.int32)


def pommerman_simple_bot(obs, rng: np.random.Generator):
    """SimpleAgent-lite: bomb when an enemy or wood is adjacent, flee bombs,
    otherwise random legal-looking move."""
    acts = []
    for row in np.asarray(obs):
        g = _grid(row)
        adj = [g[C - 1, C], g[C + 1, C], g[C, C - 1], g[C, C + 1]]
        ammo = int(row[-1]) - 8
        # flee if standing next to a bomb
        bomb_dirs = [i for i, v in enumerate(adj) if v == 3]
        if bomb_dirs or g[C, C] == 3:
            frees = [i for i, v in enumerate(adj) if v == 0]
            acts.append(1 + rng.choice(frees) if frees else 0)
            continue
        if ammo > 0 and any(v in (2, 6) for v in adj):
            acts.append(5)                         # bomb wood/enemy
            continue
        frees = [i for i, v in enumerate(adj) if v == 0]
        acts.append(1 + int(rng.choice(frees)) if frees else 0)
    return np.array(acts, np.int32)


SCRIPTED = {"duel": duel_bot, "pommerman_lite": pommerman_simple_bot}


def random_bot(num_actions):
    def bot(obs, rng):
        return rng.integers(0, num_actions, size=(len(obs),)).astype(np.int32)
    return bot

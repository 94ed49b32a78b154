"""Role wiring: turn a LeagueSpec into a populated LeagueMgr.

`make_game_mgr` maps a RoleSpec onto the GAME_MGRS registry (injecting the
exploiter target lineage where the matchmaker takes one), and
`install_roles` registers every role as a learning agent — shared payoff
matrix, per-role matchmaking, freeze gate and reset policy — on a LeagueMgr
whose ModelPool snapshots on pull (the concurrency-safe default for the
async runtime).

Counterpart of `repro.league.roles`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.core import GAME_MGRS, LeagueMgr, ModelPool
from repro_torch.core.game_mgr import GameMgr
from repro_torch.league.spec import LeagueSpec, RoleSpec

# matchmakers that chase a specific lineage, and the kwarg that names it
_TARGETED = {"exploiter": "target_agent_id", "minimax": "target_agent_id"}


def make_game_mgr(role: RoleSpec, *, payoff, seed: int = 0) -> GameMgr:
    name = role.matchmaking_name
    assert name in GAME_MGRS, (
        f"role {role.name!r}: unknown matchmaking {name!r}; "
        f"pick from {sorted(GAME_MGRS)}")
    kwargs = dict(role.matchmaking_kwargs)
    if name in _TARGETED:
        kwargs.setdefault(_TARGETED[name], role.target)
    return GAME_MGRS[name](payoff=payoff, seed=seed, **kwargs)


def install_roles(spec: LeagueSpec, init_params_fn: Callable[[int], Any], *,
                  league: Optional[LeagueMgr] = None, pbt: bool = False,
                  seed: int = 0,
                  lease_ttl_s: Optional[float] = None) -> LeagueMgr:
    """Build (or extend) a LeagueMgr from a spec. `init_params_fn(i)` makes
    the seed params for the i-th role — a fresh random init per lineage, or
    a shared imitation-learned seed. `lease_ttl_s` activates the task-lease
    plane (dead-actor matches get reaped and re-issued)."""
    if league is None:
        league = LeagueMgr(model_pool=ModelPool(snapshot_on_pull=True),
                           pbt=pbt, seed=seed, lease_ttl_s=lease_ttl_s)
    for i, role in enumerate(spec):
        gm = make_game_mgr(role, payoff=league.payoff, seed=seed + i)
        league.add_learning_agent(
            role.name, init_params_fn(i), game_mgr=gm, role=role.role,
            gate=role.gate, reset_on_freeze=role.reset_policy)
    return league

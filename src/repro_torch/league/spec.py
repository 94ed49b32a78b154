"""LeagueSpec: declarative description of a role-based league population.

One spec = one population of learning agents, each playing an
AlphaStar-style role. A role bundles three policies:

  * **matchmaking** — which GameMgr (opponent distribution Q) the role's
    Actors sample phi from;
  * **freeze gate** — when theta freezes into the opponent pool M
    (winrate-gated vs the pool, with a timeout; see
    `repro_torch.core.types.FreezeGate`);
  * **reset-on-freeze** — whether theta_{v+1} continues from theta
    (`continue`, the main agent) or restarts from the seed params
    (`seed`, the exploiter reset of AlphaStar).

Role defaults (matchmaking / reset) follow the published schemes:

  | role               | matchmaking (default)        | reset  |
  |--------------------|------------------------------|--------|
  | main               | sp_pfsp (35% self, 65% PFSP) | no     |
  | main_exploiter     | exploiter (main's current)   | seed   |
  | league_exploiter   | league_pfsp (whole pool)     | seed   |
  | minimax_exploiter  | minimax (curriculum over     | seed   |
  |                    | the target lineage)          |        |

JSON schema (`LeagueSpec.from_json`):

    {"roles": [
       {"name": "main", "role": "main", "num_actors": 2,
        "gate": {"winrate": 0.7, "min_games": 16, "min_steps": 8,
                 "timeout_steps": 64}},
       {"name": "mm", "role": "minimax_exploiter", "target": "main",
        "matchmaking_kwargs": {"beat_threshold": 0.6}}
    ]}

Every field except `name` is optional; omitted fields take the role
defaults above (and `FreezeGate()` for the gate).

Counterpart of `repro.league.spec`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.types import FreezeGate

ROLE_DEFAULTS: Dict[str, Dict[str, str]] = {
    "main": {"matchmaking": "sp_pfsp", "reset_on_freeze": "continue"},
    "main_exploiter": {"matchmaking": "exploiter", "reset_on_freeze": "seed"},
    "league_exploiter": {"matchmaking": "league_pfsp",
                         "reset_on_freeze": "seed"},
    "minimax_exploiter": {"matchmaking": "minimax", "reset_on_freeze": "seed"},
}


@dataclass(frozen=True)
class RoleSpec:
    name: str                       # the agent_id of this lineage
    role: str = "main"
    matchmaking: Optional[str] = None          # GAME_MGRS name; role default
    matchmaking_kwargs: Dict = field(default_factory=dict)
    gate: FreezeGate = field(default_factory=FreezeGate)
    reset_on_freeze: Optional[str] = None      # 'continue'|'seed'; role default
    num_actors: int = 1
    target: str = "main"            # lineage the exploiter roles chase

    def __post_init__(self):
        assert self.role in ROLE_DEFAULTS, (
            f"unknown role {self.role!r}; pick from {sorted(ROLE_DEFAULTS)}")
        assert self.num_actors >= 1, "every role needs at least one Actor"

    @property
    def matchmaking_name(self) -> str:
        return self.matchmaking or ROLE_DEFAULTS[self.role]["matchmaking"]

    @property
    def reset_policy(self) -> str:
        return self.reset_on_freeze or ROLE_DEFAULTS[self.role]["reset_on_freeze"]

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["gate"] = self.gate.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "RoleSpec":
        d = dict(d)
        if isinstance(d.get("gate"), dict):
            d["gate"] = FreezeGate.from_dict(d["gate"])
        return cls(**d)


@dataclass(frozen=True)
class LeagueSpec:
    roles: tuple   # Tuple[RoleSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "roles", tuple(self.roles))
        names = [r.name for r in self.roles]
        assert names, "a LeagueSpec needs at least one role"
        assert len(set(names)) == len(names), f"duplicate role names: {names}"
        known = set(names)
        for r in self.roles:
            if r.role != "main":
                assert r.target in known, (
                    f"role {r.name!r} targets unknown lineage {r.target!r}")

    def __iter__(self):
        return iter(self.roles)

    def __len__(self):
        return len(self.roles)

    def get(self, name: str) -> RoleSpec:
        for r in self.roles:
            if r.name == name:
                return r
        raise KeyError(name)

    @property
    def num_actors_total(self) -> int:
        return sum(r.num_actors for r in self.roles)

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> Dict:
        return {"roles": [r.to_dict() for r in self.roles]}

    @classmethod
    def from_dict(cls, d: Dict) -> "LeagueSpec":
        return cls(roles=tuple(RoleSpec.from_dict(r) for r in d["roles"]))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def from_json(cls, path: str) -> "LeagueSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- common shapes ---------------------------------------------------------
    @classmethod
    def main_vs_exploiter(cls, exploiter_role: str = "minimax_exploiter",
                          num_actors: int = 1,
                          gate: Optional[FreezeGate] = None) -> "LeagueSpec":
        """The smallest interesting league: one main + one exploiter."""
        g = gate or FreezeGate()
        return cls(roles=(
            RoleSpec(name="main", role="main", num_actors=num_actors, gate=g),
            RoleSpec(name="exploiter:0", role=exploiter_role, target="main",
                     num_actors=num_actors, gate=g),
        ))

"""The port's league core against the JAX package's, on the CPU.

`repro.core`, `repro.league.spec`/`roles` and `repro.core.tournament` are
framework-free; the port carries its own copies. One scripted league runs
against each package with the same seeds and the same outcomes (from a
numpy seed): four roles installed from one `LeagueSpec`, tasks requested
under leases, results reported, leases reaped by dead actors, freezes when
each role's gate fires (PBT on), then a round-robin tournament over the
frozen pool. Every decision and every table must be equal: the opponent
keys drawn, `league_state()`, the payoff and Elo tables, the hyperparams,
`lease_state()`, the freeze events and the tournament report.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.core as jax_core
import repro.core.tournament as jax_tournament
import repro.league.roles as jax_roles
import repro.league.spec as jax_spec
import repro_torch.core as core
import repro_torch.core.tournament as tournament
import repro_torch.league.roles as roles
import repro_torch.league.spec as spec

JAX = types.SimpleNamespace(core=jax_core, spec=jax_spec, roles=jax_roles, tournament=jax_tournament)
PORT = types.SimpleNamespace(core=core, spec=spec, roles=roles, tournament=tournament)
ROUNDS = 24


def _league_spec(pkg):
    gate = pkg.core.FreezeGate(winrate=0.55, min_games=4, min_steps=2, timeout_steps=6)
    S = pkg.spec.RoleSpec
    return pkg.spec.LeagueSpec(roles=(
        S(name="main", role="main", num_actors=2, gate=gate),
        S(name="me", role="main_exploiter", target="main", gate=gate),
        S(name="le", role="league_exploiter", target="main", gate=gate),
        S(name="mm", role="minimax_exploiter", target="main", gate=gate,
          matchmaking_kwargs={"beat_threshold": 0.6}),
    ))


def _params(i, r=0):
    return {"w": np.full((3,), 10.0 * i + r, np.float32), "b": np.arange(2, dtype=np.int32) + i}


def _scenario(pkg):
    """Run the scripted league; return everything both packages must agree on."""
    lg = pkg.roles.install_roles(_league_spec(pkg), _params, pbt=True, seed=11,
                                 lease_ttl_s=30.0)
    rng = np.random.default_rng(12)
    out = {"tasks": [], "reaped": [], "freezes": []}
    steps = {aid: 0 for aid in lg.agents}
    for r in range(ROUNDS):
        for aid in lg.agents:
            task = lg.request_task(aid, actor_id=f"{aid}/{r % 2}")
            out["tasks"].append((aid, str(task.learner_key),
                                 tuple(map(str, task.opponent_keys)), task.task_id))
            if r % 7 != 3 and r != ROUNDS - 1:    # some leases stay outstanding
                lg.report_result(pkg.core.MatchResult(
                    learner_key=task.learner_key, opponent_keys=task.opponent_keys,
                    outcome=int(rng.integers(-1, 2)), episode_len=1, task_id=task.task_id))
            lg.touch_actor(f"{aid}/0")
            steps[aid] += 1
            reason = lg.should_freeze(aid, steps[aid])
            if reason is not None:
                new = lg.end_learning_period(aid, _params(len(out["freezes"]), r), reason)
                out["freezes"].append((aid, reason, str(new)))
                steps[aid] = 0
        if r % 7 == 3:                            # dead actors' leases are reaped
            reaped = lg.reap_leases(now=0.0, dead_actors=[f"main/{r % 2}", f"mm/{r % 2}"])
            out["reaped"].append(sorted(l.task_id for l in reaped))
    out["league_state"] = lg.league_state()
    out["lease_state"] = lg.lease_state()
    out["payoff"] = {k: v.tolist() if isinstance(v, np.ndarray) else v
                     for k, v in lg.payoff.to_state().items()}
    out["winrates"] = lg.payoff.matrix().tolist()
    out["pool_winrate"] = {aid: lg.pool_winrate(aid) for aid in lg.agents}
    pool = lg.model_pool
    out["pool"] = {str(k): (pool.version(k), pool.pull_attr(k)["frozen"],
                            {n: v.tolist() for n, v in pool.pull(k).items()})
                   for k in pool.keys()}
    out["hypers"] = {str(k): lg.hyper_mgr.get(k).to_dict() for k in pool.keys()}
    out["freeze_events"] = [{k: v for k, v in e.items() if k != "t"}
                            for e in lg.freeze_events]
    out["roles"] = {aid: (a.role, type(a.game_mgr).__name__, a.reset_on_freeze)
                    for aid, a in lg.agents.items()}
    # a round-robin tournament over the frozen pool, on a fresh payoff board
    frozen = list(lg.frozen_pool)
    board = pkg.core.PayoffMatrix()
    play = lambda a, b, ep: (3 * a.version + b.version + ep + len(a.agent_id)) % 3 - 1
    pkg.tournament.round_robin(board, frozen, play, episodes_per_pair=3)
    out["report"] = pkg.tournament.league_report(board)
    out["nash"] = {str(k): v for k, v in pkg.tournament.replicator_ranking(board).items()}
    return out


@pytest.fixture(scope="module")
def runs():
    return _scenario(JAX), _scenario(PORT)


@pytest.mark.parametrize("part", ["tasks", "reaped", "freezes", "league_state", "lease_state",
                                  "payoff", "winrates", "pool_winrate", "pool", "hypers",
                                  "freeze_events", "roles", "report", "nash"])
def test_scripted_league_matches_jax(runs, part):
    want, got = runs
    assert got[part] == want[part]


def test_scenario_exercises_every_path(runs):
    """The script must reach what it claims to compare."""
    _, got = runs
    assert {aid for aid, _, _ in got["freezes"]} == {"main", "me", "le", "mm"}
    assert any(r.startswith("winrate@") for _, r, _ in got["freezes"])
    assert any(r.startswith("timeout@") for _, r, _ in got["freezes"])
    ls = got["lease_state"]
    assert ls["reaped"] > 0 and ls["reissued"] > 0 and ls["outstanding"] > 0
    assert ls["completed"] > 0 and ls["released"] > 0
    assert len(got["report"]["models"]) >= 4


def test_league_spec_round_trips_like_jax(tmp_path):
    want, got = _league_spec(JAX), _league_spec(PORT)
    assert got.to_dict() == want.to_dict()
    got.to_json(tmp_path / "spec.json")
    back = spec.LeagueSpec.from_json(tmp_path / "spec.json")
    assert back.to_dict() == want.to_dict()
    assert [dataclasses.asdict(r.gate) for r in back] == [dataclasses.asdict(r.gate) for r in want]
    main = spec.LeagueSpec.main_vs_exploiter()
    assert main.to_dict() == jax_spec.LeagueSpec.main_vs_exploiter().to_dict()
    with pytest.raises(AssertionError, match="unknown lineage"):
        spec.LeagueSpec(roles=(spec.RoleSpec(name="x", role="main_exploiter", target="nope"),))


def test_game_mgr_registry_matches_jax():
    assert sorted(core.GAME_MGRS) == sorted(jax_core.GAME_MGRS)
    for name in core.GAME_MGRS:
        assert core.GAME_MGRS[name].__name__ == jax_core.GAME_MGRS[name].__name__

"""The port's league runtime, checkpoints and evaluation against the JAX
package's, on the CPU; and the kernels' launch counters under threads.

* `build_runtime(..., device="cpu")` on `rps` with a step gate reaches the
  same `league_state()` lineage structure as `repro`'s runtime (the
  counterpart of `test_sync_and_async_reach_same_lineage_structure`), with
  `repro`'s report keys; served mode shuts down as cleanly.
* An `.npz` written by either package loads bitwise in the other.
* `play_episodes` of scripted bots gives `repro`'s outcomes, reward sums
  and frags (duel's resets and steps draw nothing, and the bots draw from a
  numpy generator seeded alike).
* Several threads bump one launch counter at once and every increment
  shows.
"""
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import get_arch as jax_get_arch
from repro.eval import play_episodes as jax_play_episodes
from repro.envs import make_env as jax_make_env
from repro.envs.scripted import duel_bot as jax_duel_bot
from repro.envs.scripted import random_bot as jax_random_bot
from repro.league import build_runtime as jax_build_runtime
from repro.league import FreezeGate as JaxFreezeGate
from repro.league import LeagueSpec as JaxLeagueSpec
from repro.league import RoleSpec as JaxRoleSpec
from repro.models import init_params as jax_init_params
from repro_torch.checkpoint import load_league, load_pytree, save_league, save_pytree
from repro_torch.configs import get_arch
from repro_torch.distributed import Heartbeat
from repro_torch.envs import make_env
from repro_torch.envs.scripted import duel_bot, random_bot
from repro_torch.eval import learned_policy_fn, play_episodes, winrate_vs
from repro_torch.kernels import _build
from repro_torch.league import FreezeGate, LeagueSpec, RoleSpec, build_runtime
from repro_torch.models import init_params
from repro_torch.utils import tree_flatten_with_path

PERIODS, STEPS = 2, 3


def _spec(spec_cls, role_cls, gate_cls, **kw):
    return spec_cls(roles=(
        role_cls(name="main", role="main", gate=gate_cls(step_gate=STEPS), **kw),
        role_cls(name="exploiter:0", role="minimax_exploiter", target="main",
                 gate=gate_cls(step_gate=STEPS), **kw)))


def _check_report(report, jax_report):
    assert report["clean_shutdown"]
    assert set(report) == set(jax_report)
    for name, role in report["roles"].items():
        assert set(role) == set(jax_report["roles"][name])
        assert len(role["freezes"]) == PERIODS
        for f in role["freezes"]:
            assert f["reason"].startswith("step_gate@") and f["latency_s"] >= 0.0


@pytest.fixture(scope="module")
def jax_run():
    rt = jax_build_runtime(_spec(JaxLeagueSpec, JaxRoleSpec, JaxFreezeGate), env_name="rps",
                           num_envs=4, unroll_len=8, seed=3)
    report = rt.run(max_freezes_per_role=PERIODS, max_seconds=240)
    return rt.league.league_state(), report


def test_runtime_reaches_repro_s_lineage_structure(jax_run):
    jax_state, jax_report = jax_run
    rt = build_runtime(_spec(LeagueSpec, RoleSpec, FreezeGate), env_name="rps", num_envs=4,
                       unroll_len=8, seed=3, device="cpu")
    report = rt.run(max_freezes_per_role=PERIODS, max_seconds=240)
    state = rt.league.league_state()
    assert sorted(state["frozen_pool"]) == sorted(jax_state["frozen_pool"])
    assert state["agents"] == jax_state["agents"] and state["roles"] == jax_state["roles"]
    assert state["num_freezes"] == jax_state["num_freezes"] == 2 * PERIODS
    _check_report(report, jax_report)
    for name, role in report["roles"].items():
        learner = next(r.learner.learner for r in rt.roles if r.spec.name == name)
        assert role["learner_steps"] == learner.step_count >= PERIODS * STEPS


def test_served_runtime_shuts_down_cleanly(jax_run):
    rt = build_runtime(_spec(LeagueSpec, RoleSpec, FreezeGate), env_name="rps", num_envs=4,
                       unroll_len=8, seed=3, served=True, prefetch=False, device="cpu")
    report = rt.run(max_freezes_per_role=PERIODS, max_seconds=240)
    _check_report(report, jax_run[1])
    assert rt.inf_server.batches_run > 0
    assert not any(r.data_server.prefetch for r in rt.roles)


def test_runtime_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_runtime(_spec(LeagueSpec, RoleSpec, FreezeGate))


def _bitwise(a, b):
    a, b = a.detach().cpu() if isinstance(a, torch.Tensor) else a, b
    a = a.float().numpy() if a.dtype == torch.bfloat16 else np.asarray(a)
    return a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


def test_checkpoint_written_by_repro_loads_bitwise_in_the_port(tmp_path):
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_get_arch("tleague-policy-s"))
    jax_save_pytree(str(tmp_path / "jax.npz"), jparams)
    template = init_params(torch.Generator().manual_seed(5), get_arch("tleague-policy-s"))
    loaded = load_pytree(str(tmp_path / "jax.npz"), template)
    want = dict(tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0])
    got = tree_flatten_with_path(loaded)[0]
    assert [p for p, _ in got] == list(want)
    assert all(isinstance(x, torch.Tensor) and _bitwise(x, want[p]) for p, x in got)


def test_checkpoint_written_by_the_port_loads_bitwise_in_repro(tmp_path):
    params = init_params(torch.Generator().manual_seed(5), get_arch("tleague-policy-s"))
    tree = {"params": params, "opt": {"step": torch.tensor(7, dtype=torch.int32),
                                      "mu": None, "nu": [params["final_norm"]["scale"] * 3]}}
    save_pytree(str(tmp_path / "port.npz"), tree)
    jtemplate = {"params": jax_init_params(jax.random.PRNGKey(1),
                                           jax_get_arch("tleague-policy-s")),
                 "opt": {"step": np.int32(0), "mu": None,
                         "nu": [np.zeros(params["final_norm"]["scale"].shape, np.float32)]}}
    loaded = jax_load_pytree(str(tmp_path / "port.npz"), jtemplate)
    want = dict(tree_flatten_with_path(tree)[0])
    got = dict(tree_flatten_with_path(jax.tree.map(np.asarray, loaded))[0])
    assert set(got) == set(want)
    assert all(_bitwise(want[p], got[p]) for p in want)
    # and back into the port, with the template's dtypes (a bf16 leaf too)
    back = load_pytree(str(tmp_path / "port.npz"), tree)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_flatten_with_path(back)[0],
                                                         tree_flatten_with_path(tree)[0]))
    bf = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    save_pytree(str(tmp_path / "bf.npz"), bf)
    assert torch.equal(load_pytree(str(tmp_path / "bf.npz"), bf)["w"], bf["w"])


def test_league_state_roundtrip(tmp_path):
    state = {"frozen_pool": ["main:0000"], "elo": {"main:0000": 1200.0},
             "w": torch.arange(3)}
    save_league(str(tmp_path / "league.json"), state)
    assert load_league(str(tmp_path / "league.json")) == {**state, "w": [0, 1, 2]}


@pytest.mark.parametrize("name,bots", [("duel", "duel"), ("rps", "random")])
def test_play_episodes_gives_repro_s_results(name, bots):
    env, jenv = make_env(name, device="cpu"), jax_make_env(name)
    if bots == "duel":
        port, ref = [duel_bot] * 4, [jax_duel_bot] * 4
    else:
        port, ref = [random_bot(3)] * 2, [jax_random_bot(3)] * 2
    got = play_episodes(env, port, episodes=3, seed=2)
    want = jax_play_episodes(jenv, ref, episodes=3, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    if name == "duel":
        assert got["frags"].sum() > 0


def test_learned_policy_acts_in_play_episodes():
    cfg = get_arch("tleague-policy-s")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    fn = learned_policy_fn(cfg, 3, params, seed=1, device="cpu")
    out = play_episodes(make_env("rps", device="cpu"), [fn, random_bot(3)], episodes=2)
    assert out["outcomes"].shape == (2,) and out["reward_sums"].shape == (2, 2)
    assert winrate_vs(np.array([1, 0, -1, 1])) == 0.625


def test_heartbeat_stalls_without_beats():
    hb = Heartbeat()
    assert hb.beat() == 1 and hb.ping() == 1
    assert not hb.stalled(60.0) and hb.stalled(-1.0)


class _YieldingCounter:
    """A `launches` attribute whose read gives up the interpreter lock, so
    an unlocked read-add-write is split by the other threads (CPython's
    `+=` on a plain int attribute is rarely split, but nothing promises
    that)."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, n):
        self._n = n


def test_launch_counter_keeps_every_increment_under_threads():
    """Eight threads bump one counter 500 times each; every increment must
    show. Without the lock this counts about one thread's worth."""
    counter = _YieldingCounter()
    n_threads, n_each = 8, 500
    start = threading.Barrier(n_threads)

    def bump():
        start.wait()
        for _ in range(n_each):
            _build.count_launch(counter)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == n_threads * n_each
    counter.launches = 0                       # the reset is an assignment, as before
    _build.count_launch(counter)
    assert counter.launches == 1

"""The port's collectors and Actor against the JAX package's, on the CPU.

* Served collectors: one deterministic stub server (its actions, logp and
  values are fixed functions of the observation rows and the model key)
  drives `repro`'s and the port's `ServedCollector` and
  `collect_interleaved`. On `rps` and `duel`, whose resets are
  deterministic, the segments, episodes and carries are held bitwise
  across autoresets and segments; on `pommerman_lite` both start from
  `repro`'s reset and are held up to the first autoreset (the two packages'
  reset draws differ).
* The local collector (`JitCollector`, tleague-policy-s at fp32 compute on
  `repro`'s params carried over with `from_reference`): every action it
  took (learner and opponent slots, through a recording VectorEnv) is
  replayed through `repro`'s env from the same start, which must give the
  recorded observations, rewards and `done`; its `behavior_logp`,
  `behavior_values` and bootstrap values must match `repro`'s
  `make_obs_policy` on the same observations and actions within 1e-4.
* The Actor: one `MatchResult` per finished episode with `repro`'s episode
  lengths; the served mode's refresh; the CUDA default.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors.collector import ServedCollector as JaxServedCollector
from repro.actors.collector import collect_interleaved as jax_collect_interleaved
from repro.actors.policy import make_obs_policy as jax_make_obs_policy
from repro.configs import get_arch as jax_get_arch
from repro.envs import JaxVectorEnv
from repro.envs import make_env as jax_make_env
from repro.models import init_params as jax_init_params
from repro.rl.distributions import categorical_logp as jax_categorical_logp
from repro_torch.actors import (Actor, JitCollector, ServedCollector, build_rollout,
                                build_served_rollout, collect_interleaved)
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
from repro_torch.envs import TorchVectorEnv, make_env
from repro_torch.infserver import InfServer
from repro_torch.models import init_params
from repro_torch.params import build_manifest, from_reference

TOL = 1e-4
E = 4


class StubServer:
    """A deterministic InfServer stand-in: `submit`/`get`/`flush` with
    results that depend only on the rows and the model key."""

    def __init__(self, num_actions):
        self.num_actions = num_actions
        self._pending, self._results, self._next = {}, {}, 0
        self.flushes = 0

    def submit(self, obs, model=None):
        tid, self._next = self._next, self._next + 1
        self._pending[tid] = (np.array(obs), model)
        return tid

    def flush(self):
        if not self._pending:
            return
        self.flushes += 1
        for tid, (obs, model) in self._pending.items():
            s = obs.astype(np.int64) @ (np.arange(obs.shape[1]) + 1)
            salt = 1 if model == "theta" else 2
            a = ((s * 7 + salt) % self.num_actions).astype(np.int32)
            self._results[tid] = (a, (-(a + 1) / 8.0).astype(np.float32),
                                  (s / 10.0 + salt).astype(np.float32))
        self._pending = {}

    def get(self, tid):
        if tid not in self._results:
            self.flush()
        return self._results.pop(tid)


def _port_state(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _same_tree(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)


def _start(name, seed=4):
    """`repro`'s vmapped reset, and the same states carried into the port."""
    jenv, env = jax_make_env(name), make_env(name, device="cpu")
    jvec, vec = JaxVectorEnv(jenv, E, jit=True), TorchVectorEnv(env, E)
    jstates, jobs = jvec.reset(jax.random.PRNGKey(seed))
    return jvec, vec, (jstates, jobs), (_port_state(jstates), torch.from_numpy(np.array(jobs)))


@pytest.mark.parametrize("name,T", [("rps", 11), ("duel", 40)])
def test_served_collector_bitwise_equal_to_repro(name, T):
    jvec, vec, jcarry, carry = _start(name)
    jcol = JaxServedCollector(jvec, unroll_len=T)
    col = ServedCollector(vec, unroll_len=T)
    jsrv, srv = StubServer(vec.spec.num_actions), StubServer(vec.spec.num_actions)
    gen = torch.Generator().manual_seed(0)
    for seg in range(2):                       # the carry threads across segments
        jcarry, jtraj, jep = jcol.collect(jsrv, "theta", "phi", jcarry, jax.random.PRNGKey(seg))
        carry, traj, ep = col.collect(srv, "theta", "phi", carry, gen)
        _same_tree(jtraj, traj, f"{name} traj {seg}")
        _same_tree(jep, ep, f"{name} episodes {seg}")
        _same_tree(jcarry[0], {k: v.numpy() for k, v in carry[0].items()}, f"{name} carry")
        assert np.array_equal(np.asarray(jcarry[1]), carry[1].numpy())
    assert jsrv.flushes == srv.flushes == 2 * (T + 1)
    assert ep["done"].any()                    # autoresets happened


def test_served_collector_pommerman_equal_up_to_first_autoreset():
    jvec, vec, jcarry, carry = _start("pommerman_lite", seed=6)
    T = 24
    jsrv, srv = StubServer(6), StubServer(6)
    _, jtraj, jep = JaxServedCollector(jvec, unroll_len=T).collect(
        jsrv, "theta", "phi", jcarry, jax.random.PRNGKey(0))
    _, traj, ep = ServedCollector(vec, unroll_len=T).collect(
        srv, "theta", "phi", carry, torch.Generator().manual_seed(0))
    done_t = np.nonzero(np.asarray(jep["done"]).any(1))[0]
    upto = int(done_t[0]) + 1 if len(done_t) else T
    assert upto >= 4
    for k in ("obs", "actions", "behavior_logp", "behavior_values", "rewards", "done"):
        a, b = np.asarray(jtraj[k])[:, :upto], traj[k][:, :upto]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    _same_tree({k: np.asarray(v)[:upto] for k, v in jep.items()},
               {k: v[:upto] for k, v in ep.items()}, "pommerman episodes")


def test_collect_interleaved_bitwise_equal_to_repro():
    jvec, vec, jcarry, carry = _start("rps")
    _, _, jcarry2, carry2 = _start("rps", seed=5)
    jsrv, srv = StubServer(3), StubServer(3)
    jouts = jax_collect_interleaved(
        [JaxServedCollector(jvec, unroll_len=9), JaxServedCollector(jvec, unroll_len=9)], jsrv,
        [("theta", "phi", jcarry, jax.random.PRNGKey(1)),
         ("phi", "theta", jcarry2, jax.random.PRNGKey(2))])
    gen = torch.Generator().manual_seed(0)
    outs = collect_interleaved(
        [ServedCollector(vec, unroll_len=9), ServedCollector(vec, unroll_len=9)], srv,
        [("theta", "phi", carry, gen), ("phi", "theta", carry2, gen)])
    for (_, jt, je), (_, t, e) in zip(jouts, outs):
        _same_tree(jt, t, "interleaved traj")
        _same_tree(je, e, "interleaved episodes")
    assert jsrv.flushes == srv.flushes == 10       # one flush per step, both collectors


def test_served_collector_phase_misuse_raises():
    c = ServedCollector(TorchVectorEnv(make_env("rps", device="cpu"), 2), unroll_len=3)
    with pytest.raises(RuntimeError):
        c.complete_step(None)                  # never began
    c.begin(c.init_carry(torch.Generator()), torch.Generator())
    with pytest.raises(RuntimeError):
        c.finish(None)                         # no bootstrap submitted


def test_rollout_builders_are_the_collectors():
    """`build_rollout` and `build_served_rollout` drive the collectors with
    the same draws: the same segments, bitwise."""
    env = make_env("duel", device="cpu")
    cfg = get_arch("tleague-policy-s")
    theta = init_params(torch.Generator().manual_seed(0), cfg)
    rollout, init = build_rollout(env, cfg, num_envs=2, unroll_len=3)
    col = JitCollector(TorchVectorEnv(env, 2), cfg, unroll_len=3)
    _, t1, _ = rollout(theta, theta, init(torch.Generator()), torch.Generator().manual_seed(1))
    _, t2, _ = col.collect(theta, theta, col.init_carry(torch.Generator()),
                           torch.Generator().manual_seed(1))
    _same_tree(t1, t2, "build_rollout")
    served, init = build_served_rollout(env, num_envs=2, unroll_len=3)
    col = ServedCollector(TorchVectorEnv(env, 2), unroll_len=3)
    _, t1, _ = served(StubServer(5), "theta", "phi", init(torch.Generator()), torch.Generator())
    _, t2, _ = col.collect(StubServer(5), "theta", "phi", col.init_carry(torch.Generator()),
                           torch.Generator())
    _same_tree(t1, t2, "build_served_rollout")


class RecordingVectorEnv(TorchVectorEnv):
    """Keeps every action array the collector steps the env with."""

    def __init__(self, env, num_envs):
        super().__init__(env, num_envs)
        self.actions = []

    def step(self, states, actions, gen):
        self.actions.append(actions.clone().numpy())
        return super().step(states, actions, gen)


@pytest.fixture(scope="module")
def fp32_params():
    cfg = dataclasses.replace(jax_get_arch("tleague-policy-s"), compute_dtype="float32")
    theta = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    phi = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), cfg))
    return cfg, theta, phi


@pytest.mark.parametrize("name,T", [("rps", 10), ("duel", 6), ("pommerman_lite", 8)])
def test_jit_collector_replays_through_repro(name, T, fp32_params):
    jcfg, jtheta, jphi = fp32_params
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    theta, phi = from_reference(jtheta, "cpu"), from_reference(jphi, "cpu")
    jvec, _, (jstates, jobs), carry = _start(name, seed=8)
    fresh, fresh_obs = jstates, jobs
    venv = RecordingVectorEnv(make_env(name, device="cpu"), E)
    col = JitCollector(venv, cfg, unroll_len=T)
    (states, obs), traj, ep = col.collect(theta, phi, carry, torch.Generator().manual_seed(3))
    k = venv.spec.team_size
    assert {k: (v.shape, v.dtype) for k, v in traj.items()} == {
        k: (shape, np.dtype(dt)) for k, shape, dt in (
            ("obs", (E * k, T, venv.spec.obs_len), np.int32),
            ("actions", (E * k, T), np.int32),
            ("behavior_logp", (E * k, T), np.float32),
            ("behavior_values", (E * k, T), np.float32),
            ("rewards", (E * k, T), np.float32),
            ("done", (E * k, T), np.bool_),
            ("bootstrap_value", (E * k,), np.float32))}
    # replay every recorded action through repro's env from the same start;
    # pommerman only up to its first autoreset (the resets' draws differ)
    upto, obs_rows = T, []
    for t, a in enumerate(venv.actions):
        obs_rows.append(np.asarray(jobs)[:, :k])
        jstates, jobs2, jr, jd, _ = jvec.step(jstates, jnp.asarray(a), jax.random.PRNGKey(t))
        rows = np.asarray(obs_rows[-1]).reshape(E * k, -1)
        assert np.array_equal(rows, traj["obs"][:, t]), (name, t)
        assert np.array_equal(np.asarray(jr)[:, :k].reshape(-1), traj["rewards"][:, t])
        assert np.array_equal(np.repeat(np.asarray(jd), k), traj["done"][:, t])
        jstates, jobs = jvec.autoreset(jd, fresh, fresh_obs, jstates, jobs2)
        if name == "pommerman_lite" and np.asarray(jd).any():
            upto = t + 1
            break
    if upto == T:
        assert np.array_equal(np.asarray(jobs), obs.numpy())
    # logp and values of the recorded actions under repro's policy
    pol = jax_make_obs_policy(jcfg, venv.spec.num_actions)
    all_obs = jnp.asarray(traj["obs"][:, :upto].reshape(-1, venv.spec.obs_len))
    lg, v = pol.logits_values(jtheta, all_obs)
    logp = jax_categorical_logp(lg, jnp.asarray(traj["actions"][:, :upto].reshape(-1)))
    assert np.abs(np.asarray(logp) - traj["behavior_logp"][:, :upto].reshape(-1)).max() <= TOL
    assert np.abs(np.asarray(v) - traj["behavior_values"][:, :upto].reshape(-1)).max() <= TOL
    _, v_boot = pol.logits_values(jtheta, jnp.asarray(obs[:, :k].reshape(E * k, -1).numpy()))
    assert np.abs(np.asarray(v_boot) - traj["bootstrap_value"]).max() <= TOL
    assert ep["done"].shape == (T, E) and ep["outcome"].dtype == np.int32


def _league(params):
    league = LeagueMgr(seed=0)
    league.add_learning_agent("main", params, game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    return league


def _results(league):
    got = []
    orig = league.report_result
    league.report_result = lambda r: (got.append(r), orig(r))[1]
    return got


def test_actor_reports_repro_s_episode_results():
    """rps episodes end every 8 steps whatever the actions, so both Actors
    report the same results; each is one finished episode."""
    from repro.actors import Actor as JaxActor
    from repro.core import LeagueMgr as JaxLeagueMgr
    from repro.core import SelfPlayPFSPGameMgr as JaxSPPFSP

    jcfg = jax_get_arch("tleague-policy-s")
    jleague = JaxLeagueMgr(seed=0)
    jleague.add_learning_agent("main", jax_init_params(jax.random.PRNGKey(0), jcfg),
                               game_mgr=JaxSPPFSP(payoff=None))
    jgot = _results(jleague)
    jactor = JaxActor(jax_make_env("rps"), jcfg, jleague, num_envs=E, unroll_len=10)
    cfg = get_arch("tleague-policy-s")
    league = _league(init_params(torch.Generator().manual_seed(0), cfg))
    got = _results(league)
    actor = Actor(make_env("rps", device="cpu"), cfg, league, num_envs=E, unroll_len=10,
                  device="cpu")
    for _ in range(3):
        jactor.run_segment()
        traj, task = actor.run_segment()
    key = lambda r: (str(r.learner_key), tuple(map(str, r.opponent_keys)), r.outcome,
                     r.episode_len, r.task_id)
    assert [key(r) for r in got] == [key(r) for r in jgot]
    assert len(got) == E * (3 * 10 // 8)         # each slot finished 3 episodes
    assert actor.frames_produced == 3 * E * 10


def test_served_actor_refreshes_the_server_from_the_pool():
    cfg = get_arch("tleague-policy-s")
    env = make_env("pommerman_lite", device="cpu")
    league = _league(init_params(torch.Generator().manual_seed(0), cfg))
    server = InfServer(cfg, env.spec.num_actions, device="cpu", max_batch=256)
    actor = Actor(env, cfg, league, num_envs=2, unroll_len=3, inf_server=server, device="cpu")
    traj, task = actor.run_segment()
    assert server.batches_run == 3 + 1               # T + 1 flushes, theta and phi coalesced
    assert server.last_batch_models == 1             # the bootstrap: theta alone
    man = league.model_pool.manifest(task.learner_key)
    assert server.has_model(task.learner_key, man.tree_hash)
    assert traj["obs"].shape == (4, 3, 26) and traj["actions"].dtype == np.int32
    # the learner pushes new theta: the next segment hot-swaps it in
    theta = {k: v for k, v in league.model_pool.pull(task.learner_key).items()}
    theta["final_norm"] = {"scale": theta["final_norm"]["scale"] * 2}
    league.model_pool.push(task.learner_key, theta, step=1)
    swaps = server.swaps
    actor.run_segment()
    assert server.swaps == swaps + 1
    assert server.has_model(task.learner_key, build_manifest(theta, 0).tree_hash)


def test_actor_defaults_to_cuda_and_checks_its_env(monkeypatch):
    cfg = get_arch("tleague-policy-s")
    league = _league(init_params(torch.Generator().manual_seed(0), cfg))
    env = make_env("rps", device="cpu")
    with pytest.raises(ValueError, match="env"):
        Actor(env, cfg, league, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Actor(env, cfg, league)

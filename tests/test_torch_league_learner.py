"""The port's Learner against the JAX package's, on the CPU.

One league loop runs in each package from the same params (made by
`repro.models.init_params`, carried over with `from_reference`) and the same
segments (from a numpy seed): a `LeagueMgr` with a self-play PFSP agent, an
env train step (tleague-policy-s at fp32 compute, PPO + GAE,
`adamw(3e-4, clip_norm=1.0)`) and a `Learner` over a blocking DataServer.
Three rounds of (`put`, `learn`), then `end_learning_period`, then one more
round. `repro`'s Learner runs under `dispatch.force("interpret")`, with its
own fresh step closure (the JAX jit cache ignores the dispatch mode); the
port's runs with `device="cpu"`.

Tolerances as in `tests/test_torch_learner.py`: the metrics within 1e-4,
and the params within 0.1 * LR per step taken (Adam's step is about LR per
element, so a wrong step shows). Pool versions, step counts, prefetch
counts and the league state must be equal. The prioritized-replay loop
(`priority_fn`) is held bitwise with a stub train step.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import LeagueMgr as JaxLeagueMgr
from repro.core import SelfPlayPFSPGameMgr as JaxSPPFSP
from repro.kernels import dispatch as jax_dispatch
from repro.learners import DataServer as JaxDataServer
from repro.learners import Learner as JaxLearner
from repro.learners.steps import build_env_train_step as jax_env_step
from repro.models import init_params as jax_init
from repro.optim import adamw as jax_adamw
from repro.params import build_manifest as jax_build_manifest
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
from repro_torch.learners import DataServer, Learner, build_env_train_step
from repro_torch.optim import adamw
from repro_torch.params import build_manifest, from_reference
from repro_torch.utils import tree_flatten_with_path

TOL = 1e-4
LR = 3e-4
NUM_ACTIONS = 6
OBS_LEN = 26
B, T = 4, 4


def _segment(rng):
    return {"obs": rng.integers(0, 16, (B, T, OBS_LEN)).astype(np.int32),
            "actions": rng.integers(0, NUM_ACTIONS, (B, T)).astype(np.int32),
            "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 1.0).astype(np.float32),
            "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "done": rng.random((B, T)) < 0.2,
            "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}


def _flat(tree):
    return {p: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float32)
            for p, x in tree_flatten_with_path(tree)[0]}


def _observe(learner, metrics):
    lg = learner.league
    return {"params": _flat(learner.params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "step_count": learner.step_count,
            "key": str(learner.current_key),
            "version": lg.model_pool.version(learner.current_key),
            "state": lg.league_state(),
            "prefetch": (learner.data_server.prefetch_hits, learner.data_server.prefetch_misses),
            "pool_manifest": lg.model_pool.manifest(learner.current_key)}


def _loop(league, learner):
    rng = np.random.default_rng(31)
    out = []
    for i in range(4):
        if i == 3:
            out.append(("freeze", str(learner.end_learning_period(reason="test"))))
        learner.data_server.put(_segment(rng))
        out.append(_observe(learner, learner.learn()))
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jcfg))

    with jax_dispatch.force("interpret"):
        jleague = JaxLeagueMgr(seed=5)
        jp = jax.tree.map(jax.numpy.asarray, params)
        jleague.add_learning_agent("main", jp, game_mgr=JaxSPPFSP(payoff=None))
        jopt = jax_adamw(LR, clip_norm=1.0)
        jlearner = JaxLearner(jleague, jax_env_step(jcfg, NUM_ACTIONS, jopt), jopt, jp,
                              data_server=JaxDataServer(seed=0))
        want = _loop(jleague, jlearner)

    league = LeagueMgr(seed=5)
    tp = from_reference(params, "cpu")
    league.add_learning_agent("main", tp, game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    opt = adamw(LR, clip_norm=1.0)
    learner = Learner(league, build_env_train_step(tcfg, NUM_ACTIONS, opt), opt, tp,
                      data_server=DataServer(seed=0, device="cpu"), device="cpu")
    got = _loop(league, learner)
    return want, got, learner


@pytest.mark.parametrize("i", [0, 1, 2, 4])
def test_learner_step_matches_jax(runs, i):
    want, got, _ = runs
    w, g = want[i], got[i]
    assert (g["step_count"], g["key"], g["version"], g["state"], g["prefetch"]) == \
        (w["step_count"], w["key"], w["version"], w["state"], w["prefetch"])
    assert g["metrics"].keys() == w["metrics"].keys()
    for k in w["metrics"]:
        np.testing.assert_allclose(g["metrics"][k], w["metrics"][k], atol=TOL, rtol=TOL, err_msg=k)
    assert g["params"].keys() == w["params"].keys()
    for k in w["params"]:
        np.testing.assert_allclose(g["params"][k], w["params"][k], atol=0.1 * LR * g["step_count"],
                                   rtol=0, err_msg=k)


def test_freeze_adopts_the_same_key(runs):
    want, got, learner = runs
    assert got[3] == want[3] == ("freeze", "main:0001")
    assert got[4]["state"]["frozen_pool"] == ["main:0000"]
    # fresh moments after the freeze: one step taken since
    assert int(learner.opt_state["step"]) == 1


def test_pool_manifests_share_paths_with_jax(runs):
    """The pool's manifests name the same leaves in both packages, and the
    port's pushed params hash as the port's working copy does."""
    want, got, learner = runs
    assert list(got[2]["pool_manifest"].leaf_hashes) == list(want[2]["pool_manifest"].leaf_hashes)
    man = build_manifest(learner.params, 0)
    assert man.tree_hash == learner.league.model_pool.manifest(learner.current_key).tree_hash
    assert list(man.leaf_hashes) == list(jax_build_manifest(
        jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jax_arch("tleague-policy-s"))),
        0).leaf_hashes)


def test_priority_loop_matches_jax():
    """`priority_fn` closes the prioritized-replay loop alike in both
    Learners: off-policy draws from a prioritized DataServer, priorities
    from each consumed batch (integer sums, so exact in both packages)
    written back against the slots and generations of that batch. A stub
    train step keeps the model out of it; the sampler's sum tree, the
    sample info and the feed counters must be equal bitwise."""
    import jax.numpy as jnp

    def run(league, learner_cls, ds, params, step, prio):
        league.add_learning_agent("main", params)
        opt = types.SimpleNamespace(init=lambda p: {})
        learner = learner_cls(league, step, opt, params, data_server=ds, priority_fn=prio,
                              **({"device": "cpu"} if learner_cls is Learner else {}))
        rng = np.random.default_rng(33)
        out = []
        for _ in range(6):
            ds.put(_segment(rng))
            learner.learn(2)
            info = ds.last_sample_info()
            out.append((info["slots"].tolist(), info["gen"].tolist(), info["weights"].tolist(),
                        ds.sampler._tree._value.tolist()))
        th = ds.throughput()
        return out, (th["prefetch_hits"], th["prefetch_misses"], learner.step_count)

    kw = dict(capacity_frames=3 * B * T, seed=4, blocking=False, sampler="prioritized")
    with jax_dispatch.force("interpret"):
        want = run(JaxLeagueMgr(), JaxLearner, JaxDataServer(**kw), {"w": jnp.zeros(2)},
                   lambda p, s, traj: (p, s, {"loss": jnp.sum(traj["rewards"])}),
                   lambda traj, m: jnp.sum(traj["actions"], axis=1) + 1)
    got = run(LeagueMgr(), Learner, DataServer(device="cpu", **kw), {"w": torch.zeros(2)},
              lambda p, s, traj: (p, s, {"loss": traj["rewards"].sum()}),
              lambda traj, m: traj["actions"].sum(dim=1) + 1)
    assert got == want
    assert got[1][2] == 12

"""The port's envs against the JAX package's, on the CPU.

Each env starts from `repro`'s reset states (vmapped over 8 slots, carried
over as numpy) and both packages step them through 64 steps of actions drawn
from a numpy seed; a finished slot is reset in both to the same fresh
`repro` state through each package's `autoreset`. Every state leaf, the
observations, `done` and the info entries are held bitwise, with their
dtypes; rewards within 1e-6. Seeded draws are never compared: `jax.random`
and `torch` streams differ, so the port's own reset is held to its
invariants (rigid and spawn-safe cells, wood density) instead.

Also the mechanics cases of `tests/test_envs.py` (pommerman bomb kill and
team reward, rigid walls, duel fire and frag), and `HostVectorEnv` against
`TorchVectorEnv`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import JaxVectorEnv
from repro.envs import make_env as jax_make_env
from repro_torch.envs import HostVectorEnv, TorchVectorEnv, make_env
from repro_torch.envs.pommerman_lite import _spawn_safe_mask
from repro_torch.envs.scripted import SCRIPTED, duel_bot

E, STEPS = 8, 64
REWARD_TOL = 1e-6
NAMES = ["rps", "rps_biased", "duel", "pommerman_lite"]


def _to_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _same(jax_tree, port_tree, what):
    assert set(jax_tree) == set(port_tree), what
    for k, v in jax_tree.items():
        a, b = np.asarray(v), port_tree[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, k)


@pytest.mark.parametrize("name", NAMES)
def test_steps_bitwise_equal_to_repro(name):
    jenv, env = jax_make_env(name), make_env(name, device="cpu")
    jvec, vec = JaxVectorEnv(jenv, E, jit=True), TorchVectorEnv(env, E)
    fresh, fresh_obs = jvec.reset(jax.random.PRNGKey(5))
    jst, jobs = fresh, fresh_obs
    st, obs = _to_port(fresh), torch.from_numpy(np.array(fresh_obs))
    rng = np.random.default_rng(17)
    done_total, reward_mass = 0, 0.0
    for t in range(STEPS):
        a = rng.integers(0, env.spec.num_actions, (E, env.spec.num_agents)).astype(np.int32)
        jst, jobs, jr, jd, jinfo = jvec.step(jst, jnp.asarray(a), jax.random.PRNGKey(t))
        st, obs, r, d, info = vec.step(st, torch.from_numpy(a), None)
        _same(jst, st, f"{name} step {t} state")
        assert obs.dtype == torch.int32 and np.array_equal(np.asarray(jobs), obs.numpy())
        assert r.dtype == torch.float32 and d.dtype == torch.bool
        assert np.abs(np.asarray(jr) - r.numpy()).max() <= REWARD_TOL
        assert np.array_equal(np.asarray(jd), d.numpy())
        _same(jinfo, info, f"{name} step {t} info")
        done_total += int(d.sum())
        reward_mass += float(r.abs().sum())
        # autoreset to the same fresh state in both packages
        jst, jobs = jvec.autoreset(jd, fresh, fresh_obs, jst, jobs)
        st, obs = vec.autoreset(d, _to_port(fresh), torch.from_numpy(np.array(fresh_obs)),
                                st, obs)
        _same(jst, st, f"{name} step {t} autoreset")
        assert np.array_equal(np.asarray(jobs), obs.numpy())
    assert done_total > 0 and reward_mass > 0      # episodes ended and paid out


def test_pommerman_parity_covers_blasts_and_kills():
    """A longer bomb-heavy parity run with autoresets, checked to reach the
    order-free tensor paths: bombs placed, wood burnt, agents killed."""
    jenv, env = jax_make_env("pommerman_lite"), make_env("pommerman_lite", device="cpu")
    jvec, vec = JaxVectorEnv(jenv, 32, jit=True), TorchVectorEnv(env, 32)
    fresh, fresh_obs = jvec.reset(jax.random.PRNGKey(2))
    jst, jobs, st, obs = fresh, fresh_obs, _to_port(fresh), torch.from_numpy(np.array(fresh_obs))
    rng = np.random.default_rng(3)
    seen = {"placed": 0, "wood": 0, "killed": 0}
    for t in range(48):
        a = rng.choice([0, 1, 2, 3, 4, 5, 5], size=(32, 4)).astype(np.int32)
        before = st
        jst, jobs, _, jd, _ = jvec.step(jst, jnp.asarray(a), jax.random.PRNGKey(t))
        st, obs, _, d, _ = vec.step(st, torch.from_numpy(a), None)
        _same(jst, st, "pommerman")
        seen["placed"] += int((st["bomb_timer"] == 3).sum())
        seen["wood"] += int(((before["board"] == 2) & (st["board"] == 0)).sum())
        seen["killed"] += int((before["alive"] & ~st["alive"]).sum())
        jst, jobs = jvec.autoreset(jd, fresh, fresh_obs, jst, jobs)
        st, obs = vec.autoreset(d, _to_port(fresh), torch.from_numpy(np.array(fresh_obs)),
                                st, obs)
    assert all(n > 0 for n in seen.values()), seen


def test_pommerman_chain_detonation_bitwise():
    """Bombs laid by hand. Slot 0: the bomb at (2, 2) goes off; its ray
    right burns the wood at (2, 3) and stops there, sparing agent 0 at
    (2, 4); its ray down reaches the bomb at (4, 2), which chains and kills
    agent 3 at (4, 4). Slot 1: two bombs go off together, the one at
    (2, 5) kills agent 0, and the chain kills agent 3 as in slot 0. The five dead bomb slots all sit on (0, 0), under
    agent 1."""
    jenv, env = jax_make_env("pommerman_lite"), make_env("pommerman_lite", device="cpu")
    jst, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(9), 2))
    st = {k: np.array(v) for k, v in jst.items()}
    st["board"][:, 2, 2:7] = [0, 2, 0, 0, 2]
    st["board"][:, 3, 2] = 0
    st["board"][:, 4, 2:5] = [2, 0, 0]
    st["pos"][:, :] = [[2, 4], [0, 0], [2, 8], [4, 4]]
    st["bomb_pos"][:, :3] = [[2, 2], [2, 5], [4, 2]]
    st["bomb_timer"][:, :3] = [[1, 3, 2], [1, 1, 4]]
    st["bomb_owner"][:, :3] = [[0, 2, 3], [1, 1, 0]]
    st["ammo"][:] = 0
    jst, pst = {k: jnp.asarray(v) for k, v in st.items()}, _to_port(st)
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(3):
        a = np.zeros((2, 4), np.int32)
        jst, jobs, jr, jd, jinfo = step(jst, jnp.asarray(a),
                                        jax.random.split(jax.random.PRNGKey(t), 2))
        pst, obs, r, d, info = env.step(pst, torch.from_numpy(a), None)
        _same(jst, pst, f"chain step {t}")
        assert np.array_equal(np.asarray(jobs), obs.numpy())
        assert np.abs(np.asarray(jr) - r.numpy()).max() <= REWARD_TOL
        _same(jinfo, info, f"chain step {t} info")
        if t == 0:
            assert pst["bomb_timer"][:, :3].tolist() == [[-1, 2, -1], [-1, -1, -1]]
            assert pst["alive"].tolist() == [[True, True, True, False],
                                             [False, True, True, False]]
            assert pst["board"][0, 2, 3] == 0 and pst["board"][0, 4, 2] == 0
            assert pst["ammo"].tolist() == [[1, 0, 0, 1], [1, 2, 0, 0]]


@pytest.mark.parametrize("name", NAMES)
def test_env_protocol_shapes_and_dtypes(name):
    env = make_env(name, device="cpu")
    spec = env.spec
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 3)
    assert obs.shape == (3, spec.num_agents, spec.obs_len) and obs.dtype == torch.int32
    assert bool((obs >= 0).all()) and bool((obs < spec.obs_vocab).all())
    assert all(v.shape[0] == 3 for v in state.values())
    acts = torch.zeros((3, spec.num_agents), dtype=torch.int32)
    state, obs, rew, done, info = env.step(state, acts, gen)
    assert rew.shape == (3, spec.num_agents) and rew.dtype == torch.float32
    assert done.shape == (3,) and done.dtype == torch.bool
    assert all(v.shape[0] == 3 and v.dtype == torch.int32 for v in info.values())


def test_pommerman_reset_invariants_and_wood_density():
    env = make_env("pommerman_lite", device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(1), 256)
    board = state["board"]
    assert board.dtype == torch.int8 and board.shape == (256, 9, 9)
    g = torch.arange(9)
    rigid = (g[:, None] % 2 == 1) & (g[None, :] % 2 == 1)
    safe = _spawn_safe_mask()
    assert bool((board[:, rigid] == 1).all())
    assert bool((board[:, safe] == 0).all())
    free = ~rigid & ~safe
    density = (board[:, free] == 2).float().mean().item()
    assert abs(density - 0.35) <= 0.05, density
    assert bool((board[:, free] != 1).all())
    # spawns, every agent alive with one bomb, no bomb live
    assert state["pos"].tolist() == [[[0, 0], [8, 8], [0, 8], [8, 0]]] * 256
    assert bool(state["alive"].all()) and bool((state["ammo"] == 1).all())
    assert bool((state["bomb_timer"] == -1).all()) and bool((state["t"] == 0).all())


def test_pommerman_bomb_kills_and_team_reward():
    env = make_env("pommerman_lite", device="cpu", wood_prob=0.0, shaping=0.0)
    gen = torch.Generator().manual_seed(11)
    state, _ = env.reset(gen, 2)
    idle = torch.zeros((2, 4), dtype=torch.int32)
    drop = idle.clone()
    drop[:, 0] = 5                              # agent 0 drops a bomb at its corner and stays
    state, _, rew, done, _ = env.step(state, drop, gen)
    assert state["ammo"][:, 0].tolist() == [0, 0]
    for _ in range(5):
        state, _, rew, done, _ = env.step(state, idle, gen)
    assert not bool(state["alive"][:, 0].any())  # suicided
    assert bool(state["alive"][:, 1:].all())
    assert state["ammo"][:, 0].tolist() == [1, 1]   # the exploded bomb came back
    for _ in range(120):
        if bool(done.all()):
            break
        state, _, rew, done, info = env.step(state, idle, gen)
    assert bool(done.all())
    assert float(rew.sum(1).abs().max()) < 1e-6  # zero-sum team terminal reward


def test_pommerman_movement_blocked_by_rigid():
    env = make_env("pommerman_lite", device="cpu", wood_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(gen, 1)
    a = torch.zeros((1, 4), dtype=torch.int32)
    a[0, 0] = 2                                       # down -> (1, 0)
    state, *_ = env.step(state, a, gen)
    assert state["pos"][0, 0].tolist() == [1, 0]
    a[0, 0] = 4                                       # right -> (1, 1) is rigid
    state, *_ = env.step(state, a, gen)
    assert state["pos"][0, 0].tolist() == [1, 0]


def test_duel_fire_and_frag():
    env = make_env("duel", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(gen, 1)
    state["pos"] = torch.tensor([[[4, 0], [4, 3], [0, 8], [8, 8]]], dtype=torch.int32)
    state["facing"] = torch.tensor([[1, 3, 2, 0]], dtype=torch.int32)   # 0 faces E toward 1
    state, obs, rew, done, info = env.step(state, torch.tensor([[4, 0, 0, 0]]), gen)
    assert int(info["frags"][0, 0]) == 1
    assert float(rew[0, 0]) > 0 and float(rew[0, 1]) < 0
    assert tuple(state["pos"][0, 1].tolist()) in {(0, 0), (0, 8), (8, 0), (8, 8)}


@pytest.mark.parametrize("name", ["rps", "duel"])
def test_host_vector_env_equals_torch_vector_env(name):
    """Deterministic resets: the per-slot host loop and the batched env give
    the same episodes, autoresets included."""
    env = make_env(name, device="cpu")
    host, vec = HostVectorEnv(env, 4), TorchVectorEnv(env, 4)
    gen = torch.Generator().manual_seed(0)
    hs, hobs = host.reset(gen)
    ts, tobs = vec.reset(gen)
    rng = np.random.default_rng(2)
    for _ in range(3 * env.spec.max_steps // 2):
        a = rng.integers(0, env.spec.num_actions, (4, env.spec.num_agents)).astype(np.int32)
        hs, hobs, hr, hd, hout = host.step_autoreset(hs, a, gen)
        ts, tobs, tr, td, tout = vec.step_autoreset(ts, torch.from_numpy(a), gen)
        assert np.array_equal(hobs, tobs.numpy()) and np.array_equal(hr, tr.numpy())
        assert np.array_equal(hd, td.numpy()) and np.array_equal(hout, tout.numpy())
        for k in ts:
            assert np.array_equal(np.concatenate([s[k].numpy() for s in hs]), ts[k].numpy())


def test_host_vector_env_steps_pommerman_like_the_batched_env():
    env = make_env("pommerman_lite", device="cpu")
    host, vec = HostVectorEnv(env, 4), TorchVectorEnv(env, 4)
    ts, tobs = vec.reset(torch.Generator().manual_seed(4))
    hs = [{k: v[i:i + 1] for k, v in ts.items()} for i in range(4)]
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = rng.integers(0, 6, (4, 4)).astype(np.int32)
        hs, hobs, hr, hd, hinfo = host.step(hs, a, None)
        ts, tobs, tr, td, tinfo = vec.step(ts, torch.from_numpy(a), None)
        assert np.array_equal(hobs, tobs.numpy()) and np.array_equal(hr, tr.numpy())
        assert np.array_equal(hd, td.numpy())
        assert np.array_equal(hinfo["outcome"], tinfo["outcome"].numpy())


def test_scripted_bots_are_repro_s():
    from repro.envs import scripted as jax_scripted

    env = make_env("duel", device="cpu")
    _, obs = env.reset(torch.Generator(), 2)
    rows = obs.reshape(-1, env.spec.obs_len).numpy()
    for name, bot in SCRIPTED.items():
        want = jax_scripted.SCRIPTED[name](rows, np.random.default_rng(0))
        assert np.array_equal(bot(rows, np.random.default_rng(0)), want)
    assert duel_bot(rows, np.random.default_rng(1)).dtype == np.int32


def test_make_env_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_env("rps")
    assert make_env("rps", device="cpu").device.type == "cpu"

"""The port's mesh on the CPU: multi-rank gloo groups, spawned, against the
single-device port and `repro`'s single-device results.

`repro`'s own mesh path is red on the installed jax (its two sharded
transport tests fail), so every sharded result here is held against
single-device outputs: the port's, and `repro`'s where JAX is compared.
Each spawned group initialises through a `file://` store in the test's
`tmp_path` (no fixed port, so parallel workers cannot collide), and is
joined with a deadline. Cases:
  (i)   the sharded serving forward at policy-s on (4, 1) and (2, 2),
        θ alone then θ and φ grouped, within 1e-4 of the single-device
        port (actions equal) and of `repro`'s policy;
  (ii)  `moe_apply_ep` on (2, 4) for qwen3-moe and kimi-k2 at `.smoke()`
        against the port's `moe_apply` and `repro`'s, with the same
        weights: `tests/test_moe_ep.py`'s bounds;
  (iii) `make_dryrun_step`'s train step on (2, 2), FSDP on: policy-m at a
        tiny train shape and qwen3-moe `.smoke()` with `moe_ep=True`, fp32,
        loss and every grad leaf within 1e-4 of the single-device port and
        of `repro`'s step; and qwen3-moe without `moe_ep` on (2, 1) and
        (2, 2), at its own capacity factor, on a batch whose data shards
        route unevenly: the global capacity's drops, as GSPMD's;
  (iv)  `InfServer(mesh=make_local_mesh("cpu"))` at world 1 against
        `mesh=None`, `repro`'s local-mesh sequence; and the dry-run
        factory's prefill and decode fns on (2, 2) against the single
        device;
  (v)   `run_multiprocess(..., served=True, sharded=True)` shuts down
        cleanly.
"""
import contextlib
import dataclasses
import time
import weakref

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

A = 6
L_OBS = 26
TOL = 1e-4


# -- spawning --------------------------------------------------------------------

def _spawn(fn, world, *args, timeout=110.0):
    """Run fn(rank, world, *args) in `world` spawned processes; fail (and
    kill them) past the deadline. A rank's exception fails the test."""
    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"a spawned group of {world} did not finish in {timeout} s")


def _init(rank, world, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def _done():
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# -- (i) and (iv): the sharded serving forward ---------------------------------------

def _policy_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")


def _serve_sequence(cfg, theta, phi, obs_a, obs_b, mesh):
    """`repro`'s local-mesh sequence: θ alone, then θ and φ in one flush."""
    from repro_torch.infserver import InfServer
    s = InfServer(cfg, A, max_batch=64, seed=3, mesh=mesh, device="cpu")
    s.register_model("theta", theta)
    out = [s.get(s.submit(obs_a, model="theta"))]
    s.register_model("phi", phi)
    t1, t2 = s.submit(obs_a, model="theta"), s.submit(obs_b, model="phi")
    s.flush()
    out += [s.get(t1), s.get(t2)]
    return out, s.stats()


def _serve_worker(rank, world, store, shape, theta, phi, obs_a, obs_b, out):
    _init(rank, world, store)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.params import from_reference
    mesh = make_local_mesh("cpu", shape=shape)
    res, st = _serve_sequence(_policy_cfg(), from_reference(theta, "cpu"),
                              from_reference(phi, "cpu"), obs_a, obs_b, mesh)
    assert st["sharded"] and st["mesh_shape"] == list(shape)
    if rank == 0:
        np.savez(out, *[x for r in res for x in r])
    _done()


def _serve_setup():
    import jax
    from repro.configs import get_arch as jax_arch
    from repro.models import init_params as jax_init
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), compute_dtype="float32")
    theta, phi = (jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(s), jcfg))
                  for s in (0, 1))
    rng = np.random.default_rng(7)
    obs_a = rng.integers(0, 512, (5, L_OBS)).astype(np.int32)
    obs_b = rng.integers(0, 512, (3, L_OBS)).astype(np.int32)
    return jcfg, theta, phi, obs_a, obs_b


def _check_serving(got, single, jcfg, theta, phi, obs_a, obs_b):
    import jax.numpy as jnp
    from repro.actors.policy import make_obs_policy as jax_policy
    from repro.rl.distributions import categorical_logp
    for (a, logp, v), (a0, logp0, v0) in zip(got, single):
        np.testing.assert_array_equal(a, a0)
        np.testing.assert_allclose(logp, logp0, atol=TOL, rtol=0)
        np.testing.assert_allclose(v, v0, atol=TOL, rtol=0)
    for (a, logp, v), params, obs in zip(got, (theta, theta, phi), (obs_a, obs_a, obs_b)):
        jl, jv = jax_policy(jcfg, A).logits_values(params, jnp.asarray(obs))
        np.testing.assert_allclose(v, np.asarray(jv), atol=TOL, rtol=0)
        np.testing.assert_allclose(logp, np.asarray(categorical_logp(jl, jnp.asarray(a))),
                                   atol=TOL, rtol=0)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_serving_matches_single_device_and_repro(shape, tmp_path):
    from repro_torch.params import from_reference
    jcfg, theta, phi, obs_a, obs_b = _serve_setup()
    out = tmp_path / "out.npz"
    _spawn(_serve_worker, shape[0] * shape[1], str(tmp_path / "store"), shape,
           theta, phi, obs_a, obs_b, str(out))
    z = np.load(out)
    flat = [z[f"arr_{i}"] for i in range(9)]
    got = [tuple(flat[3 * i:3 * i + 3]) for i in range(3)]
    single, _ = _serve_sequence(_policy_cfg(), from_reference(theta, "cpu"),
                                from_reference(phi, "cpu"), obs_a, obs_b, None)
    _check_serving(got, single, jcfg, theta, phi, obs_a, obs_b)


@pytest.mark.timeout(120)
def test_infserver_on_a_world_of_one_matches_mesh_none():
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh
    from repro_torch.params import from_reference
    jcfg, theta, phi, obs_a, obs_b = _serve_setup()
    cfg = _policy_cfg()
    th, ph = from_reference(theta, "cpu"), from_reference(phi, "cpu")
    single, st0 = _serve_sequence(cfg, th, ph, obs_a, obs_b, None)
    mesh = make_local_mesh("cpu")
    try:
        got, st = _serve_sequence(cfg, th, ph, obs_a, obs_b, mesh)
    finally:
        close_local_mesh()
    assert st["sharded"] is True and st["mesh_shape"] == [1, 1]
    assert st0["sharded"] is False and st0["mesh_shape"] is None
    _check_serving(got, single, jcfg, theta, phi, obs_a, obs_b)


def test_close_local_mesh_ends_only_a_group_it_started():
    """`close_local_mesh` tears down the world of one that `make_local_mesh`
    started, and leaves up a group that its caller started."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        make_local_mesh("cpu")
        close_local_mesh()
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    make_local_mesh("cpu")
    assert dist.is_initialized()
    close_local_mesh()
    assert not dist.is_initialized()


# -- (ii) expert-parallel MoE on (2, 4) ---------------------------------------------

def _moe_cfg(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).smoke()


def _moe_worker(rank, world, store, arch, p_np, x_np, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.params import from_reference
    from repro_torch.utils import tree_leaves, tree_map
    cfg = _moe_cfg(arch)
    mesh = make_local_mesh("cpu", shape=(2, 4))
    p = from_reference(p_np, "cpu")
    specs = SH.param_shardings({"blocks": {"moe": tree_map(lambda t: t[None], p)}},
                               cfg, mesh)["blocks"]["moe"]
    specs = SH.map_specs(lambda s: s[1:], specs)                   # unstacked
    pd = tree_map(lambda t: t.detach().requires_grad_(True), SH.distribute(p, specs, mesh))
    B_l = x_np.shape[0] // 2
    d = SH.axis_index(mesh, "data")
    x = torch.from_numpy(x_np[d * B_l:(d + 1) * B_l])
    with SH.data_parallel(mesh, ("data",)):
        y, aux = moe.moe_apply_ep(pd, cfg, x, mesh)
        loss = SH.batch_sum(y.sum())
    grads = torch.autograd.grad(loss / mesh.size(), tree_leaves(pd))
    y_all = SH.all_gather(y.detach(), 0, mesh, ("data",))
    full = [g.full_tensor().numpy() for g in grads]
    if rank == 0:
        np.savez(out, y_all.numpy(), aux.detach().numpy(), *full)
    _done()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_moe_apply_ep_matches_moe_apply_and_repro(arch, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_arch
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    from repro_torch.params import from_reference
    from repro_torch.utils import tree_leaves, tree_map

    jcfg, cfg = jax_arch(arch).smoke(), _moe_cfg(arch)
    p_np = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x_np = np.random.default_rng(1).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    out = tmp_path / "out.npz"
    _spawn(_moe_worker, 8, str(tmp_path / "store"), arch, p_np, x_np, str(out))
    z = np.load(out)
    y1, a1 = z["arr_0"], z["arr_1"]
    g1 = [z[f"arr_{i}"] for i in range(2, len(z.files))]

    # the port's routed path, single device
    p = tree_map(lambda t: t.requires_grad_(True), from_reference(p_np, "cpu"))
    y0, a0 = moe.moe_apply(p, cfg, torch.from_numpy(x_np))
    g0 = torch.autograd.grad(y0.sum(), tree_leaves(p))
    # repro's
    jy, ja = jax_moe.moe_apply(p_np, jcfg, jnp.asarray(x_np))
    jg = jax.grad(lambda q: jax_moe.moe_apply(q, jcfg, jnp.asarray(x_np))[0].sum())(p_np)
    jg = tree_leaves(from_reference(jax.tree.map(np.asarray, jg), "cpu"))   # port's leaf order
    for ref_y, ref_a, ref_g in ((y0.detach().numpy(), a0.item(), [g.numpy() for g in g0]),
                                (np.asarray(jy), float(ja), [g.numpy() for g in jg])):
        np.testing.assert_allclose(y1.reshape(ref_y.shape), ref_y, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(a1), ref_a, rtol=1e-4, atol=1e-5)
        assert len(g1) == len(ref_g)
        for a, b in zip(g1, ref_g):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


# -- (iii) the sharded train step on (2, 2) ------------------------------------------

TINY = ("tiny_train", 16, 4)


def _train_cfg(arch):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    cfg = cfg.smoke() if cfg.moe else dataclasses.replace(cfg, max_position=1 << 20)
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


def _train_batch(cfg):
    rng = np.random.default_rng(5)
    _, T, B = TINY
    f32 = lambda a: a.astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "behavior_logp": f32(-rng.random((B, T)) - 5.0),
            "behavior_values": f32(rng.standard_normal((B, T))),
            "rewards": f32(rng.standard_normal((B, T))),
            "discounts": f32(0.99 * (rng.random((B, T)) > 0.1)),
            "actions": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "bootstrap_value": f32(rng.standard_normal(B))}


def _tiny_shape():
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    INPUT_SHAPES[TINY[0]] = InputShape(*TINY, "train")


def _train_worker(rank, world, store, arch, params_np, batch_np, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.params import from_reference
    _tiny_shape()
    cfg = _train_cfg(arch)
    mesh = make_local_mesh("cpu", shape=(2, 2))
    built = make_dryrun_step(cfg, TINY[0], mesh, fsdp=True, moe_ep=bool(cfg.moe))
    pshard, oshard, bshard = built["in_shardings"]
    assert any("data" in s for s in SH.spec_items(pshard).values())          # FSDP on
    params = SH.distribute(from_reference(params_np, "cpu"), pshard, mesh)
    batch = SH.distribute({k: torch.from_numpy(v) for k, v in batch_np.items()}, bshard, mesh)
    with _gathers() as seen:
        loss, metrics, grads = built["fn"].value_and_grad(params, batch)
    _check_gathers(cfg, from_reference(params_np, "cpu"), seen)
    full = [g.full_tensor().numpy() for _, g in SH.leaves_with_path(grads)]
    # the whole step (the optimizer updates the DTensors) runs too
    from repro_torch.launch.steps import make_optimizer
    opt_state = SH.distribute(make_optimizer(cfg).init(from_reference(params_np, "cpu")),
                              oshard, mesh)
    new_params, new_state, m = built["fn"](params, opt_state, batch)
    assert int(new_state["step"].full_tensor()) == 1
    assert np.isfinite(float(m["grad_norm"].full_tensor()
                             if hasattr(m["grad_norm"], "full_tensor") else m["grad_norm"]))
    if rank == 0:
        np.savez(out, loss.numpy(), *full)
    _done()


@contextlib.contextmanager
def _gathers():
    """Record what a sharded step gathers: each leaf's shape as the rank
    computes with it, and the peak bytes of gathered leaves alive at once
    (a leaf counts until its tensor is freed)."""
    from repro_torch.distributed import sharding as SH
    seen = {"shapes": {}, "live": 0, "peak": 0}
    real = SH._Params.use

    def use(self, name, t, index_dim):
        out = real(self, name, t, index_dim)
        n = out.numel() * out.element_size()
        seen["live"] += n
        seen["peak"] = max(seen["peak"], seen["live"])
        weakref.finalize(out, lambda: seen.__setitem__("live", seen["live"] - n))
        seen["shapes"][name] = tuple(out.shape)
        return out
    SH._Params.use = use
    try:
        yield seen
    finally:
        SH._Params.use = real


def _check_gathers(cfg, params, seen):
    """FSDP and tensor parallelism on the (2, 2) mesh: no rank ever holds
    more gathered weights than one repeat unit and the heads in full, and
    each split leaf is used as this rank's half (heads, hidden, vocab,
    experts)."""
    from repro_torch.distributed import sharding as SH
    size = lambda tree: sum(t.numel() * t.element_size() for _, t in SH.leaves_with_path(tree))
    from repro_torch.utils import tree_map
    unit = max(size(tree_map(lambda t: t[r], params[g]))
               for g in ("dense_prefix", "blocks") if g in params
               for r in range(next(iter(SH.leaves_with_path(params[g])))[1].shape[0]))
    top = size({k: v for k, v in params.items() if k not in ("dense_prefix", "blocks")})
    assert 0 < seen["peak"] <= unit + top < size(params), (seen["peak"], unit, top)
    shapes = seen["shapes"]
    d, hd = cfg.d_model, cfg.head_dim
    assert shapes["blocks/sub0/attn/wq/w"] == (d, cfg.num_heads * hd // 2)
    assert shapes["blocks/sub0/attn/wo/w"] == (cfg.num_heads * hd // 2, d)
    assert shapes["lm_head/w"] == (d, cfg.vocab_size // 2)
    assert shapes["embed/table"] == (cfg.vocab_size // 2, d)
    if cfg.moe:
        assert shapes["blocks/sub0/moe/up"][0] == cfg.moe.num_experts // 2
    else:
        assert shapes["blocks/sub0/mlp/up/w"] == (d, cfg.d_ff // 2)


def _no_drops(cfg, params, batch):
    """Neither the global capacity nor the per-(data shard) one drops a
    choice on this batch (they differ by design): every MoE layer's
    routing, recorded on the single-device forward."""
    from repro_torch.models import forward_train, moe
    gates_seen = []
    real = moe.route_topk

    def spy(gates, k, capacity):
        out = real(gates, k, capacity)
        gates_seen.append((gates.detach(), capacity, bool(out[2].all())))
        return out
    moe.route_topk = spy
    try:
        forward_train(params, cfg, {"tokens": batch["tokens"]})
    finally:
        moe.route_topk = real
    e = cfg.moe
    assert gates_seen
    for gates, capacity, kept in gates_seen:
        assert kept, "the global capacity drops a choice"
        for shard in gates.chunk(2):                       # data = 2
            n = shard.shape[0]
            c_l = max(int(n * e.experts_per_token * e.capacity_factor / e.num_experts),
                      e.experts_per_token)
            top = torch.topk(shard, e.experts_per_token, dim=-1).indices.reshape(-1)
            assert int(torch.bincount(top, minlength=e.num_experts).max()) <= c_l


def _reference_steps(cfg, jcfg, params_np, batch_np):
    """(loss, grads) of the single-device port's seq train step and of
    `repro`'s (in interpret mode), the grads in `jax.tree_util`'s leaf
    order."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import dispatch as jax_dispatch
    from repro.learners.steps import build_seq_train_step as jax_seq_step
    from repro.optim import Optimizer as JaxOptimizer
    from repro.optim import adamw as jax_adamw
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.learners import build_seq_train_step
    from repro_torch.params import from_reference

    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    l0, _, g0 = build_seq_train_step(cfg, make_optimizer(cfg)).value_and_grad(
        from_reference(params_np, "cpu"), tb)
    g0 = [g.numpy() for _, g in SH.leaves_with_path(g0)]
    # repro's single-device step, its grads returned among the metrics
    opt = jax_adamw(3e-4, clip_norm=1.0)
    grab = JaxOptimizer(opt.init, lambda g, s, p: (*opt.update(g, s, p)[:2], {"grads": g}))
    asj = lambda t: jax.tree.map(jnp.asarray, t)
    with jax_dispatch.force("interpret"):
        _, _, jm = jax_seq_step(jcfg, grab, jit=True)(
            asj(params_np), grab.init(asj(params_np)), asj(batch_np))
    return float(l0), g0, [np.asarray(g) for g in jax.tree.leaves(jm["grads"])]


def _check_step(out, cfg, jcfg, params_np, batch_np):
    """The sharded step's loss and grads (rank 0's `.npz`) within 1e-4 of
    the single-device port's and `repro`'s."""
    z = np.load(out)
    loss1 = float(z["arr_0"])
    g1 = [z[f"arr_{i}"] for i in range(1, len(z.files))]
    l0, g0, jg = _reference_steps(cfg, jcfg, params_np, batch_np)
    np.testing.assert_allclose(loss1, l0, atol=TOL, rtol=TOL)
    assert len(g1) == len(g0) == len(jg)
    for a, b, c in zip(g1, g0, jg):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0)
        np.testing.assert_allclose(a, c, atol=TOL * scale, rtol=0)


def _jax_cfg(arch):
    from repro.configs import get_arch as jax_arch
    jcfg = jax_arch(arch)
    jcfg = jcfg.smoke() if jcfg.moe else dataclasses.replace(jcfg, max_position=1 << 20)
    return dataclasses.replace(jcfg, compute_dtype="float32", param_dtype="float32")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ["tleague-policy-m", "qwen3-moe-235b-a22b"])
def test_sharded_train_step_matches_single_device_and_repro(arch, tmp_path):
    import jax
    from repro.models import init_params as jax_init
    from repro_torch.params import from_reference

    cfg, jcfg = _train_cfg(arch), _jax_cfg(arch)
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jcfg))
    batch_np = _train_batch(cfg)
    if cfg.moe:
        _no_drops(cfg, from_reference(params_np, "cpu"),
                  {k: torch.from_numpy(v) for k, v in batch_np.items()})

    out = tmp_path / "out.npz"
    _spawn(_train_worker, 4, str(tmp_path / "store"), arch, params_np, batch_np, str(out))
    _check_step(out, cfg, jcfg, params_np, batch_np)


# -- the MoE's global capacity under a data-parallel scope ----------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"


def _with_capacity(cfg):
    """qwen3-moe's `.smoke()` (which lifts the capacity factor to 8 so that
    smoke routing never drops) at the arch's own capacity factor, 1.25."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))


def _uneven_batch(cfg):
    """`_train_batch` with data shard 0's rows (the first half) one token
    repeated: every position of those rows has the same hidden state in
    the first layer (attention over equal values returns that value), so
    all their choices go to the same top-k experts."""
    batch = _train_batch(cfg)
    B = batch["tokens"].shape[0]
    batch["tokens"][:B // 2] = 7
    return batch


def _drops_differ(cfg, params, batch, data=2):
    """Some MoE layer of the single-device forward keeps a choice that the
    per-(data shard) capacity would drop: the parent's rule differs here."""
    from repro_torch.models import forward_train, moe
    seen = []
    real = moe.route_topk

    def spy(gates, k, capacity):
        out = real(gates, k, capacity)
        seen.append((gates.detach(), out[2]))
        return out
    moe.route_topk = spy
    try:
        forward_train(params, cfg, {"tokens": batch["tokens"]})
    finally:
        moe.route_topk = real
    e = cfg.moe
    differ = False
    for gates, keep in seen:
        for shard, kept in zip(gates.chunk(data), keep.chunk(data)):
            c_l = max(int(shard.shape[0] * e.experts_per_token * e.capacity_factor
                          / e.num_experts), e.experts_per_token)
            differ |= not torch.equal(real(shard, e.experts_per_token, c_l)[2], kept)
    return differ


def _capacity_worker(rank, world, store, shape, params_np, batch_np, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.params import from_reference
    _tiny_shape()
    cfg = _with_capacity(_train_cfg(MOE_ARCH))
    mesh = make_local_mesh("cpu", shape=shape)
    built = make_dryrun_step(cfg, TINY[0], mesh, fsdp=True, moe_ep=False)
    _, _, bshard = built["in_shardings"]
    params = SH.distribute(from_reference(params_np, "cpu"), built["in_shardings"][0], mesh)
    batch = SH.distribute({k: torch.from_numpy(v) for k, v in batch_np.items()}, bshard, mesh)
    loss, _, grads = built["fn"].value_and_grad(params, batch)
    full = [g.full_tensor().numpy() for _, g in SH.leaves_with_path(grads)]
    if rank == 0:
        np.savez(out, loss.numpy(), *full)
    _done()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sharded_moe_routes_with_the_global_capacity(shape, tmp_path):
    """Without expert parallelism the sharded MoE keeps and drops what
    `repro`'s GSPMD `moe_apply` does over the global batch: on a batch whose
    data shards route so unevenly that the per-shard capacity would drop a
    choice the global one keeps, the sharded train step's loss and grads
    equal the single-device port's and `repro`'s."""
    import jax
    from repro.models import init_params as jax_init
    from repro_torch.params import from_reference

    cfg = _with_capacity(_train_cfg(MOE_ARCH))
    jcfg = _with_capacity(_jax_cfg(MOE_ARCH))
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jcfg))
    batch_np = _uneven_batch(cfg)
    assert _drops_differ(cfg, from_reference(params_np, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch_np.items()})
    out = tmp_path / "out.npz"
    _spawn(_capacity_worker, shape[0] * shape[1], str(tmp_path / "store"), shape,
           params_np, batch_np, str(out))
    _check_step(out, cfg, jcfg, params_np, batch_np)


# -- the dry-run factory's prefill and decode fns on (2, 2) ---------------------------

def _serve_step_worker(rank, world, store, out):
    _init(rank, world, store)
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    cfg, params, toks = _serve_step_inputs()
    mesh = make_local_mesh("cpu", shape=(2, 2))
    INPUT_SHAPES["tiny_prefill"] = InputShape("tiny_prefill", 16, 4, "prefill")
    INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 16, 4, "decode")
    pre = make_dryrun_step(cfg, "tiny_prefill", mesh)
    pd = SH.distribute(params, pre["in_shardings"][0], mesh)
    logits, values, state = pre["fn"](pd, SH.distribute({"tokens": toks},
                                                        pre["in_shardings"][1], mesh))
    dec = make_dryrun_step(cfg, "tiny_decode", mesh)
    from repro_torch.models import init_decode_state
    sd = SH.distribute(init_decode_state(cfg, 4, 16, device="cpu"), dec["in_shardings"][2], mesh)
    dl, dv, ds = dec["fn"](pd, SH.distribute(toks[:, :1], dec["in_shardings"][1], mesh), sd)
    full = [t.full_tensor().numpy() for t in (logits, values, dl, dv)]
    full += [t.full_tensor().numpy() for _, t in SH.leaves_with_path(ds)]
    if rank == 0:
        np.savez(out, *full)
    _done()


def _serve_step_inputs():
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke(), compute_dtype="float32",
                              param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)))
    return cfg, params, toks.int()


@pytest.mark.timeout(120)
def test_dryrun_prefill_and_decode_fns_run_sharded(tmp_path):
    """`make_dryrun_step`'s prefill and decode fns on (2, 2), DTensor params,
    batch and decode state: the last position's logits and values, a
    uniform decode step's logits, values and every state leaf equal to the
    single-device port's within 1e-4."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import decode_step, init_decode_state, prefill
    out = tmp_path / "out.npz"
    _spawn(_serve_step_worker, 4, str(tmp_path / "store"), str(out))
    z = np.load(out)
    got = [z[f"arr_{i}"] for i in range(len(z.files))]
    cfg, params, toks = _serve_step_inputs()
    lg, v, _ = prefill(params, cfg, {"tokens": toks})
    dl, dv, ds = decode_step(params, cfg, toks[:, :1], init_decode_state(cfg, 4, 16, device="cpu"),
                             uniform=True)
    want = [lg[:, -1], v[:, -1], dl, dv] + [t for _, t in SH.leaves_with_path(ds)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.detach().numpy(), atol=TOL, rtol=0)


# -- (v) the served, sharded multiprocess league ------------------------------------

@pytest.mark.timeout(120)
def test_run_multiprocess_served_sharded_shuts_down_cleanly(monkeypatch, capfd):
    import os
    from pathlib import Path

    import torch.distributed as tdist

    from repro_torch.launch.distributed import run_multiprocess
    from repro_torch.league import LeagueSpec

    root = Path(__file__).resolve().parents[1]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(root / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else [])))
    spec = LeagueSpec.from_json(str(root / "examples" / "league_specs" / "main_minimax.json"))
    report = run_multiprocess(spec, workers=2, env_name="rps", num_envs=4, unroll_len=4,
                              served=True, sharded=True, max_steps_per_role=2,
                              max_seconds=90.0, heartbeat_timeout_s=60.0,
                              max_actor_restarts=0, device="cpu", verbose=False)
    capfd.readouterr()
    assert report["clean_shutdown"], report["worker_exit_codes"]
    assert report["worker_exit_codes"] == [0, 0, 0, 0] and report["actor_restarts"] == 0
    assert all(s >= 2 for s in report["progress"]["learner_steps"].values())
    assert report["serving"]["sharded"] is True
    assert report["serving"]["mesh_shape"] == [1, 1]
    assert report["serving"]["batches_run"] > 0
    assert not tdist.is_initialized()

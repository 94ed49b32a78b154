"""The port's sharded prefill and decode on the CPU: `make_dryrun_step`'s
prefill and decode fns over gloo groups, against the single-device port
and `repro`'s single-device prefill and decode.

Each case splits the compute over 'model' (tensor parallelism) and lays
the KV caches out as `repro`'s `state_shardings` does:
  - policy-m on (1, 2) and (2, 2): KV heads split (KV % M == 0), each
    rank's cache holding KV/M heads;
  - policy-s on (1, 4), KV = 2 (M % KV == 0): the cache replicated, every
    rank holding every KV head and attending with its H/M query heads;
    and with `shard_cache_len`, each rank holding W/M slots of every head,
    its partial attention merged by log-sum-exp across 'model' (uniform
    decode steps, and steps that write each row at its own slot);
  - command-r `.smoke()` on (1, 2): layernorm and tied embeddings under
    vocab parallelism.
A prefill of T tokens, then STEPS decode steps, at fp32: the last
position's logits and values, each step's logits and values, and every
leaf of the final state within 1e-5 of max(1, max |.|) of the
single-device port (the sums over 'model' reassociate: command-r's tied
head gives logits near 30, where an fp32 ulp is 2e-6); at T <= 64 (where
`repro`'s prefill keeps every prompt key, ROADMAP §3) within 1e-4 of
max(1, max |.|) of `repro`'s jitted prefill and decode_step. Positions
and lengths exactly. Each spawned group initialises through a `file://`
store in the test's `tmp_path`; rank 0 writes an `.npz` that the parent
holds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_mesh import _done, _init, _spawn

STEPS = 7
TOL_PORT, TOL_REPRO = 1e-5, 1e-4

# arch, mesh (data, model), shard_cache_len, uniform steps, batch, prompt
CASES = [
    ("tleague-policy-m", (1, 2), False, True, 2, 16),
    ("tleague-policy-m", (2, 2), False, True, 4, 16),
    ("tleague-policy-s", (1, 4), False, True, 2, 16),
    # W = 52 + 64 = 116 slots, 29 a rank: the prompt fills rank 0's block and
    # part of rank 1's, and step 7 writes slot 58, rank 2's first
    ("tleague-policy-s", (1, 4), True, True, 2, 52),
    ("tleague-policy-s", (1, 4), True, False, 2, 52),
    ("command-r-35b", (1, 2), False, True, 2, 16),
]


def _cfgs(arch):
    """(the port's config, `repro`'s) at fp32: the policy nets as they are,
    the assigned archs at `.smoke()`."""
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch
    cut = (lambda c: c.smoke()) if arch.startswith("command-r") else (lambda c: c)
    f32 = dict(compute_dtype="float32", param_dtype="float32")
    return (dataclasses.replace(cut(get_arch(arch)), **f32),
            dataclasses.replace(cut(jax_arch(arch)), **f32))


def _shapes(B, T):
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    INPUT_SHAPES["mesh_prefill"] = InputShape("mesh_prefill", T, B, "prefill")
    # the decode state's specs are those of the prefill's cache, T + 64 slots
    INPUT_SHAPES["mesh_decode"] = InputShape("mesh_decode", T + 64, B, "decode")


def _worker(rank, world, store, arch, shape, scl, uniform, B, T, params_np, toks, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.params import from_reference
    cfg, _ = _cfgs(arch)
    _shapes(B, T)
    mesh = make_local_mesh("cpu", shape=shape)
    pre = make_dryrun_step(cfg, "mesh_prefill", mesh, shard_cache_len=scl)
    dec = make_dryrun_step(cfg, "mesh_decode", mesh, shard_cache_len=scl,
                           uniform_lengths=uniform)
    pd = SH.distribute(from_reference(params_np, "cpu"), pre["in_shardings"][0], mesh)
    tt = torch.from_numpy(toks)
    lg, v, state = pre["fn"](pd, SH.distribute({"tokens": tt[:, :T]},
                                               pre["in_shardings"][1], mesh))
    local_k = tuple(state["blocks"]["kv0"]["k"].to_local().shape)
    outs = [lg, v]
    for i in range(T, T + STEPS):
        dl, dv, state = dec["fn"](pd, SH.distribute(tt[:, i:i + 1], dec["in_shardings"][1],
                                                    mesh), state)
        outs += [dl, dv]
    full = [t.full_tensor().numpy() for t in outs]
    full += [t.full_tensor().numpy() for _, t in SH.leaves_with_path(state)]
    if rank == 0:
        np.savez(out, np.asarray(local_k), *full)
    _done()


def _close(got, want, tol):
    assert got.shape == want.shape
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _single_device(cfg, params, toks, T, uniform):
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import decode_step, prefill
    lg, v, state = prefill(params, cfg, {"tokens": toks[:, :T]})
    outs = [lg[:, -1], v[:, -1]]
    for i in range(T, T + STEPS):
        dl, dv, state = decode_step(params, cfg, toks[:, i:i + 1], state, uniform=uniform)
        outs += [dl, dv]
    return [t.numpy() for t in outs], [t.numpy() for _, t in SH.leaves_with_path(state)]


def _repro(jcfg, params_np, toks, T, uniform):
    import jax
    import jax.numpy as jnp
    from repro.models import decode_step, prefill
    pre = jax.jit(prefill, static_argnames=("cfg",))
    dec = jax.jit(decode_step, static_argnames=("cfg", "uniform"))
    lg, v, state = pre(params_np, jcfg, {"tokens": jnp.asarray(toks[:, :T])})
    outs = [lg[:, -1], v[:, -1]]
    for i in range(T, T + STEPS):
        dl, dv, state = dec(params_np, jcfg, jnp.asarray(toks[:, i:i + 1]), state,
                            uniform=uniform)
        outs += [dl, dv]
    return [np.asarray(t) for t in outs], [np.asarray(t) for t in jax.tree.leaves(state)]


@pytest.mark.timeout(150)
@pytest.mark.parametrize("arch,shape,scl,uniform,B,T", CASES)
def test_sharded_prefill_and_decode_match_single_device_and_repro(arch, shape, scl, uniform,
                                                                  B, T, tmp_path):
    import jax
    from repro.models import init_params as jax_init
    from repro_torch.params import from_reference

    cfg, jcfg = _cfgs(arch)
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4), jcfg))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T + STEPS)).astype(np.int32)
    out = tmp_path / "out.npz"
    _spawn(_worker, shape[0] * shape[1], str(tmp_path / "store"), arch, shape, scl, uniform,
           B, T, params_np, toks, str(out), timeout=140.0)
    z = np.load(out)
    local_k = tuple(z["arr_0"])
    got = [z[f"arr_{i}"] for i in range(1, len(z.files))]

    # the rank's own cache: KV/M heads when they split, W/M slots under
    # shard_cache_len, else every head and slot
    D, M = shape
    KV, W = cfg.num_kv_heads, T + 64
    reps = cfg.num_layers // len(cfg.layer_pattern)
    heads, slots = KV, W
    if KV % M == 0:
        heads = KV // M
    elif scl:
        slots = W // M
    assert local_k == (reps, B // D, slots, heads, cfg.head_dim)

    outs, leaves = _single_device(cfg, from_reference(params_np, "cpu"),
                                  torch.from_numpy(toks).long(), T, uniform)
    assert len(got) == len(outs) + len(leaves)
    for a, b in zip(got, outs + leaves):
        _close(a, b, TOL_PORT)

    j_outs, j_leaves = _repro(jcfg, params_np, toks, T, uniform)
    assert len(j_outs) == len(outs) and len(j_leaves) == len(leaves)
    for a, b in zip(got, j_outs + j_leaves):
        _close(a, b, TOL_REPRO)

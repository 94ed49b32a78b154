"""RWKV6, Mamba and the MoE's experts split over 'model' on the CPU:
`make_dryrun_step`'s prefill, decode and train fns over gloo groups,
against the single-device port and `repro`'s single-device results.

Under a tensor-parallel scope RWKV6's time mix splits by head when
H % M == 0 (`tm_S` holding H/M heads), its channel mix by its hidden dim,
hymba's Mamba heads by their inner dim (`ssm` and `conv` holding di/M
channels), and the routed experts E/M to a model rank without `moe_ep`;
the states cross the factory's fns as each rank's shards. Cases:
  - rwkv6 `.smoke()` (d 256, hs 32, H 8) and hymba `.smoke()` (d 256,
    di 512) on (1, 2) and (2, 2), and rwkv6 at d_model 96 (H = 3, whose
    heads do not divide: `tm_S` whole on each rank) on (1, 2): a prefill
    of T tokens and STEPS decode steps at fp32, each rank's state shapes
    checked; the last position's logits and values, each step's, and
    every leaf of the final state within 1e-5 of max(1, max |.|) of the
    single-device port and within 1e-4 of `repro`'s jitted prefill and
    decode_step (T <= 64);
  - the sharded train step (FSDP on) for rwkv6 and hymba on (2, 2): loss
    and every grad within 1e-4 of the single-device port and of `repro`'s
    step, each split leaf used as this rank's slice;
  - qwen3-moe `.smoke()` (E = 4) without `moe_ep` on (1, 2) and (2, 2): a
    rank's experts are E/M, loss and grads as above; and on (2, 2) at the
    arch's capacity factor, a batch whose data shards route unevenly, kept
    and dropped by the global capacity.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_mesh import (_check_step, _done, _drops_differ, _gathers, _init, _spawn,
                             _train_batch, _uneven_batch, _with_capacity, TINY, _tiny_shape)
from test_torch_mesh_decode import STEPS, TOL_PORT, TOL_REPRO, _close, _repro, _single_device

RWKV, HYMBA, MOE = "rwkv6-3b", "hymba-1.5b", "qwen3-moe-235b-a22b"

# arch, d_model (None: the smoke's), mesh (data, model), batch, prompt
CASES = [
    (RWKV, None, (1, 2), 2, 16),
    (RWKV, None, (2, 2), 4, 16),
    (RWKV, 96, (1, 2), 2, 16),
    (HYMBA, None, (1, 2), 2, 16),
    (HYMBA, None, (2, 2), 4, 16),
]


def _cfgs(arch, d_model=None):
    """(the port's `.smoke()` config, `repro`'s) at fp32, d_model as given."""
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if d_model:
        kw["d_model"] = d_model
    return (dataclasses.replace(get_arch(arch).smoke(), **kw),
            dataclasses.replace(jax_arch(arch).smoke(), **kw))


def _local_shape(cfg, leaf, shape, B):
    """The shape of state leaf `leaf` (per repeat unit stacked) on one rank
    of `shape`: the batch over data, and the 'model' split where
    `repro`'s `state_shardings` puts it."""
    D, M = shape
    reps = cfg.num_layers // len(cfg.layer_pattern)
    if leaf == "tm_S":
        H, hs = cfg.d_model // cfg.ssm.head_size, cfg.ssm.head_size
        return (reps, B // D, H // M if H % M == 0 else H, hs, hs)
    di = cfg.ssm.expand * cfg.d_model
    if leaf == "ssm0":
        return (reps, B // D, di // M, cfg.ssm.state_size)
    return (reps, B // D, cfg.ssm.conv_kernel - 1, di // M)


def _state_leaves(arch):
    return ("tm_S",) if arch == RWKV else ("ssm0", "conv0")


def _worker(rank, world, store, arch, d_model, shape, B, T, params_np, toks, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.params import from_reference
    from test_torch_mesh_decode import _shapes
    cfg, _ = _cfgs(arch, d_model)
    _shapes(B, T)
    mesh = make_local_mesh("cpu", shape=shape)
    pre = make_dryrun_step(cfg, "mesh_prefill", mesh)
    dec = make_dryrun_step(cfg, "mesh_decode", mesh, uniform_lengths=True)
    pd = SH.distribute(from_reference(params_np, "cpu"), pre["in_shardings"][0], mesh)
    tt = torch.from_numpy(toks)
    lg, v, state = pre["fn"](pd, SH.distribute({"tokens": tt[:, :T]},
                                               pre["in_shardings"][1], mesh))
    local = [tuple(state["blocks"][k].to_local().shape) for k in _state_leaves(arch)]
    outs = [lg, v]
    for i in range(T, T + STEPS):
        dl, dv, state = dec["fn"](pd, SH.distribute(tt[:, i:i + 1], dec["in_shardings"][1],
                                                    mesh), state)
        outs += [dl, dv]
    # the decode steps hand the state on as shards too
    local += [tuple(state["blocks"][k].to_local().shape) for k in _state_leaves(arch)]
    full = [t.full_tensor().numpy() for t in outs]
    full += [t.full_tensor().numpy() for _, t in SH.leaves_with_path(state)]
    if rank == 0:
        np.savez(out, np.asarray(local), *full)
    _done()


@pytest.mark.timeout(150)
@pytest.mark.parametrize("arch,d_model,shape,B,T", CASES)
def test_split_prefill_and_decode_match_single_device_and_repro(arch, d_model, shape, B, T,
                                                                tmp_path):
    import jax
    from repro.models import init_params as jax_init
    from repro_torch.params import from_reference

    cfg, jcfg = _cfgs(arch, d_model)
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4), jcfg))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T + STEPS)).astype(np.int32)
    out = tmp_path / "out.npz"
    _spawn(_worker, shape[0] * shape[1], str(tmp_path / "store"), arch, d_model, shape, B, T,
           params_np, toks, str(out), timeout=140.0)
    z = np.load(out)
    leaves = _state_leaves(arch)
    want = [_local_shape(cfg, k, shape, B) for k in leaves]
    assert [tuple(s) for s in z["arr_0"]] == want + want
    got = [z[f"arr_{i}"] for i in range(1, len(z.files))]

    outs, state = _single_device(cfg, from_reference(params_np, "cpu"),
                                 torch.from_numpy(toks).long(), T, True)
    assert len(got) == len(outs) + len(state)
    for a, b in zip(got, outs + state):
        _close(a, b, TOL_PORT)

    j_outs, j_state = _repro(jcfg, params_np, toks, T, True)
    assert len(j_outs) == len(outs) and len(j_state) == len(state)
    for a, b in zip(got, j_outs + j_state):
        _close(a, b, TOL_REPRO)


# -- the sharded train step -------------------------------------------------------

# arch, mesh, capacity factor: the smoke's (which never drops) or the arch's
TRAIN_CASES = [
    (RWKV, (2, 2), False),
    (HYMBA, (2, 2), False),
    (MOE, (1, 2), False),
    (MOE, (2, 2), False),
    (MOE, (2, 2), True),
]


def _train_cfgs(arch, capacity):
    cfg, jcfg = _cfgs(arch)
    return (_with_capacity(cfg), _with_capacity(jcfg)) if capacity else (cfg, jcfg)


def _split_shapes(cfg):
    """{leaf: the shape a rank of M = 2 computes with} for the leaves that
    split over 'model' in the first unit."""
    d, M = cfg.d_model, 2
    if cfg.family == "ssm":
        return {"blocks/sub0/time_mix/wr/w": (d, d // M),
                "blocks/sub0/time_mix/wo/w": (d // M, d),
                "blocks/sub0/time_mix/u": (d // cfg.ssm.head_size // M, cfg.ssm.head_size),
                "blocks/sub0/time_mix/lora_a": (d, 5 * cfg.ssm.lora_rank),      # whole
                "blocks/sub0/channel_mix/wk/w": (d, cfg.d_ff // M),
                "blocks/sub0/channel_mix/wv/w": (cfg.d_ff // M, d)}
    if cfg.family == "hybrid":
        di, N = cfg.ssm.expand * d, cfg.ssm.state_size
        dt_rank = cfg.ssm.dt_rank or -(-d // 16)
        return {"blocks/sub0/mamba/in_proj/w": (d, 2 * di // M),
                "blocks/sub0/mamba/conv_w": (cfg.ssm.conv_kernel, di // M),
                "blocks/sub0/mamba/x_proj/w": (di // M, dt_rank + 2 * N),
                "blocks/sub0/mamba/A_log": (di // M, N),
                "blocks/sub0/mamba/out_proj/w": (di // M, d)}
    E, ff = cfg.moe.num_experts, cfg.moe.d_ff_expert
    return {"blocks/sub0/moe/up": (E // M, d, ff), "blocks/sub0/moe/down": (E // M, ff, d),
            "blocks/sub0/moe/router/w": (d, E)}


def _train_worker(rank, world, store, arch, shape, capacity, params_np, batch_np, out):
    _init(rank, world, store)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.params import from_reference
    _tiny_shape()
    cfg, _ = _train_cfgs(arch, capacity)
    mesh = make_local_mesh("cpu", shape=shape)
    built = make_dryrun_step(cfg, TINY[0], mesh, fsdp=True, moe_ep=False)
    pshard, _, bshard = built["in_shardings"]
    params = SH.distribute(from_reference(params_np, "cpu"), pshard, mesh)
    batch = SH.distribute({k: torch.from_numpy(v) for k, v in batch_np.items()}, bshard, mesh)
    with _gathers() as seen:
        loss, _, grads = built["fn"].value_and_grad(params, batch)
    for name, want in _split_shapes(cfg).items():
        assert seen["shapes"][name] == want, (name, seen["shapes"][name], want)
    full = [g.full_tensor().numpy() for _, g in SH.leaves_with_path(grads)]
    if rank == 0:
        np.savez(out, loss.numpy(), *full)
    _done()


@pytest.mark.timeout(150)
@pytest.mark.parametrize("arch,shape,capacity", TRAIN_CASES)
def test_split_train_step_matches_single_device_and_repro(arch, shape, capacity, tmp_path):
    import jax
    from repro.models import init_params as jax_init
    from repro_torch.params import from_reference

    cfg, jcfg = _train_cfgs(arch, capacity)
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jcfg))
    batch_np = _uneven_batch(cfg) if capacity else _train_batch(cfg)
    if capacity:
        # the per-(data shard) capacity would drop differently on this batch
        assert _drops_differ(cfg, from_reference(params_np, "cpu"),
                             {k: torch.from_numpy(v) for k, v in batch_np.items()})
    out = tmp_path / "out.npz"
    _spawn(_train_worker, shape[0] * shape[1], str(tmp_path / "store"), arch, shape,
           capacity, params_np, batch_np, str(out), timeout=140.0)
    _check_step(out, cfg, jcfg, params_np, batch_np)

"""The dry-run's per-device counts (`repro_torch.launch.counters`,
`launch/dryrun._measure_shallow`) on the CPU, with smoke configs at tiny
shapes:

- the extrapolation of each measured key (from 1 and 2 units: FLOPs and
  FLOPs by op, bytes, collective bytes and counts by kind, the global
  FLOPs; from 2 and 3: the peak of temporaries in each phase of the step
  and overall) equals a direct count at 4 units;
- per-device FLOPs x chips against the unsharded step's, op by op, each
  replicated term named (the value head and the hidden-state norms run
  whole on every model rank; the train step's heads run again in its
  backward), and the optimizer's on the leaves each rank holds whole or in
  part;
- `kernels/cost.py`'s attention FLOPs against `FlopCounterMode`'s count of
  the plain versions;
- the counting mesh refuses to start over a group that is up, and leaves
  none behind;
- real gloo ranks (2 and 4) running a train and a decode step under the
  counter count, each, what the counting mesh counts for rank 0: FLOPs
  and collectives by kind.
"""
import dataclasses
import json
import math

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import specs as SP
from repro_torch.launch.counters import COLLECTIVES, Counter, collective_bytes
from repro_torch.launch.mesh import make_counting_mesh

from test_torch_mesh import _done, _init, _spawn

TINY = {"tiny_train": InputShape("tiny_train", 32, 4, "train"),
        "tiny_prefill": InputShape("tiny_prefill", 32, 4, "prefill"),
        "tiny_decode": InputShape("tiny_decode", 32, 4, "decode")}


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, shape in TINY.items():
        monkeypatch.setitem(INPUT_SHAPES, name, shape)


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ("qwen3-8b", "qwen3-moe-235b-a22b", "rwkv6-3b")
    for s in ("tiny_train", "tiny_decode")] + [("hubert-xlarge", "tiny_train")])
def test_extrapolation_equals_a_direct_count_at_three_units(arch, shape_name, tiny_shapes):
    """At 4 units, past the 3 that the peaks are extrapolated from."""
    cfg = dryrun.at_units(get_arch(arch).smoke(), 4)
    got = dryrun._measure_shallow(cfg, shape_name, (2, 2))
    with make_counting_mesh((2, 2)) as mesh:
        direct = dryrun.count(cfg, shape_name, mesh)
    glob = dryrun.count(cfg, shape_name, dryrun.SH.AbstractMesh((2, 2), ("data", "model")))
    assert got["units"] == 4 and got["rank"] == 0
    assert got["per_unit_flops"] > 0 and got["per_unit_coll"] > 0
    assert got["flops"] == direct["flops"]
    assert got["flops_by_op"] == {k: v for k, v in direct["flops_by_op"].items()}
    assert got["bytes"] == direct["bytes"]
    assert got["collective_bytes"] == direct["collectives"]["total"]
    assert got["coll_breakdown"] == {k: direct["collectives"][k] for k in COLLECTIVES}
    assert got["coll_counts"] == {f"n_{k}": direct["collectives"][f"n_{k}"]
                                  for k in COLLECTIVES}
    assert got["global_flops"] == glob["flops"]
    assert got["global_flops_by_op"] == glob["flops_by_op"]
    # each phase's peak on its own: a train step's can move from its
    # backward to its update as units are added, and hubert's sits
    # elsewhere at one unit than at two or more
    assert got["temp_by_phase"] == direct["temp_by_phase"]
    assert got["temp_size_in_bytes"] == direct["temp_size_in_bytes"] > 0
    assert set(got["temp_by_phase"]) == ({"step", "update"} if shape_name == "tiny_train"
                                         else {"step"})


def _axes(spec_dim):
    return () if spec_dim is None else (spec_dim,) if isinstance(spec_dim, str) else spec_dim


def _with_specs(shapes, specs):
    """(leaf, spec) pairs of a param tree and its spec tree."""
    if isinstance(shapes, dict):
        for k in shapes:
            yield from _with_specs(shapes[k], specs[k])
    else:
        yield shapes, specs


@pytest.mark.parametrize("shape_name", ["tiny_train", "tiny_prefill", "tiny_decode"])
def test_per_device_flops_times_chips_names_each_replicated_term(shape_name, tiny_shapes):
    """qwen3-8b smoke on (2, 2): its 4 heads, 2 KV heads, d_ff 512 and
    vocab 512 all divide M = 2, so attention and the MLP split exactly.
    Whole on every model rank: the value head (no 'model' rule), the
    hidden-state RMSNorms (two a layer and the final one) and, in the train
    step, GAE's scan. The sharded train step checkpoints its heads, so they
    run again in the backward (the recompute stops before the value head's
    last matmul, whose output the backward does not need)."""
    cfg = get_arch("qwen3-8b").smoke()
    D, M = 2, 2
    m = dryrun._measure_shallow(cfg, shape_name, (D, M))
    per = {k: v * D * M for k, v in m["flops_by_op"].items()}
    glob = m["global_flops_by_op"]
    shp = INPUT_SHAPES[shape_name]
    rows = shp.global_batch * (1 if shp.kind == "decode" else shp.seq_len)
    d, V = cfg.d_model, cfg.vocab_size
    vo = 2 * rows * d                                  # the value head's out layer
    vh = 2 * rows * d * d + vo                         # the whole value head, forward
    lm = 2 * rows * d * V                              # lm_head, forward
    norm = 4 * rows * d                                # one hidden-state RMSNorm
    hidden_norms = 2 * cfg.num_layers * norm
    for k in glob:
        if k.startswith("flash_attention"):
            assert per[k] == glob[k], k                # heads split over 'model'
    if shp.kind == "train":
        assert per["aten.mm"] - glob["aten.mm"] == (M - 1) * 3 * vh + lm + M * (vh - vo)
        # forward and recompute of the layers' norms; the final one in the
        # forward and again in the heads' recompute
        assert per["rmsnorm"] - glob["rmsnorm"] == (M - 1) * 2 * hidden_norms \
            + (2 * M - 1) * norm
        assert per["reverse_discounted_scan_p"] == M * glob["reverse_discounted_scan_p"]
        # AdamW (clip: 15 FLOPs a param) and the norm (2): each rank updates
        # its shard of every leaf, so a leaf replicated over k ranks counts
        # k times
        n_whole = n_mine = 0
        for t, spec in _with_specs(SP.param_shapes(cfg), SH.param_shardings(
                SP.param_shapes(cfg), cfg, SH.AbstractMesh((D, M), ("data", "model")))):
            n_whole += t.numel()
            n_mine += math.prod(-(-size // math.prod({"data": D, "model": M}[a] for a in axes))
                                for size, axes in zip(t.shape, map(_axes, spec)))
        assert per["adamw"] - glob["adamw"] == 15 * (D * M * n_mine - n_whole)
        assert per["global_norm"] - glob["global_norm"] == 2 * (D * M * n_mine - n_whole)
    else:
        assert per["aten.mm"] - glob["aten.mm"] == (M - 1) * vh
        assert per["rmsnorm"] - glob["rmsnorm"] == (M - 1) * (hidden_norms + norm)
    assert set(per) == set(glob)
    assert m["flops"] * D * M == sum(per.values())
    assert m["global_flops"] == sum(glob.values())


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cost_flops_equal_the_flop_counter_on_the_plain_versions(direction):
    """Non-causal, unwindowed, so every (q, k) pair is live. The forward's
    plain version is the kernel's two matmuls; the plain backward
    (`attention_bwd_grads_ref`) computes scores, dP, dQ, dK and dV once,
    where the dq and dk/dv kernels each recompute the scores and dP, and
    dq's prologue computes delta (2·d a row, elementwise: no matmul)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_grads_ref,
        attention_fwd_ref,
    )
    B, H, KV, Tq, Tk, d = 2, 4, 2, 24, 40, 32
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, Tq, d, generator=g)
    k, v = (torch.randn(B, KV, Tk, d, generator=g) for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=False)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    fc = FlopCounterMode(display=False)
    if direction == "forward":
        with fc:
            attention_fwd_ref(q, k, v, **kw)
        assert cost.attention_fwd(q, k, v, causal=False).flops == fc.get_total_flops()
        return
    do = torch.randn(B, H, Tq, d, generator=g)
    delta = (o * do).sum(-1)
    with fc:
        attention_bwd_grads_ref(q, k, v, do, lse, delta, **kw)
    recompute = FlopCounterMode(display=False)
    with recompute:        # the second kernel's scores and dP
        qf = q.reshape(B, KV, H // KV, Tq, d)
        torch.matmul(qf, k[:, :, None].transpose(-1, -2))
        torch.matmul(do.reshape(B, KV, H // KV, Tq, d), v[:, :, None].transpose(-1, -2))
    dq = cost.attention_bwd_dq(q, k, v, o, do, lse, causal=False).flops
    dkv = cost.attention_bwd_dkv(q, k, v, do, lse, delta, causal=False).flops
    assert dq - 2 * d * B * H * Tq + dkv == fc.get_total_flops() + recompute.get_total_flops()
    assert cost.attention_bwd_preprocess(o).flops == 2 * d * B * H * Tq


@pytest.mark.parametrize("causal,window,kv_len", [(True, 0, None), (True, 7, None),
                                                 (False, 5, 30), (True, 0, 17),
                                                 (False, 0, 100)])
def test_live_pairs_count_the_plain_mask(causal, window, kv_len):
    from repro_torch.kernels.cost import live_pairs
    from repro_torch.kernels.flash_attention.ref import _mask
    Tq, Tk = 24, 40
    assert live_pairs(Tq, Tk, causal, window, kv_len) == int(
        _mask(Tq, Tk, kv_len, causal, window, "cpu").expand(Tq, Tk).sum())


def test_collective_bytes_keys_are_repro_s():
    recs = [{"kind": "all-gather", "op": "c10d._allgather_base_", "bytes": 8},
            {"kind": "all-reduce", "op": "c10d.allreduce_", "bytes": 4},
            {"kind": "all-gather", "op": "_c10d_functional.all_gather_into_tensor",
             "bytes": 2}]
    got = collective_bytes(recs)
    assert got == {"total": 14, "all-gather": 10, "all-reduce": 4, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0, "n_all-gather": 2,
                   "n_all-reduce": 1, "n_reduce-scatter": 0, "n_all-to-all": 0,
                   "n_collective-permute": 0}


def test_counting_mesh_refuses_a_group_that_is_up_and_leaves_none():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with make_counting_mesh((4, 2)) as mesh:
        assert tuple(mesh.shape) == (4, 2) and mesh.get_rank() == 0
        assert dist.get_world_size() == 8
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group is up"):
            with make_counting_mesh((16, 16)):
                pass
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with make_counting_mesh((2, 16, 16)) as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()


def test_the_counter_changes_no_result(tiny_shapes):
    """The counter only reads: a step's outputs are bitwise those of the
    same step without it."""
    from repro_torch.launch.steps import make_dryrun_step
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke(), compute_dtype="float32")
    built = make_dryrun_step(cfg, "tiny_prefill", dryrun.make_production_mesh())
    args = _materialize(built["args"])
    want = built["fn"](*args)
    with Counter() as c:
        got = built["fn"](*args)
    assert c.result()["flops"] > 0 and c.result()["kernels"]["flash_attention_fwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _materialize(args, seed=0):
    """Real CPU tensors of the meta args' shapes: small normal floats,
    zero integers (every index valid)."""
    from repro_torch.utils import tree_map
    g = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=g)).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return tuple(tree_map(one, a) for a in args)


# -- real ranks against the counting mesh ------------------------------------------

REAL_SHAPES = ("tiny_train", "tiny_decode")


def _cfg():
    return dataclasses.replace(get_arch("qwen3-8b").smoke(), compute_dtype="float32")


def _counts(result):
    return {"flops": result["flops"], "flops_by_op": result["flops_by_op"],
            "collectives": result["collectives"], "kernels": result["kernels"]}


def _real_worker(rank, world, store, shape, out):
    _init(rank, world, store)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step
    INPUT_SHAPES.update(TINY)
    mesh = make_local_mesh("cpu", shape=shape)
    res = {}
    for name in REAL_SHAPES:
        built = make_dryrun_step(_cfg(), name, mesh)
        args = tuple(SH.distribute(a, s, mesh)
                     for a, s in zip(_materialize(built["args"]), built["in_shardings"]))
        with Counter() as c:
            built["fn"](*args)
        res[name] = _counts(c.result())
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    _done()


@pytest.mark.timeout(150)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_real_gloo_ranks_count_what_the_counting_mesh_counts(shape, tmp_path, tiny_shapes):
    world = shape[0] * shape[1]
    out = tmp_path / "counts"
    _spawn(_real_worker, world, str(tmp_path / "store"), shape, str(out))
    with make_counting_mesh(shape) as mesh:
        want = {name: _counts(dryrun.count(_cfg(), name, mesh)) for name in REAL_SHAPES}
    for rank in range(world):
        got = json.loads((tmp_path / f"counts.{rank}").read_text())
        for name in REAL_SHAPES:
            assert got[name]["collectives"]["total"] > 0, (rank, name)
            assert got[name] == want[name], (rank, name)

"""AdamW's kernels (`repro_torch.kernels.adamw`) on the CPU, where they
run as shapes (meta, inside `dispatch.abstract()`) or as their plain
versions; the kernels themselves are held against the plain body on the
card in `tests/test_torch_cuda.py`.

- `cost.adamw` and `cost.global_norm`, by hand: bytes a param and flops;
- a meta update reports each leaf's work to a `cost` listener and, in
  place, allocates nothing beyond the norm's workspace and the scalars;
- what the kernels do not take raises on meta as it would on the card;
- on the CPU the optimizer, through the wrappers' CPU paths, gives the
  plain body's numbers (whole leaves) bit for bit, counted as `reference`
  with no launch; DTensor leaves take the same path on their shards, and
  on two gloo ranks give the unsharded update's numbers.
"""
import json

import pytest
import torch

from test_torch_mesh import _done, _init, _spawn

from repro_torch.kernels import cost, dispatch
from repro_torch.kernels.adamw import adamw_update, global_norm
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw.ref import adamw_ref
from repro_torch.launch.counters import Counter
from repro_torch.optim import adamw
from repro_torch.utils import tree_global_norm, tree_leaves, tree_map

BF, F32 = torch.bfloat16, torch.float32


def _leaf(n, dtype):
    return torch.empty(n, dtype=dtype, device="meta")


@pytest.mark.parametrize("g_dtype,p_dtype,master,per_param", [
    (BF, BF, True, 28), (F32, F32, False, 28), (BF, BF, False, 22), (F32, F32, True, 32)])
@pytest.mark.parametrize("clip,wd", [(False, 0.0), (True, 0.0), (True, 0.01)])
def test_cost_adamw_bytes_and_flops_a_param(g_dtype, p_dtype, master, per_param, clip, wd):
    """Read g, m, v and the base; write m, v, the master and the param:
    bf16 with master 2 + 12 + 12 + 2, fp32 4 + 12 + 12, bf16 without
    master 2 + 10 + 10, fp32 with master 4 + 12 + 16."""
    n = 1000
    m = _leaf(n, F32)
    base = _leaf(n, F32 if master else p_dtype)
    out = (m, m, _leaf(n, F32) if master else None, _leaf(n, p_dtype))
    w = cost.adamw(_leaf(n, g_dtype), m, m, base, out,
                   scale=torch.ones(()) if clip else None, weight_decay=wd)
    assert w.bytes == per_param * n
    assert w.flops == (14 + clip + 2 * (wd != 0)) * n


def test_cost_global_norm_reads_each_grad_once():
    w = cost.global_norm([_leaf(1000, BF), _leaf(24, BF), _leaf(3, F32)])
    assert w.bytes == 2 * 1024 + 4 * 3 and w.flops == 2 * 1027


def _tree(dtype):
    """A leaf, a 0-d scalar and a stacked (1, ...) leaf, on meta."""
    return {"a": torch.empty(7, 5, dtype=dtype, device="meta"),
            "s": torch.empty((), dtype=dtype, device="meta"),
            "stack": torch.empty(1, 6, 4, dtype=dtype, device="meta")}


class Recorder:
    """A `cost` listener: the kernels' calls and their work."""

    def __init__(self):
        self.calls = []

    def kernel(self, name, work, out):
        self.calls.append((name, work))

    def phase(self, name):
        pass


@pytest.mark.parametrize("inplace", [True, False])
def test_meta_update_reports_its_work_and_in_place_allocates_nothing(inplace):
    params = _tree(BF)
    n = sum(p.numel() for p in tree_leaves(params))
    opt = adamw(1e-3, clip_norm=1.0, master_fp32=True, inplace=inplace)
    state = opt.init(params)
    grads = _tree(BF)
    rec = Recorder()
    cost.listeners.append(rec)
    try:
        with dispatch.abstract(), Counter() as counter:
            cost.phase("update")
            new_params, new_state, metrics = opt.update(grads, state, params)
    finally:
        cost.listeners.remove(rec)
    assert [name for name, _ in rec.calls] == ["global_norm"] + ["adamw"] * 3
    assert sum(w.bytes for _, w in rec.calls) == 2 * n + 28 * n
    assert counter.kernels == {"global_norm": 1, "adamw": 3}
    assert counter.flops_by_op == {"global_norm": 2 * n, "adamw": 15 * n}
    live = counter.live["update"]
    grown = max(live) - live[0]
    if inplace:
        assert all(a is b for a, b in zip(tree_leaves((new_params, new_state["mu"])),
                                          tree_leaves((params, state["mu"]))))
        assert grown < 1024             # the norm's partial sums and the scalars
    else:
        # new moments, master (fp32) and params (bf16)
        assert 14 * n <= grown < 14 * n + 1024
    assert metrics["grad_norm"].device.type == "meta"
    assert all(t.device.type == "meta" for t in tree_leaves((new_params, new_state)))


@pytest.mark.parametrize("bad", ["fp16_grads", "strided_moment", "bf16_moment"])
def test_meta_update_refuses_what_the_kernel_does_not_take(bad):
    params, grads = _tree(BF), _tree(BF)
    opt = adamw(1e-3, master_fp32=True, inplace=True)
    state = opt.init(params)
    if bad == "fp16_grads":
        grads = tree_map(lambda g: g.to(torch.float16), grads)
    elif bad == "strided_moment":
        state["mu"]["a"] = torch.empty(5, 7, dtype=F32, device="meta").t()
    else:
        state["nu"]["stack"] = state["nu"]["stack"].to(BF)
    with dispatch.abstract(), pytest.raises(TypeError if bad != "strided_moment" else ValueError):
        opt.update(grads, state, params)


def test_meta_update_outside_abstract_raises():
    params = _tree(F32)
    opt = adamw(1e-3)
    with pytest.raises(ValueError, match="unsupported device"):
        opt.update(_tree(F32), opt.init(params), params)


def _plain_update(grads, state, params, lr, *, clip_norm=0.0, master_fp32=False,
                  weight_decay=0.0):
    """The plain body over whole leaves (`adamw_ref`, `tree_global_norm`):
    (new params, mu, nu, master or None, norm)."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0) if clip_norm else None
    step = (state["step"] + 1).float()
    lr, bc1, bc2 = torch.tensor(lr, dtype=F32), 1 - 0.9 ** step, 1 - 0.999 ** step
    bases = tree_leaves(state["master"]) if master_fp32 else tree_leaves(params)
    out = [adamw_ref(g, m, v, b, scale, lr, bc1, bc2, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=weight_decay)
           for g, m, v, b in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                 tree_leaves(state["nu"]), bases)]
    new_params = [b.to(p.dtype) for (_, _, b), p in zip(out, tree_leaves(params))]
    return (new_params, [o[0] for o in out], [o[1] for o in out],
            [o[2] for o in out] if master_fp32 else None, norm)


def _same(got, want):
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", [dict(weight_decay=0.01, clip_norm=1.0),
                                dict(master_fp32=True, clip_norm=1.0),
                                dict(master_fp32=False)], ids=["fp32", "bf16-master", "bf16"])
def test_cpu_wrappers_give_the_optimizer_s_plain_numbers(kw, monkeypatch):
    """The optimizer on the CPU, through the wrappers' plain versions over
    slices (made small here, so every leaf but the scalar takes several),
    against the plain body over whole leaves: bit for bit, counted as
    `reference`, no launch."""
    monkeypatch.setattr(adamw_ops, "_SLICE_ELEMS", 8)
    dtype = F32 if "weight_decay" in kw else BF
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(7, 5, generator=gen).to(dtype),
              "s": torch.randn((), generator=gen).to(dtype),
              "stack": torch.randn(1, 13, generator=gen).to(dtype)}
    grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=gen)).to(dtype), params)
    opt = adamw(1e-2, **kw)
    state = opt.init(params)
    launches = (adamw_update.launches, global_norm.launches)
    dispatch.stats(reset=True)
    new_params, new_state, metrics = opt.update(grads, state, params)
    assert dispatch.stats(reset=True) == {"global_norm|reference": 1, "adamw|reference": 1}
    assert (adamw_update.launches, global_norm.launches) == launches

    p, m, v, master, norm = _plain_update(grads, state, params, 1e-2, **kw)
    assert torch.equal(metrics["grad_norm"], norm)
    assert _same(tree_leaves(new_params), p)
    assert _same(tree_leaves(new_state["mu"]), m) and _same(tree_leaves(new_state["nu"]), v)
    if master is not None:
        assert _same(tree_leaves(new_state["master"]), master)


def _sharded_tree(seed):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 6, generator=gen).to(BF), "b": torch.randn(6, generator=gen).to(BF),
              "v": torch.randn(4, 3, generator=gen).to(BF)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(BF), params)
    return params, grads


def _sharded_update(mesh, params, grads, opt, place):
    """`opt`'s update on DTensors laid out by `place` over `mesh`: the
    result with every leaf made whole."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    dist = lambda tree: {k: distribute_tensor(t, mesh, place[k]) for k, t in tree.items()}
    state = opt.init(params)
    dstate = {"step": distribute_tensor(state["step"], mesh, [Replicate(), Replicate()]),
              **{k: dist(state[k]) for k in ("mu", "nu", "master")}}
    got = opt.update(dist(grads), dstate, dist(params))
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return tree_map(whole, got)


def test_sharded_update_takes_the_plain_path():
    """DTensor leaves (a world of one, gloo): the wrappers on their local
    shards, which take the plain body on the CPU, counted as `reference`,
    no launch; the numbers of the unsharded update, bit for bit, and the
    outputs laid out as the inputs."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh

    params, grads = _sharded_tree(5)
    opt = adamw(1e-2, clip_norm=0.5, master_fp32=True)
    want = opt.update(grads, opt.init(params), params)
    mesh = make_local_mesh("cpu")
    try:
        place = {"w": [Shard(0), Replicate()], "b": [Replicate(), Replicate()],
                 "v": [Replicate(), Shard(1)]}
        launches = (adamw_update.launches, global_norm.launches)
        dispatch.stats(reset=True)
        got = _sharded_update(mesh, params, grads, opt, place)
        assert dispatch.stats(reset=True) == {"global_norm|reference": 1, "adamw|reference": 1}
        assert (adamw_update.launches, global_norm.launches) == launches
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)
    finally:
        close_local_mesh()


def _two_ranks_worker(rank, world, store, out):
    _init(rank, world, store)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh("cpu", shape=(2, 1))
    params, grads = _sharded_tree(9)
    res = {}
    for inplace in (False, True):
        opt = adamw(1e-2, clip_norm=0.5, master_fp32=True, inplace=inplace)
        place = {"w": [Shard(0), Replicate()], "b": [Replicate(), Replicate()],
                 "v": [Shard(1), Replicate()]}
        new_params, new_state, metrics = _sharded_update(
            mesh, tree_map(torch.clone, params), grads, opt, place)
        res[str(inplace)] = {"norm": metrics["grad_norm"].item(),
                             "leaves": [t.float().tolist() for t in
                                        tree_leaves((new_params, new_state["mu"],
                                                     new_state["nu"], new_state["master"]))]}
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    _done()


@pytest.mark.timeout(150)
def test_two_gloo_ranks_give_the_unsharded_update(tmp_path):
    """Leaves split over two gloo ranks (one over rows, one over columns,
    one replicated): the norm sums each shard's squares across the ranks,
    within 1e-6 of the unsharded norm and equal on both ranks; the params,
    moments and master, functional and in place, are the unsharded
    update's bit for bit."""
    out = tmp_path / "upd"
    _spawn(_two_ranks_worker, 2, str(tmp_path / "store"), str(out))
    params, grads = _sharded_tree(9)
    opt = adamw(1e-2, clip_norm=0.5, master_fp32=True)
    new_params, new_state, metrics = opt.update(grads, opt.init(params), params)
    want = [t.float().tolist() for t in tree_leaves((new_params, new_state["mu"],
                                                       new_state["nu"], new_state["master"]))]
    ranks = [json.loads((tmp_path / f"upd.{r}").read_text()) for r in range(2)]
    for got in ranks:
        for key in ("False", "True"):
            assert got[key]["leaves"] == want, key
            assert abs(got[key]["norm"] - metrics["grad_norm"].item()) <= \
                1e-6 * metrics["grad_norm"].item()
    assert ranks[0]["False"]["norm"] == ranks[1]["False"]["norm"]

"""Sharding rules: logical param/activation axes -> mesh specs; counterpart of
`repro.distributed.sharding`.

Baseline layout on mesh (data=16, model=16) [+ pod=2], as in `repro`:
  - batch over ('pod', 'data'): trajectory/data parallelism (M_L learners);
  - the 'model' axis over attention q-heads / FFN hidden / MoE experts /
    vocab;
  - FSDP over 'data' for the big 2D weights: the weight's contraction dim
    shards over 'data'.

Every rule checks divisibility and drops the axis when it does not divide
(gemma2's 8 q-heads vs model=16 -> replicated; hubert's vocab 504 -> head
replicated), so every (arch x shape x mesh) has a layout.

**Specs without devices.** A spec is a tuple with one entry per dim: None,
an axis name, or a tuple of axis names; `PartitionSpec`'s counterpart, with
its normalisation (a one-axis tuple is written as the bare name). The rules
read a mesh's `shape` mapping alone (`{axis: size}`), so they run on an
`AbstractMesh` of this module, which holds no device, as well as on a real
`torch.distributed.device_mesh.DeviceMesh`.

**Placements.** `placements(spec, mesh)` turns a spec into DTensor
placements on a `DeviceMesh`: a dim sharded over ('pod', 'data') becomes a
`Shard(dim)` on each of those mesh dims, in mesh order, which chunks the
dim pod-major as `NamedSharding` does. `distribute` lays a tree out.

**Running over a mesh.** Each rank runs the port's single-device code on
plain local tensors; the kernels never see a DTensor. What crosses ranks is
explicit:
  - params stay in their layout as this rank's shards (`local_params`);
    inside a `param_scope` the model gathers each block's weights at use
    (`materialize`): one repeat unit at a time, so a rank holds its shards
    and one gathered unit (FSDP over the data axes; the sharded train step
    checkpoints each unit, so its gathered copy is freed after the forward
    and gathered again for the backward). Each gather's backward
    reduce-scatters the grad to the shard;
  - over 'model' the compute splits (tensor parallelism): a rank keeps
    its slice of the attention heads, the MLP's hidden dim, the vocab, the
    experts, RWKV6's heads and channel-mix hidden dim and Mamba's inner
    channels (`_Params.slice_of`), and the block's partial output is
    summed over 'model' (`model_sum`); the logits are gathered over it
    (`model_gather`). A dim that does not split evenly (hymba's 25 heads,
    RWKV6's heads when H % M != 0) is gathered whole and computed on every
    model rank;
  - inputs sharded over the data axes are taken as this rank's rows
    (`local_rows`), and inside `data_parallel(...)` every sum over the
    batch (`batch_sum`) spans the data axes, so the loss on each rank is
    the global loss, as GSPMD computes it; the MoE routes each rank's own
    tokens against the global capacity (`models/moe.py`);
  - a prefill or a decode step runs in the same scope, told how its KV
    caches lie over 'model' (`cache_mode`, from `state_shardings`' specs):
    a rank's caches hold its KV heads, its block of the cache slots
    (attention over them merged across 'model' by log-sum-exp,
    `model_max` and `model_sum`) or every head (`cache_heads`,
    `cache_slots`); RWKV6's `tm_S` holds its heads and Mamba's `ssm` and
    `conv` its channels (`rwkv_heads`, `mamba_channels`) wherever
    `state_shardings` splits them, so every state crosses the scope as
    this rank's shards;
  - the backward is seeded with 1 / world on every rank and each
    collective's backward is its adjoint (all-reduce <-> all-reduce,
    all-gather <-> reduce-scatter); `reduce_grads` then sums each grad
    over the mesh dims its param is replicated on, so the grads are the
    global loss's, in the params' layouts.
The scope is per thread; `capture`/`restored` carry it into a
checkpointed unit's recompute, which autograd may run in its own thread.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.utils import tree_map


class AbstractMesh:
    """A mesh's axis names and sizes, with no device behind it (the
    counterpart of `jax.sharding.AbstractMesh`): what the rules, the specs
    and the dry-run read."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} in mesh order, for an AbstractMesh or a DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for the sharding rules needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh_sizes(mesh).values())


def data_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _entry(axes):
    """PartitionSpec's normalisation: () -> None, ('a',) -> 'a'."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def _fit(mesh, shape, wanted) -> tuple:
    """Keep only axes that divide their dim; wanted: one entry per dim."""
    out = []
    for dim, ax in zip(shape, wanted):
        if ax is None or dim % _axis_size(mesh, ax) != 0:
            out.append(None)
        else:
            out.append(_entry(ax))
    return tuple(out)


# -- tree paths ------------------------------------------------------------------

def leaves_with_path(tree, prefix=()):
    """(path, leaf) pairs of nested dicts/lists/tuples, dict keys sorted as
    `jax.tree_util` flattens them; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def path_str(path) -> str:
    """JAX's path string for a tree path: keys joined by '/', list indexes
    as integers."""
    return "/".join(str(p) for p in path)


def map_with_path(fn, tree, prefix=()):
    """`tree` with each leaf replaced by fn(path_str, leaf); same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(path_str(prefix), tree)


def spec_items(specs) -> Dict[str, tuple]:
    """{path string: spec} of a spec tree (a spec is a tuple leaf)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + (i,))
        elif node is not None:
            out[path_str(prefix)] = node
    walk(specs, ())
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or isinstance(e, tuple) for e in x)


# -- the rules -------------------------------------------------------------------

def _rule(mesh, name: str, shape, fsdp: bool, stacked: bool) -> tuple:
    """Spec for one param leaf. `stacked` = leading layer-stack dim."""
    dp = data_axes(mesh)
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape
    nd = len(core)

    def spec(*axes):
        return _fit(mesh, shape, lead + tuple(axes))

    d_ax = dp if fsdp else None     # contraction-dim FSDP axis

    if nd == 3 and ("moe/up" in name or "moe/gate" in name):
        return spec("model", d_ax, None)          # (E, d, ff)
    if nd == 3 and "moe/down" in name:
        return spec("model", None, d_ax)          # (E, ff, d)
    if "embed/table" in name:
        return _fit(mesh, shape, ("model", dp if fsdp else None))
    if nd == 2 and "lm_head" in name:
        return spec(d_ax, "model")
    if nd == 2:
        # column-parallel in-projections, row-parallel out-projections
        if any(t in name for t in ("/wo/", "down")) or name.endswith("wo/w"):
            return spec("model", d_ax)
        if any(t in name for t in ("wq", "wk", "wv", "up", "gate", "wr",
                                   "wg", "in_proj", "x_proj", "lora_a",
                                   "router")):
            return spec(d_ax, "model")
        return spec(d_ax, "model")
    # 1D/scalars and anything exotic: replicated
    return (None,) * len(shape)


def param_shardings(param_shapes: Any, cfg, mesh, *, fsdp: bool = True):
    """param_shapes: a param tree of tensors (meta tensors from
    `specs.param_shapes`, or real ones). Block stacks (params['blocks'],
    'dense_prefix') have a leading repeat dim. Returns a tree of specs."""
    def one(name, leaf):
        stacked = name.startswith(("blocks/", "dense_prefix/"))
        return _rule(mesh, name, tuple(leaf.shape), fsdp, stacked)
    return map_with_path(one, param_shapes)


def batch_shardings(batch_shapes: Any, mesh):
    """Leading dim = global batch -> shard over ('pod', 'data') when it
    divides (long_500k's batch=1 stays replicated)."""
    dp = data_axes(mesh)

    def one(_, leaf):
        if leaf.dim() == 0:
            return ()
        return _fit(mesh, tuple(leaf.shape), (dp,) + (None,) * (leaf.dim() - 1))
    return map_with_path(one, batch_shapes)


def serving_param_shardings(param_shapes: Any, cfg, mesh):
    """Serving layout for the InfServer's hosted params: the 'model' axis
    split exactly as `param_shardings`, but no FSDP. Data axes carry the
    request batch instead (`obs_batch_sharding`)."""
    return param_shardings(param_shapes, cfg, mesh, fsdp=False)


def map_specs(fn, specs):
    """A spec tree with fn applied to each spec (a tuple leaf)."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    return specs


def stacked_param_shardings(shardings: Any, mesh):
    """Specs for the grouped θ+φ forward's (M, ...) stacked tree: the
    model-group axis M stays unsharded, every trailing dim keeps the
    per-model serving spec."""
    return map_specs(lambda spec: (None,) + tuple(spec), shardings)


def obs_batch_sharding(mesh, rows: int) -> tuple:
    """Data-parallel layout for a (rows, L) observation batch: rows over the
    ('pod', 'data') axes when they divide, replicated otherwise."""
    return _fit(mesh, (rows,), (data_axes(mesh),))


def grouped_obs_sharding(mesh, rows: int) -> tuple:
    """Layout for the grouped (M, S, L) observation tensor: model-group dim
    replicated, the per-model batch S data-parallel."""
    return _fit(mesh, (1, rows), (None, data_axes(mesh)))


def is_kv(name: str, nd: int) -> bool:
    """Whether the decode-state leaf `name` of rank `nd` is a KV cache's
    keys or values, (R, B, W, KV, hd)."""
    return nd == 5 and ("/k" in name or "/v" in name)


def cache_mode(state_specs) -> str:
    """How a decode state's KV caches lie over 'model', read from its
    specs: 'heads' (KV heads split), 'length' (cache slots split: the
    context-parallel variant) or 'whole' (replicated)."""
    for name, spec in spec_items(state_specs).items():
        if is_kv(name, len(spec)):
            if spec[3] is not None:
                return "heads"
            return "length" if spec[2] is not None else "whole"
    return "whole"


def state_shardings(state_shapes: Any, cfg, mesh, *, shard_cache_len: bool = False):
    """Decode-state specs. KV caches are (R, B, W, KV, hd): batch over data
    axes; KV heads over 'model' when divisible, else optionally the cache
    length W over 'model' (`shard_cache_len`, the context-parallel
    variant), else replicated on 'model'."""
    dp = data_axes(mesh)
    model = mesh_sizes(mesh)["model"]

    def one(name, leaf):
        shape, nd = tuple(leaf.shape), leaf.dim()
        if is_kv(name, nd):
            if shape[3] % model == 0:
                return _fit(mesh, shape, (None, dp, None, "model", None))
            if shard_cache_len:
                return _fit(mesh, shape, (None, dp, "model", None, None))
            return _fit(mesh, shape, (None, dp, None, None, None))
        if "tm_S" in name and nd == 4:
            return _fit(mesh, shape, (None, dp, "model", None))
        if "tm_S" in name and nd == 5:
            return _fit(mesh, shape, (None, dp, "model", None, None))
        if "ssm" in name and nd == 4:             # mamba h (R, B, di, N)
            return _fit(mesh, shape, (None, dp, "model", None))
        if "conv" in name and nd == 4:            # conv buf (R, B, K-1, di)
            return _fit(mesh, shape, (None, dp, None, "model"))
        if nd >= 2:
            return _fit(mesh, shape, (None, dp) + (None,) * (nd - 2))
        if nd == 1:
            return _fit(mesh, shape, (dp,))
        return ()
    return map_with_path(one, state_shapes)


# -- per-device sizes --------------------------------------------------------------

def shard_shape(shape, spec, mesh) -> tuple:
    """The per-device block of a `shape` laid out by `spec`
    (`NamedSharding.shard_shape`'s counterpart)."""
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is not None:
            out[i] //= _axis_size(mesh, ax)
    return tuple(out)


def per_device_bytes(tree, specs, mesh) -> int:
    """Sum over leaves of the shard shape's elements x itemsize."""
    by_path = spec_items(specs)
    total = 0
    for path, leaf in leaves_with_path(tree):
        spec = by_path[path_str(path)]
        total += math.prod(shard_shape(tuple(leaf.shape), spec, mesh)) * leaf.element_size()
    return total


# -- DTensor layouts -----------------------------------------------------------------

def placements(spec, mesh) -> list:
    """DTensor placements on `mesh` (a DeviceMesh with named dims) for one
    spec: Shard(dim) on every mesh dim that the dim's entry names."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(tree, specs, mesh):
    """Lay a tree of full tensors out over `mesh` by `specs` (each rank
    holds the same full tensor; it keeps its own shard)."""
    from torch.distributed.tensor import distribute_tensor
    by_path = spec_items(specs)
    return map_with_path(
        lambda name, t: distribute_tensor(t, mesh, placements(by_path[name], mesh)), tree)


def is_dtensor(x) -> bool:
    # no import: a DTensor exists only once its module is loaded, and loading
    # it costs a second in a process that never shards (the optimizer asks)
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def shard_groups(t) -> tuple:
    """The process groups of the mesh dims (of more than one rank) that the
    DTensor `t` is split over: the sum over them of each rank's sum of its
    shard is the sum of `t`. () for a plain tensor."""
    if not is_dtensor(t):
        return ()
    mesh, out = t.device_mesh, []
    for i, pl in enumerate(t.placements):
        if not (pl.is_shard() or pl.is_replicate()):
            raise ValueError(f"shard_groups: a {pl} placement holds no shard of the sum")
        if pl.is_shard() and mesh.size(i) > 1:
            out.append(mesh.get_group(i))
    return tuple(out)


def spec_of(t, mesh) -> tuple:
    """The spec of a DTensor's placements on `mesh`, `placements`' inverse
    (every dim None for a plain tensor)."""
    if not is_dtensor(t):
        return (None,) * t.dim()
    axes = [[] for _ in range(t.dim())]
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            axes[p.dim].append(name)
    return tuple(_entry(a) for a in axes)


def local_params(params, mesh):
    """(this rank's shards as plain tensors, {path: spec}) of a param tree
    of DTensors laid out over `mesh`."""
    specs = {}

    def one(name, t):
        specs[name] = spec_of(t, mesh)
        return t.to_local() if is_dtensor(t) else t
    return map_with_path(one, params), specs


def gather(t, keep: Sequence[str] = ()):
    """A DTensor's value at use on this rank: replicated over every mesh dim
    but those named in `keep` (which keep their placements), as a plain
    local tensor. The backward reduce-scatters the local grad (a partial
    sum on each rank) back to the DTensor's layout. A plain tensor is
    returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    names = t.device_mesh.mesh_dim_names
    target = [p if n in keep else Replicate() for n, p in zip(names, t.placements)]
    grad = [p if n in keep else Partial() for n, p in zip(names, t.placements)]
    return t.redistribute(t.device_mesh, target).to_local(grad_placements=grad)


def local_rows(t):
    """This rank's block of an input DTensor as a plain tensor: its rows of
    the data axes, and of a dim laid over 'model' (only a decode state's
    leaves are, and the mesh scope computes them as this rank's shards)
    its shard. A plain tensor is returned as it is."""
    return t.to_local() if is_dtensor(t) else t


def reduce_grads(grads, params, mesh):
    """A sharded step's local grads as DTensors in the params' layouts: each
    summed over the mesh dims its param is replicated on. (Over a dim the
    param is sharded on, the sum is already done: it is the reduce-scatter
    that ends the backward of the param's gather.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    names = mesh.mesh_dim_names

    def one(g, p):
        g = g.contiguous()
        for i, (name, pl) in enumerate(zip(names, p.placements)):
            if not pl.is_shard() and mesh.size(i) > 1:
                dist.all_reduce(g, group=mesh.get_group(name))
        return DTensor.from_local(g, mesh, p.placements, run_check=False)
    return tree_map(one, grads, params)


# -- collectives with their adjoints ----------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather_into(out, x, group):
    import torch.distributed as dist
    # `all_gather_single` supersedes `all_gather_into_tensor` in newer torch
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_into(out, x, group):
    import torch.distributed as dist
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's x along `dim` in group-rank order; the
    backward is the reduce-scatter (sum) of the grads."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
        _gather_into(out, xs, group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gs = g.movedim(ctx.dim, 0).contiguous()
        out = gs.new_empty((gs.shape[0] // ctx.n,) + tuple(gs.shape[1:]))
        _reduce_scatter_into(out, gs, ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _groups(mesh, axes):
    """The process groups of the named mesh dims, in mesh order; a dim of
    one rank has nothing to move and is left out."""
    names = mesh.mesh_dim_names
    return [mesh.get_group(a) for i, a in enumerate(names)
            if a in axes and mesh.size(i) > 1]


def all_reduce_sum(x, mesh, axes):
    """Sum over the ranks of the named mesh dims (autograd: its adjoint)."""
    for g in _groups(mesh, axes):
        x = _AllReduceSum.apply(x, g)
    return x


def all_gather(x, dim, mesh, axes):
    """Concatenate along `dim` over the named mesh dims, chunked outer-major
    (pod, then data) as a spec entry ('pod', 'data') lays a dim out."""
    for g in reversed(_groups(mesh, axes)):
        x = _AllGather.apply(x, dim, g)
    return x


def axis_index(mesh, axis) -> int:
    return mesh.get_local_rank(axis)


def data_index(mesh, axes) -> int:
    """This rank's index over the named mesh dims, outer-major (pod, then
    data): its block's place in what `all_gather` over them concatenates."""
    sizes, idx = mesh_sizes(mesh), 0
    for ax in (a for a in sizes if a in axes):
        idx = idx * sizes[ax] + axis_index(mesh, ax)
    return idx


def batch_axes(specs) -> Tuple[str, ...]:
    """The data axes the leading dim of a batch's specs is sharded over
    (() when replicated): what `data_parallel` reduces over."""
    for spec in spec_items(specs).values():
        if spec and spec[0] is not None:
            return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
    return ()


# -- the mesh scope: a rank's view of a sharded run ----------------------------------------

class _Params:
    """How this rank computes with the params of a sharded run: which
    slice of each leaf it uses, gathered from its shards at use."""

    def __init__(self, mesh, specs, cfg, tp: bool, ep: bool, cache=None):
        self.mesh, self.specs, self.cfg = mesh, specs, cfg
        self.M = mesh_sizes(mesh).get("model", 1)
        self.m = axis_index(mesh, "model") if self.M > 1 else 0
        M, H, KV = self.M, cfg.num_heads, cfg.num_kv_heads
        self.tp = tp and M > 1
        self.cache = cache if M > 1 else None
        # a cache split by length keeps every head on every rank, so its
        # attention blocks run whole
        self.attn_tp = (self.tp and H % M == 0 and (KV % M == 0 or M % KV == 0)
                        and self.cache != "length")
        # a cache replicated over 'model' holds every KV head: wk and wv whole
        self.kv_whole = self.attn_tp and self.cache == "whole"
        # the experts split by expert parallelism, and under tensor
        # parallelism too (`repro`'s GSPMD pins the expert buffers to 'model')
        self.experts = ((ep and M > 1) or self.tp) and cfg.moe is not None \
            and cfg.moe.num_experts % M == 0
        # the recurrent blocks split where `state_shardings` lays their
        # states over 'model': RWKV6's time mix by head (tm_S), its channel
        # mix by hidden dim, Mamba by its inner dim (ssm, conv)
        ssm = cfg.ssm
        rwkv = self.tp and ssm is not None and ssm.kind == "rwkv6"
        self.rwkv_tp = rwkv and (cfg.d_model // ssm.head_size) % M == 0
        self.cm_tp = rwkv and cfg.d_ff % M == 0
        self.mamba_tp = (self.tp and ssm is not None and ssm.kind == "mamba"
                         and (ssm.expand * cfg.d_model) % M == 0)

    def slice_of(self, name: str, nd: int):
        """(dim, chunks, index) or (dim, chunks, index, parts): the slice of
        leaf `name` (rank `nd`) that this rank computes with, or None for
        the whole leaf. With `parts` the dim is `parts` equal blocks and
        the rank takes the same chunk of each.
          - experts: E/M of them;
          - attention (when the heads split): H/M query heads, the key and
            value heads they read (KV/M of them, or the one they share
            when KV < M; all of them over a decode cache that keeps every
            head), and wo's rows for those heads;
          - MLP and shared expert: ff/M columns of up and gate, the same
            rows of down (the port's MLPs have no bias);
          - RWKV6's time mix: H/M heads' columns of wr, wk, wv and wg,
            their block of w_base and u, and wo's rows (the ddlerp mix and
            the per-head groupnorm stay whole); its channel mix: d_ff/M
            columns of wk, the same rows of wv;
          - Mamba: di/M inner channels, in both halves [z | x] of in_proj,
            and in conv, dt_proj, A_log, D, and x_proj's and out_proj's rows;
          - embed table rows and lm_head columns: V/M of the vocab."""
        M, m, cfg = self.M, self.m, self.cfg
        parts = name.split("/")
        if self.experts and parts[-2:-1] == ["moe"] and parts[-1] in ("up", "gate", "down"):
            return (-3, M, m)
        if not self.tp:
            return None
        if "time_mix" in parts and self.rwkv_tp:
            if parts[-1] == "w" and parts[-2] in ("wr", "wk", "wv", "wg"):
                return (-1, M, m)
            if parts[-2:] == ["wo", "w"]:
                return (-2, M, m)
            if parts[-1] in ("w_base", "u"):
                return (0, M, m)
            return None
        if "channel_mix" in parts and self.cm_tp and parts[-1] == "w":
            return (-1, M, m) if parts[-2] == "wk" else (-2, M, m)
        if "mamba" in parts and self.mamba_tp:
            leaf = "/".join(parts[parts.index("mamba") + 1:])
            if leaf == "in_proj/w":
                return (-1, M, m, 2)
            if leaf in ("conv_w", "conv_b", "D", "dt_proj/w", "dt_proj/b"):
                return (-1, M, m)
            if leaf in ("A_log", "x_proj/w", "out_proj/w"):
                return (-2, M, m)
            raise ValueError(f"{name}: no split over 'model' for this Mamba leaf")
        if "attn" in parts and parts[-2] in ("wq", "wk", "wv", "wo"):
            if not self.attn_tp:
                return None
            if parts[-2] == "wq":
                return (-1, M, m)
            if parts[-2] == "wo":
                return (-2, M, m) if parts[-1] == "w" else None
            if self.kv_whole:
                return None
            KV = cfg.num_kv_heads
            return (-1, M, m) if KV % M == 0 else (-1, KV, m // (M // KV))
        if ("mlp" in parts or "shared" in parts) and parts[-2] in ("up", "gate", "down"):
            ff = cfg.shared_ff if "shared" in parts else cfg.d_ff
            if ff % M:
                return None
            if parts[-2] != "down":
                return (-1, M, m)
            if parts[-1] != "w":
                raise ValueError(f"{name}: a row-parallel bias would be summed over 'model'")
            return (-2, M, m)
        if cfg.vocab_size % M == 0:
            if name == "embed/table" and nd == 2:
                return (-2, M, m)
            if name == "lm_head/w":
                return (-1, M, m)
        return None

    def use(self, name: str, t: torch.Tensor, index_dim):
        """Leaf `name` as this rank computes with it: its local shard `t`
        (with the repeat dim `index_dim` of its stack indexed away)
        gathered over every mesh axis it is sharded on, except 'model'
        where that shard is already the slice this rank uses."""
        spec = list(self.specs[name])
        if index_dim is not None:
            del spec[index_dim]
        want = self.slice_of(name, t.dim())
        if want is not None:
            want = (want[0] % t.dim(),) + want[1:]
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            # the stored shard is a contiguous block: it is the slice only
            # when the slice is one block of M
            if (want is not None and d == want[0] and ax == "model" and want[1] == self.M
                    and len(want) == 3):
                want = None
                continue
            t = all_gather(t, d, self.mesh, (ax,) if isinstance(ax, str) else ax)
        if want is not None:
            d, n, i = want[:3]
            parts = want[3] if len(want) > 3 else 1
            t = t.unflatten(d, (parts, -1))
            size = t.shape[d + 1] // n
            t = t.narrow(d + 1, size * i, size).flatten(d, d + 1)
        return t


class _State:
    __slots__ = ("dp_mesh", "dp_axes", "params")

    def __init__(self, dp_mesh=None, dp_axes=(), params=None):
        self.dp_mesh, self.dp_axes, self.params = dp_mesh, tuple(dp_axes), params


_scope = threading.local()
_EMPTY = _State()


def capture() -> _State:
    """This thread's mesh scope, to re-enter where the work runs later (a
    checkpointed unit's recompute runs in autograd's thread)."""
    return getattr(_scope, "st", _EMPTY)


@contextlib.contextmanager
def restored(state: _State):
    prev = capture()
    _scope.st = state
    try:
        yield
    finally:
        _scope.st = prev


def data_parallel(mesh, axes):
    """Within this scope (per thread) the local batch is this rank's rows
    of the data axes `axes` (() when the batch is replicated): `batch_sum`
    all-reduces over them, and the MoE routes this rank's tokens with the
    load statistics averaged over the data axes."""
    st = capture()
    return restored(_State(mesh, axes, st.params))


def param_scope(mesh, specs, cfg, *, tp: bool = True, ep: bool = False, cache=None):
    """Within this scope (per thread) the model's params are this rank's
    local shards, laid out by `specs` ({path: spec}), and each block of
    code gathers what it uses at use (`materialize`): a repeat unit's
    weights for that unit only, so a rank holds its shards and one unit
    gathered. With `tp` the 'model' axis splits the compute (tensor
    parallelism: `_Params.slice_of`), the experts included; `ep` keeps
    each rank's experts without it (expert parallelism). `cache` (`cache_mode`: 'heads', 'length' or
    'whole') is how the decode caches lie over 'model' in a prefill or a
    decode step; `cache_heads` and `cache_slots` size this rank's."""
    st = capture()
    return restored(_State(st.dp_mesh, st.dp_axes,
                           _Params(mesh, specs, cfg, tp, ep, cache)))


def materialize(tree, prefix=(), index_dim=None):
    """The param subtree at `prefix` as this rank computes with it (see
    `param_scope`); the tree itself outside one. `index_dim`: the stack's
    repeat dim, which the caller indexed away."""
    p = capture().params
    if p is None:
        return tree
    return map_with_path(lambda name, t: p.use(name, t, index_dim), tree, tuple(prefix))


def dp_mesh():
    """The mesh of the data-parallel scope, or None."""
    return capture().dp_mesh


def dp_axes() -> Tuple[str, ...]:
    """The data axes the batch of the data-parallel scope is split over
    (() outside one, or when the batch is replicated)."""
    return capture().dp_axes


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over the batch: x is this rank's partial sum; inside a
    data-parallel scope the result is the global sum on every rank."""
    st = capture()
    return x if not st.dp_axes else all_reduce_sum(x, st.dp_mesh, st.dp_axes)


def model_index() -> int:
    p = capture().params
    return 0 if p is None else p.m


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum the partial results of a tensor-parallel block over 'model'."""
    p = capture().params
    return x if p is None else all_reduce_sum(x, p.mesh, ("model",))


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every model rank's x (gathered, then
    reduced: the collectives stay those the sum and the gather use)."""
    p = capture().params
    if p is None or p.M == 1:
        return x
    return all_gather(x[None], 0, p.mesh, ("model",)).amax(0)


def cache_heads(cfg) -> int:
    """The KV heads this rank's decode caches hold: KV/M when the scope
    splits them over 'model', else all of them."""
    p = capture().params
    if p is not None and p.cache == "heads":
        return cfg.num_kv_heads // p.M
    return cfg.num_kv_heads


def cache_slots(cache_len: int) -> Tuple[int, int]:
    """(first, count): the slots of a `cache_len`-slot decode cache whose
    keys and values this rank holds, a contiguous block of cache_len/M
    when the scope splits the cache length over 'model' (the
    context-parallel variant), else all of them."""
    p = capture().params
    if p is not None and p.cache == "length":
        n = cache_len // p.M
        return p.m * n, n
    return 0, cache_len


def rwkv_heads(cfg) -> int:
    """The RWKV6 heads this rank's time mix runs and its `tm_S` holds: H/M
    when the scope splits them over 'model', else all H."""
    p = capture().params
    H = cfg.d_model // cfg.ssm.head_size
    return H // p.M if p is not None and p.rwkv_tp else H


def mamba_channels(cfg) -> int:
    """The Mamba inner channels this rank computes and its `conv` and `ssm`
    states hold: di/M when the scope splits them over 'model', else all."""
    p = capture().params
    di = cfg.ssm.expand * cfg.d_model
    return di // p.M if p is not None and p.mamba_tp else di


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Concatenate each model rank's slice of `dim` (a vocab-parallel
    head's logits)."""
    p = capture().params
    return x if p is None else all_gather(x, dim, p.mesh, ("model",))

"""Dry-run step factory: builds (fn, args, in_shardings, out_shardings) for
every (arch x input-shape x mesh) combination; counterpart of
`repro.launch.steps`.

`args` are meta tensors (`launch/specs.py`) and the shardings are spec
trees (`distributed/sharding.py`). On an `AbstractMesh` (the production
meshes) `fn` is the single-device step, which the dry-run evaluates on the
meta args. On a `DeviceMesh` `fn` runs sharded: given DTensor params, state
and batch laid out by `in_shardings`, each rank keeps its param shards and
computes on its rows of the batch, and `fn` returns DTensors laid out by
`out_shardings`. Every step gathers one repeat unit's weights at a time
(FSDP over the data axes) and splits the compute over 'model' (tensor
parallelism: the heads, the MLP's hidden dim, the vocab, the experts,
RWKV6's heads and channel-mix hidden dim, Mamba's inner channels; the
per-shard capacity of expert parallelism with `moe_ep`): the train steps
in `learners/steps.py`, prefill and decode in `_spmd`. Their states lie as
`repro`'s `state_shardings` lays them out: a rank holds its KV heads when
they split over 'model', its block of the cache slots with
`shard_cache_len` (attention merged across 'model' by log-sum-exp), or
every head; RWKV6's `tm_S` its heads and Mamba's `ssm` and `conv` its
channels where they split. The state crosses `_spmd` as those shards, with
no gather. The kernels it reaches (flash forward, dq, dk/dv, RMSNorm, the
scan) see plain local tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.learners.steps import build_mlm_train_step, build_seq_train_step
from repro_torch.models import decode_step, prefill
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.utils import tree_map


def make_optimizer(cfg):
    return adamw(3e-4, clip_norm=1.0, master_fp32=(cfg.param_dtype == "bfloat16"))


def _opt_shardings(opt_shapes, pshard):
    out = {"step": (), "mu": pshard, "nu": pshard}
    if "master" in opt_shapes:
        out["master"] = pshard
    return out


def _replicate_tree(tree):
    return tree_map(lambda t: (None,) * t.dim(), tree)


def _spmd(fn, cfg, mesh, out_specs, state_specs):
    """Run a row-parallel `fn` (prefill, decode) on a DeviceMesh: params as
    this rank's shards in a tensor-parallel param scope (each unit
    gathered at use over the data axes, its 'model' slice kept), the
    decode state as this rank's shards of it (the KV caches by
    `sharding.cache_mode` of `state_specs`: its KV heads, its block of
    slots, or whole; RWKV6's and Mamba's states by head or channel where
    their specs split them), every other input as this rank's rows, and
    each output wrapped back as a DTensor laid out by its spec: every
    state leaf is this rank's shard already."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cache = SH.cache_mode(state_specs)

    def wrap(name, spec, t):
        pl = []
        for axis in SH.mesh_sizes(mesh):
            dim = next((i for i, ax in enumerate(spec) if ax is not None and axis in
                        ((ax,) if isinstance(ax, str) else ax)), None)
            pl.append(Replicate() if dim is None else Shard(dim))
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False)

    def run(params, *inputs, axes):
        local, specs = SH.local_params(params, mesh)
        rows = SH.map_with_path(lambda _, t: SH.local_rows(t), inputs)
        with SH.data_parallel(mesh, axes), \
                SH.param_scope(mesh, specs, cfg, ep=MOE.expert_parallel(), cache=cache):
            out = fn(local, *rows)
        flat = {}
        for i, spec in enumerate(out_specs):
            flat.update({f"{i}/{k}" if k else str(i): v
                         for k, v in SH.spec_items(spec).items()})
        return _zip_specs(out, flat, wrap)

    return run


def _zip_specs(tree, flat_specs, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _zip_specs(v, flat_specs, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(v, flat_specs, fn, prefix + (i,))
                          for i, v in enumerate(tree))
    name = SH.path_str(prefix)
    return fn(name, flat_specs[name], tree)


def make_dryrun_step(cfg, shape_name: str, mesh, *, fsdp: bool = True,
                     shard_cache_len: bool = False, loss: str = "ppo",
                     remat: bool = True, unroll: bool = False, q_chunk: int = 512,
                     uniform_lengths: bool = True, moe_ep: bool = False):
    """Returns dict(kind, fn, args, in_shardings, out_shardings, outs), or
    dict(kind='skip'); `outs` are the outputs' meta tensors. `unroll` and `q_chunk` have no counterpart in the
    port (its loop over repeats is plain Python and its attention kernels
    tile the sequence); they are accepted for `repro`'s signature."""
    kind, sp = SP.input_specs(cfg, shape_name)
    if kind == "skip":
        return {"kind": "skip"}
    real = not isinstance(mesh, SH.AbstractMesh)
    MOE.set_expert_parallel(moe_ep)

    params_shapes = SP.param_shapes(cfg)
    pshard = SH.param_shardings(params_shapes, cfg, mesh, fsdp=fsdp)

    if kind in ("train", "mlm_train"):
        opt = make_optimizer(cfg)
        step_mesh = mesh if real else None
        if kind == "train":
            fn = build_seq_train_step(cfg, opt, loss=loss, remat=remat, mesh=step_mesh)
        else:
            fn = build_mlm_train_step(cfg, opt, remat=remat, mesh=step_mesh)
        opt_shapes = opt.init(params_shapes)
        oshard = _opt_shardings(opt_shapes, pshard)
        metrics = SP.metric_shapes(cfg, kind, loss)
        bshard = SH.batch_shardings(sp, mesh)
        return {
            "kind": kind, "fn": fn,
            "args": (params_shapes, opt_shapes, sp),
            "in_shardings": (pshard, oshard, bshard),
            "out_shardings": (pshard, oshard, _replicate_tree(metrics)),
            "outs": (params_shapes, opt_shapes, metrics),
        }

    shp = INPUT_SHAPES[shape_name]
    B = shp.global_batch
    heads = (SP._sds((B, cfg.vocab_size), torch.float32), SP._sds((B,), torch.float32))
    dp_out = SH.batch_shardings(heads, mesh)
    if kind == "prefill":
        def fn_local(params, batch):
            logits, values, state = prefill(params, cfg, batch)
            return logits[:, -1], values[:, -1], state

        bshard = SH.batch_shardings(sp, mesh)
        out_state = SP.prefill_state_shapes(cfg, shp)
        sshard = SH.state_shardings(out_state, cfg, mesh, shard_cache_len=shard_cache_len)
        out_shardings = (dp_out[0], dp_out[1], sshard)
        fn = fn_local
        if real:
            run = _spmd(fn_local, cfg, mesh, out_shardings, sshard)
            fn = lambda params, batch: run(params, batch,
                                           axes=SH.batch_axes(bshard))
        return {"kind": kind, "fn": fn, "args": (params_shapes, sp),
                "in_shardings": (pshard, bshard), "out_shardings": out_shardings,
                "outs": heads + (out_state,)}

    # decode
    sliding = SP.uses_sliding(cfg, shp)
    window = min(shp.seq_len, cfg.long_context_window) if sliding and cfg.family != "ssm" else 0

    def fn_local(params, tokens, state):
        # uniform=True: serving batches decode in lockstep (same position
        # per row)
        return decode_step(params, cfg, tokens, state, window=window,
                           uniform=uniform_lengths)

    sshard = SH.state_shardings(sp["state"], cfg, mesh, shard_cache_len=shard_cache_len)
    tshard = SH.batch_shardings(sp["tokens"], mesh)
    heads = (SP._sds((B, 1, cfg.vocab_size), torch.float32), SP._sds((B, 1), torch.float32))
    head_out = SH.batch_shardings(heads, mesh)
    out_shardings = (head_out[0], head_out[1], sshard)
    fn = fn_local
    if real:
        run = _spmd(fn_local, cfg, mesh, out_shardings, sshard)
        fn = lambda params, tokens, state: run(params, tokens, state,
                                               axes=SH.batch_axes(tshard))
    return {"kind": kind, "fn": fn, "args": (params_shapes, sp["tokens"], sp["state"]),
            "in_shardings": (pshard, tshard, sshard), "out_shardings": out_shardings,
            "outs": heads + (sp["state"],)}


#!/usr/bin/env python3
"""Two ranks of the port's mesh on ONE CUDA card, over the gloo backend.

NCCL refuses two ranks on one device, so this tries gloo on CUDA tensors:

  1. probes each collective the sharded step calls (all_reduce,
     all_gather_into_tensor, reduce_scatter_tensor, and DTensor's
     from_local/to_local, which move nothing) on CUDA tensors, each in a
     fresh pair of processes, and prints torch's own error, or the signal
     that ended a rank, for each one gloo refuses; DTensor's
     redistribute with a Partial grad back is probed too and reported,
     but the step does not call it;
  2. if the step's collectives pass, runs `launch.steps.make_dryrun_step`'s
     train step (qwen3-8b at full width, 2 layers, 1 x 4,096 tokens, fp32)
     and `moe_apply_ep` (qwen3-moe's MoE layer, 4 x 1,024 tokens, fp32) on
     a (1, 2) mesh (model = 2: tensor parallelism over the heads, the
     MLP's hidden dim and the vocab; two experts' halves), each held
     against the single rank's result on the same card within 1e-4 of
     max(1, max |.|). The DTensors are built and read back with
     from_local/to_local and the plain collectives;
  3. runs the factory's prefill and decode fns (tensor-parallel serving)
     for command-r-35b and mistral-large-123b at full width, 2 layers, fp32
     compute over their bf16 params: a 4 x 256 prefill and 4 uniform
     decode steps of seeded tokens on the (1, 2) mesh, each rank's KV
     caches holding 4 of the 8 KV heads. The last position's logits and
     values, each step's, and every leaf of the final state are held
     against the single rank's `prefill` and `decode_step` within 1e-4 of
     max(1, max |.|), and each rank's cache bytes printed beside the
     single rank's.

  4. (`--split`, alone) the blocks that split over 'model' besides the
     heads: rwkv6-3b (d 2,560, 40 heads, d_ff 8,960) and hymba-1.5b
     (d 1,600, di 3,200, 25/5 heads) at full width, 2 layers, fp32, through
     the factory's prefill and decode fns as in 3 (each rank's `tm_S`
     holding 20 of the 40 heads, its `ssm` and `conv` 1,600 of the 3,200
     channels; hymba's attention and KV caches whole), each rank's state
     bytes printed beside the single rank's; and one repeat unit of
     qwen3-moe (attention, then the routed MoE through `moe_apply` without
     `moe_ep`: each rank computes 64 of the 128 experts, with the global
     capacity) on 4 x 1,024 tokens at fp32, its output, aux loss and every
     grad against the single rank's. The step's collectives are probed in
     the two ranks first; there a refused one fails the run. Each sharded
     case runs once to warm up, then again, held and timed (with its
     collectives' share); it reports each rank's kernel launches and
     whether a plain version ran. The single rank runs warm, alone.
     rwkv6-3b's held prefill runs under the per-rank counter
     (`launch.counters.Counter`): each rank's FLOPs and collectives by
     kind are reported (`counted_prefill`), for `chip_smoke.py` to hold
     against the dry-run's count, and each rank's launches must equal the
     warm-up's, which ran without it.

    python3 tools/mesh_two_ranks.py [--probe-only | --split]

Prints one JSON line per rank-0 result; exits non-zero when a held result
disagrees. Without `--split` a collective that gloo refuses is a finding,
not a failure: the probe line says which and why, and step 2 is skipped
(exit 0). With `--split` the last line is `{"two_ranks": "split_done",
...}`, and the exit code is 0 only when every case held.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-4
T = 4096
SERVE_ARCHS = ("command-r-35b", "mistral-large-123b")
SERVE_LAYERS, SERVE_B, SERVE_T, SERVE_STEPS = 2, 4, 256, 4
SPLIT_ARCHS = ("rwkv6-3b", "hymba-1.5b")
COUNTED_ARCH = "rwkv6-3b"         # its held prefill runs under the per-rank counter
MOE_ARCH, MOE_B, MOE_T = "qwen3-moe-235b-a22b", 4, 1024
SPLIT_CASES = tuple(f"split_prefill_and_decode:{a}" for a in SPLIT_ARCHS) + (
    f"split_moe_unit:{MOE_ARCH}",)
SPLIT_PG_TIMEOUT_S = 120          # a rank that a refused collective ends must not hang the other
KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "reverse_discounted_scan_p")


def rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / max(1.0, want.abs().max().item())).item()


PROBES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
          "dtensor_local", "dtensor_redistribute_with_grad")
STEP_PROBES = PROBES[:4]                    # what the sharded step calls


def run_probe(name, dev):
    """One collective the mesh paths call, on CUDA tensors."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh

    world = dist.get_world_size()
    x = torch.ones(4, device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(4 * world, device=dev), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(4 // world, device=dev), x)
    elif name == "dtensor_local":
        from torch.distributed.tensor import DTensor
        mesh = make_local_mesh(dev, shape=(1, world))
        w = DTensor.from_local(torch.randn(8, 3, device=dev), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        assert w.shape == (8, 3 * world) and w.to_local().shape == (8, 3)
    else:
        mesh = make_local_mesh(dev, shape=(1, world))
        w = distribute_tensor(torch.randn(8, 6, device=dev), mesh,
                              [Replicate(), Shard(1)]).requires_grad_()
        full = w.redistribute(mesh, [Replicate(), Replicate()]).to_local(
            grad_placements=[Partial(), Partial()])
        full.square().sum().backward()
        assert w.grad.to_local().shape == (8, 6 // world)
    torch.cuda.synchronize()


def _probe_rank(rank, world, store, name, out):
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        run_probe(name, dev)
        out.put((rank, None))
    except Exception as e:            # noqa: BLE001 — the finding is the error
        out.put((rank, f"{type(e).__name__}: {e}"[:400]))
    finally:
        dist.destroy_process_group()


def probe(world, timeout=120.0):
    """{collective: None, or torch's error, or the signal that ended a
    rank}, each collective in a fresh group of `world` processes (a crash
    of one must not hide the others)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    found = {}
    for name in PROBES:
        store = os.path.join(tempfile.mkdtemp(dir=ROOT / "build"), "store")
        out = ctx.SimpleQueue()
        procs = [ctx.Process(target=_probe_rank, args=(r, world, store, name, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        while not out.empty():
            errs.append(out.get()[1])
        codes = [p.exitcode for p in procs]
        if any(c and c < 0 for c in codes):
            found[name] = f"a rank ended by signal {-min(codes)} (exit codes {codes})"
        elif any(errs) or len(errs) < world:
            found[name] = next((e for e in errs if e), f"exit codes {codes}")
        else:
            found[name] = None
    return found


def train_step(dev, mesh):
    """(loss, grads) of qwen3-8b's 2-layer step, sharded on `mesh` (None:
    the single rank's)."""
    import numpy as np
    import torch

    from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_dryrun_step, make_optimizer
    from repro_torch.learners import build_seq_train_step
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=2, compute_dtype="float32",
                              param_dtype="float32")
    rng = np.random.default_rng(22)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "tokens": rng.integers(0, cfg.vocab_size, (1, T)),
        "actions": rng.integers(0, cfg.vocab_size, (1, T)),
        "behavior_logp": (-np.abs(rng.normal(size=(1, T))) - 6.0).astype(np.float32),
        "behavior_values": rng.normal(size=(1, T)).astype(np.float32),
        "rewards": rng.normal(size=(1, T)).astype(np.float32),
        "discounts": (0.99 * (rng.random((1, T)) >= 0.01)).astype(np.float32),
        "bootstrap_value": rng.normal(size=(1,)).astype(np.float32)}.items()}
    params = init_params(torch.Generator(device=dev).manual_seed(23), cfg)
    if mesh is None:
        loss, _, g = build_seq_train_step(cfg, make_optimizer(cfg)).value_and_grad(params, batch)
        return loss, [t for _, t in SH.leaves_with_path(g)]
    INPUT_SHAPES["train_4k_b1"] = InputShape("train_4k_b1", T, 1, "train")
    built = make_dryrun_step(cfg, "train_4k_b1", mesh)
    pshard, _, bshard = built["in_shardings"]
    pd, bd = from_local(params, pshard, mesh), from_local(batch, bshard, mesh)
    del params
    loss, _, g = built["fn"].value_and_grad(pd, bd)
    return loss, [full(t, mesh) for _, t in SH.leaves_with_path(g)]


def block(t, pl, mesh):
    """This rank's block of a full tensor `t` laid out by placements `pl`."""
    for i, p in enumerate(pl):
        if p.is_shard():
            t = t.chunk(mesh.size(i), p.dim)[mesh.get_local_rank(mesh.mesh_dim_names[i])]
    return t


def from_local(tree, specs, mesh):
    """DTensors laid out by `specs`, each rank cutting its own block of the
    full tensors it holds (no collective)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SH
    by_path = SH.spec_items(specs)

    def one(name, t):
        pl = SH.placements(by_path[name], mesh)
        return DTensor.from_local(block(t, pl, mesh).contiguous(), mesh, pl, run_check=False)
    return SH.map_with_path(one, tree)


def full(t, mesh):
    """A DTensor's full value, gathered with the plain collectives."""
    from repro_torch.distributed import sharding as SH
    local = t.to_local()
    for i, p in reversed(list(enumerate(t.placements))):
        if p.is_shard():
            local = SH.all_gather(local, p.dim, mesh, (mesh.mesh_dim_names[i],))
    return local


def moe_step(dev, mesh):
    """(y, aux, grads) of qwen3-moe's MoE layer: `moe_apply_ep` on `mesh`,
    or `moe_apply` (None)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"), compute_dtype="float32",
                              param_dtype="float32")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(24), cfg, torch.float32)
    x = torch.randn(4, 1024, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(25))
    p = tree_map(lambda t: t.requires_grad_(True), p)
    if mesh is None:
        y, aux = moe.moe_apply(p, cfg, x)
        return y, aux, list(torch.autograd.grad(y.sum(), tree_leaves(p)))
    # every rank holds the whole layer and runs its half of the experts;
    # the grads of the replicated weights are summed over the ranks
    with SH.data_parallel(mesh, ("data",)):
        y, aux = moe.moe_apply_ep(p, cfg, x, mesh)
        loss = SH.batch_sum(y.sum())
    grads = torch.autograd.grad(loss / mesh.size(), tree_leaves(p))
    return y, aux, [SH.all_reduce_sum(g, mesh, ("data", "model")) for g in grads]


def state_bytes(state) -> dict:
    """{kind: bytes} of a decode state's leaves on this rank: the KV caches
    ('kv'), RWKV6's `tm_S` and Mamba's `ssm` and `conv` (the leaves a
    split over 'model' cuts)."""
    from repro_torch.distributed import sharding as SH
    out = {}
    for path, t in SH.leaves_with_path(state):
        name = SH.path_str(path)
        leaf = name.rsplit("/", 1)[-1]
        kind = "kv" if SH.is_kv(name, t.dim()) else next(
            (k for k in ("tm_S", "ssm", "conv") if leaf.startswith(k)), None)
        if kind:
            out[kind] = out.get(kind, 0) + t.numel() * t.element_size()
    return out


def serve_cfg(arch):
    """`arch` at full width, SERVE_LAYERS layers, fp32 compute."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), num_layers=SERVE_LAYERS, compute_dtype="float32")


def serve_shapes():
    """Register the prefill and decode input shapes the factory's fns take."""
    from repro_torch.configs import INPUT_SHAPES, InputShape
    INPUT_SHAPES["two_ranks_prefill"] = InputShape("two_ranks_prefill", SERVE_T, SERVE_B,
                                                   "prefill")
    # the decode state's specs are those of the prefill's cache (64 slots more)
    INPUT_SHAPES["two_ranks_decode"] = InputShape("two_ranks_decode", SERVE_T + 64, SERVE_B,
                                                  "decode")


def serve_steps(dev, arch, mesh, counter=None):
    """(outputs, {kind: state bytes on this rank}, ms) of `arch`'s prefill
    and decode at full width, SERVE_LAYERS layers, fp32 compute: through
    the dry-run factory's fns on `mesh`, or the unsharded `prefill` and
    `decode_step` (None). outputs: the last position's logits and values,
    each step's, and every leaf of the final state, as full tensors; ms:
    the prefill and the steps on the host clock, synchronised (not the
    params' init nor the outputs' gather). `counter` (a
    `launch.counters.Counter`, with a mesh) counts the sharded prefill
    call alone."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.models import decode_step, init_params, prefill

    cfg = serve_cfg(arch)
    params = init_params(torch.Generator(device=dev).manual_seed(28), cfg)
    toks = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_T + SERVE_STEPS))).to(dev)
    steps = range(SERVE_T, SERVE_T + SERVE_STEPS)
    if mesh is None:
        def run():
            lg, v, st = prefill(params, cfg, {"tokens": toks[:, :SERVE_T]})
            res = [lg[:, -1], v[:, -1]]
            del lg
            for i in steps:
                dl, dv, st = decode_step(params, cfg, toks[:, i:i + 1], st, uniform=True)
                res += [dl, dv]
            return res, st
        ms, (res, st) = timed(run)
        return res + [t for _, t in SH.leaves_with_path(st)], state_bytes(st), ms
    serve_shapes()
    pre = make_dryrun_step(cfg, "two_ranks_prefill", mesh)
    dec = make_dryrun_step(cfg, "two_ranks_decode", mesh)
    pd = from_local(params, pre["in_shardings"][0], mesh)
    del params

    def run():
        batch = from_local({"tokens": toks[:, :SERVE_T]}, pre["in_shardings"][1], mesh)
        with counter or contextlib.nullcontext():
            lg, v, st = pre["fn"](pd, batch)
        res = [lg, v]
        for i in steps:
            dl, dv, st = dec["fn"](pd, from_local(toks[:, i:i + 1], dec["in_shardings"][1],
                                                  mesh), st)
            res += [dl, dv]
        return res, st
    ms, (res, st) = timed(run)
    local = state_bytes(SH.map_with_path(lambda _, t: t.to_local(), st))
    return [full(t, mesh) for t in res] + [full(t, mesh) for _, t in SH.leaves_with_path(st)], \
        local, ms


def rank_main(rank, world, store):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_local_mesh(dev, shape=(1, world))
        loss1, g1 = train_step(dev, mesh)
        torch.cuda.empty_cache()
        bad = 0
        if rank == 0:
            loss0, g0 = train_step(dev, None)
            errs = {"loss": abs(loss1.item() - loss0.item()),
                    "grads": max(rel_err(a, b) for a, b in zip(g1, g0))}
            bad += any(e > TOL for e in errs.values())
            print(json.dumps({"two_ranks": "train_step", "arch": "qwen3-8b", "layers": 2,
                              "tokens": T, "mesh": [1, world], "max_abs_err": errs,
                              "tol": TOL}), flush=True)
            del g0
        del g1
        torch.cuda.empty_cache()
        dist.barrier()
        y1, a1, g1 = moe_step(dev, mesh)
        if rank == 0:
            y0, a0, g0 = moe_step(dev, None)
            errs = {"y": rel_err(y1, y0), "aux": abs(a1.item() - a0.item()),
                    "grads": max(rel_err(a, b) for a, b in zip(g1, g0))}
            bad += any(e > TOL for e in errs.values())
            print(json.dumps({"two_ranks": "moe_apply_ep", "arch": "qwen3-moe-235b-a22b",
                              "mesh": [1, world], "max_abs_err": errs, "tol": TOL}),
                  flush=True)
            del y0, g0
        del y1, g1
        torch.cuda.empty_cache()
        dist.barrier()
        for arch in SERVE_ARCHS:
            with torch.no_grad():
                got, nbytes, _ = serve_steps(dev, arch, mesh)
                each = SH.all_gather(torch.tensor([nbytes["kv"]], device=dev), 0, mesh,
                                     ("model",))
                torch.cuda.empty_cache()
                if rank == 0:
                    want, single, _ = serve_steps(dev, arch, None)
                    floats = [(a, b) for a, b in zip(got, want) if b.is_floating_point()]
                    ints_equal = all(torch.equal(a, b) for a, b in zip(got, want)
                                     if not b.is_floating_point())
                    errs = {"outputs": max(rel_err(a, b) for a, b in floats[:2 + 2 * SERVE_STEPS]),
                            "state": max(rel_err(a, b) for a, b in floats[2 + 2 * SERVE_STEPS:])}
                    ok = len(got) == len(want) and ints_equal and all(e <= TOL
                                                                      for e in errs.values())
                    bad += not ok
                    print(json.dumps({"two_ranks": "prefill_and_decode", "arch": arch,
                                      "layers": SERVE_LAYERS, "batch": SERVE_B,
                                      "prompt": SERVE_T, "steps": SERVE_STEPS,
                                      "mesh": [1, world], "max_abs_err": errs,
                                      "positions_equal": ints_equal, "tol": TOL,
                                      "cache_bytes": {"each_rank": each.tolist(),
                                                      "single_rank": single["kv"]}}),
                          flush=True)
                    del want
                del got
                torch.cuda.empty_cache()
            dist.barrier()
        return int(bad > 0)
    finally:
        dist.destroy_process_group()


# -- (4) --split: RWKV6, Mamba and the experts over 'model' ------------------------------

def counters():
    """The port's kernel wrappers, each counting its launches."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan_p
    return (rmsnorm, fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, reverse_discounted_scan_p)


def zero_counts():
    from repro_torch.kernels import dispatch
    for c in counters():
        c.launches = 0
    dispatch.stats(reset=True)


def read_counts():
    """([launches per kernel, in KERNELS' order], whether a plain version
    ran) since `zero_counts`."""
    from repro_torch.kernels import dispatch
    plain = any("|reference" in k for k in dispatch.stats(reset=True))
    return [c.launches for c in counters()], plain


def each_rank(values, dev, mesh):
    """Every model rank's list of ints, gathered (one list per rank)."""
    import torch

    from repro_torch.distributed import sharding as SH
    t = torch.tensor([list(values)], dtype=torch.int64, device=dev)
    return SH.all_gather(t, 0, mesh, ("model",)).tolist()


@contextlib.contextmanager
def collectives_timed():
    """Time every collective the mesh paths call on this rank (the card
    synchronised around each, host clock): yields {"calls", "ms"}."""
    import torch
    import torch.distributed as dist
    rec = {"calls": 0, "ms": 0.0}
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_gather_single", "reduce_scatter_single")
    real = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def wrap(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec["ms"] += 1e3 * (time.perf_counter() - t0)
            rec["calls"] += 1
            return out
        return run
    for n, fn in real.items():
        setattr(dist, n, wrap(fn))
    try:
        yield rec
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def timed(fn):
    """(ms on the host clock, fn's result), the card idle before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def moe_unit(dev, mesh):
    """One repeat unit of qwen3-moe at full width (attention, then the
    routed MoE through `moe_apply`, the expert-parallel toggle off) on
    MOE_B x MOE_T seeded inputs, fp32. Returns (ms, y, aux, grads, experts
    computed with): on `mesh` the grads are DTensors in the params' layouts
    and a rank computes with E/M experts; with None, the single rank's full
    grads."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe
    from repro_torch.models import transformer as TR
    from repro_torch.utils import tree_leaves, tree_map

    moe.set_expert_parallel(False)
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=1, compute_dtype="float32",
                              param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(24)
    params = {"blocks": TR._stack_units(
        lambda: TR._init_dense_unit(gen, cfg, torch.float32, with_moe=True), 1)}
    x = torch.randn(MOE_B, MOE_T, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(25))
    pos = torch.arange(MOE_T, dtype=torch.int32, device=dev).expand(MOE_B, MOE_T)

    def unit(p):
        u = SH.materialize(TR._index(p["blocks"], 0, False), ("blocks",), 0)
        experts = u["sub0"]["moe"]["up"].shape[0]
        return (*TR._apply_unit_full(cfg, u, x, pos), experts)

    if mesh is None:
        p = tree_map(lambda t: t.requires_grad_(True), params)

        def run():
            y, aux, n = unit(p)
            return y, aux, torch.autograd.grad(y.sum() + aux, tree_leaves(p)), n
        ms, (y, aux, g, n) = timed(run)
        return ms, y.detach(), aux.detach(), list(g), n
    pd = from_local(params, SH.param_shardings(params, cfg, mesh), mesh)
    del params
    local, specs = SH.local_params(pd, mesh)
    p = tree_map(lambda t: t.detach().requires_grad_(True), local)

    def run():
        with SH.data_parallel(mesh, ("data",)), SH.param_scope(mesh, specs, cfg):
            y, aux, n = unit(p)
            g = iter(torch.autograd.grad((y.sum() + aux) / mesh.size(), tree_leaves(p)))
        return y, aux, SH.reduce_grads(tree_map(lambda _: next(g), p), pd, mesh), n
    ms, (y, aux, g, n) = timed(run)
    return ms, y.detach(), aux.detach(), tree_leaves(g), n


def split_main(rank, world, store):
    """`--split` on one rank: the step's collectives probed, then each case
    on the (1, world) mesh against the single rank's run on the same card.
    Returns 0 when every case held."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.counters import COLLECTIVES, Counter
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SPLIT_PG_TIMEOUT_S))
    try:
        found = {}
        for name in STEP_PROBES:
            try:
                run_probe(name, dev)
                found[name] = None
            except Exception as e:    # noqa: BLE001 — the finding is the error
                found[name] = f"{type(e).__name__}: {e}"[:400]
        if rank == 0:
            print(json.dumps({"probe": "gloo on CUDA tensors, one card, in the ranks",
                              "world": world, "refused": {k: v for k, v in found.items() if v},
                              "taken": [k for k, v in found.items() if v is None],
                              "torch": torch.__version__}), flush=True)
        if any(found.values()):
            return 3
        mesh = make_local_mesh(dev, shape=(1, world))
        held = []
        for arch in SPLIT_ARCHS:
            with torch.no_grad():
                zero_counts()
                first = serve_steps(dev, arch, mesh)[2]      # warm-up: first calls, not held
                uncounted = read_counts()[0]
                torch.cuda.empty_cache()
                counter = Counter() if arch == COUNTED_ARCH else None
                zero_counts()
                with collectives_timed() as coll:
                    got, nbytes, ms1 = serve_steps(dev, arch, mesh, counter)
                counts, plain = read_counts()
                launches = each_rank(counts + [plain], dev, mesh)
                # the counter changes no launch
                same = each_rank([counts == uncounted], dev, mesh)
                counted = None
                if counter:
                    res = counter.result()
                    keys = ["total"] + [f"{p}{k}" for p in ("", "n_") for k in COLLECTIVES]
                    rows = each_rank([res["flops"]] + [res["collectives"][k] for k in keys],
                                     dev, mesh)
                    counted = [{"flops": r[0], "collectives": dict(zip(keys, r[1:]))}
                               for r in rows]
                kinds = sorted(nbytes)
                sizes = each_rank([nbytes[k] for k in kinds], dev, mesh)
                torch.cuda.empty_cache()
                if rank == 0:
                    want, single, ms0 = serve_steps(dev, arch, None)
                    floats = [(a, b) for a, b in zip(got, want) if b.is_floating_point()]
                    ints_equal = all(torch.equal(a, b) for a, b in zip(got, want)
                                     if not b.is_floating_point())
                    n_out = 2 + 2 * SERVE_STEPS
                    errs = {"outputs": max(rel_err(a, b) for a, b in floats[:n_out]),
                            "state": max(rel_err(a, b) for a, b in floats[n_out:])}
                    no_plain = not any(r[-1] for r in launches)
                    same = all(r[0] for r in same)
                    ok = (len(got) == len(want) and ints_equal and no_plain and same
                          and all(e <= TOL for e in errs.values()))
                    held.append(ok)
                    print(json.dumps({
                        "two_ranks": "split_prefill_and_decode", "arch": arch,
                        "layers": SERVE_LAYERS, "batch": SERVE_B, "prompt": SERVE_T,
                        "steps": SERVE_STEPS, "mesh": [1, world], "max_abs_err": errs,
                        "positions_equal": ints_equal, "tol": TOL,
                        "state_bytes": {"each_rank": [dict(zip(kinds, r)) for r in sizes],
                                        "single_rank": single},
                        "launches": {"each_rank": [dict(zip(KERNELS, r)) for r in launches]},
                        "plain_versions_ran": not no_plain,
                        "launches_as_uncounted": same,
                        "counted_prefill": counted and {"each_rank": counted},
                        "ms": {"two_ranks": ms1, "two_ranks_first": first,
                               "two_ranks_collectives": coll["ms"], "one_rank": ms0},
                        "collective_calls": coll["calls"], "ok": ok}), flush=True)
                    del want
                del got
                torch.cuda.empty_cache()
            dist.barrier()

        # the single rank's unit, run on one rank at a time (the card is
        # shared); each rank keeps its blocks of the reference grads
        ref = None
        for r in range(world):
            if rank == r:
                ms0, y0, a0, g0, n0 = moe_unit(dev, None)
                ref = (ms0, y0, a0, g0, n0)
                del g0
                torch.cuda.empty_cache()
            dist.barrier()
        ms0, y0, a0, g0, n0 = ref
        del ref
        first = moe_unit(dev, mesh)[0]                    # warm-up: first calls, not held
        torch.cuda.empty_cache()
        zero_counts()
        with collectives_timed() as coll:
            ms1, y1, a1, g1, n1 = moe_unit(dev, mesh)
        counts, plain = read_counts()
        errs = [rel_err(y1, y0), abs(a1.item() - a0.item()),
                max(rel_err(a.to_local(), block(b, a.placements, mesh))
                    for a, b in zip(g1, g0))]
        del g0, g1
        launches = each_rank(counts + [plain], dev, mesh)
        errs_all = SH.all_gather(torch.tensor([errs], device=dev), 0, mesh, ("model",))
        experts = each_rank([n1], dev, mesh)
        if rank == 0:
            from repro_torch.configs import get_arch
            worst = errs_all.amax(0).tolist()
            errs = dict(zip(("y", "aux", "grads"), worst))
            no_plain = not any(r[-1] for r in launches)
            ok = no_plain and all(e <= TOL for e in worst)
            held.append(ok)
            e = get_arch(MOE_ARCH).moe
            per_expert = 3 * get_arch(MOE_ARCH).d_model * e.d_ff_expert
            print(json.dumps({
                "two_ranks": "split_moe_unit", "arch": MOE_ARCH, "layers": 1,
                "batch": MOE_B, "tokens": MOE_T, "mesh": [1, world], "moe_ep": False,
                "max_abs_err": errs, "tol": TOL,
                "experts_computed": {"each_rank": [r[0] for r in experts], "single_rank": n0},
                "expert_params": {"each_rank": [r[0] * per_expert for r in experts],
                                  "single_rank": n0 * per_expert},
                "launches": {"each_rank": [dict(zip(KERNELS, r)) for r in launches]},
                "plain_versions_ran": not no_plain,
                "ms": {"two_ranks": ms1, "two_ranks_first": first,
                       "two_ranks_collectives": coll["ms"], "one_rank": ms0},
                "collective_calls": coll["calls"], "ok": ok}), flush=True)
            print(json.dumps({"two_ranks": "split_done", "cases": list(SPLIT_CASES),
                              "held": held, "ok": len(held) == len(SPLIT_CASES)
                              and all(held)}), flush=True)
        return 0 if rank or (len(held) == len(SPLIT_CASES) and all(held)) else 1
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe-only", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="run only the RWKV6, Mamba and MoE-unit cases (4), the "
                         "collectives probed in the ranks; a refusal fails")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_two_ranks: needs a CUDA card", file=sys.stderr)
        return 2
    (ROOT / "build").mkdir(exist_ok=True)
    if args.split:
        from repro_torch.kernels import _build
        _build.library()              # built once, before the ranks load it
        return spawn(_split_entry, args.ranks)
    found = probe(args.ranks)
    print(json.dumps({"probe": "gloo on CUDA tensors, one card", "world": args.ranks,
                      "refused": {k: v for k, v in found.items() if v},
                      "taken": [k for k, v in found.items() if v is None],
                      "torch": torch.__version__}), flush=True)
    if args.probe_only or any(found[k] for k in STEP_PROBES):
        return 0
    return spawn(_entry, args.ranks)


def spawn(entry, world) -> int:
    """Run entry(rank, world, store, codes) in `world` spawned processes;
    the largest code any rank put (a rank that dies raises here)."""
    import torch.multiprocessing as mp
    store = os.path.join(tempfile.mkdtemp(dir=ROOT / "build"), "store")
    codes = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(entry, args=(world, store, codes), nprocs=world, join=True,
                       start_method="spawn")
    rc = 0
    while not codes.empty():
        rc = max(rc, codes.get())
    return rc


def _entry(rank, world, store, codes):
    codes.put(rank_main(rank, world, store))


def _split_entry(rank, world, store, codes):
    codes.put(split_main(rank, world, store))


if __name__ == "__main__":
    sys.exit(main())

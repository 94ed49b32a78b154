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

    python3 tools/mesh_two_ranks.py [--probe-only]

Prints one JSON line per rank-0 result; exits non-zero when a held result
disagrees. A collective that gloo refuses is a finding, not a failure: the
probe line says which and why, and step 2 is skipped (exit 0).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-4
T = 4096
SERVE_ARCHS = ("command-r-35b", "mistral-large-123b")
SERVE_LAYERS, SERVE_B, SERVE_T, SERVE_STEPS = 2, 4, 256, 4


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


def from_local(tree, specs, mesh):
    """DTensors laid out by `specs`, each rank cutting its own block of the
    full tensors it holds (no collective)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SH
    by_path = SH.spec_items(specs)

    def one(name, t):
        pl = SH.placements(by_path[name], mesh)
        for i, p in enumerate(pl):
            if p.is_shard():
                t = t.chunk(mesh.size(i), p.dim)[mesh.get_local_rank(mesh.mesh_dim_names[i])]
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False)
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


def serve_steps(dev, arch, mesh):
    """(outputs, KV cache bytes on this rank) of `arch`'s prefill and
    decode at full width, SERVE_LAYERS layers, fp32 compute: through the
    dry-run factory's fns on `mesh`, or the unsharded `prefill` and
    `decode_step` (None). outputs: the last position's logits and values,
    each step's, and every leaf of the final state, as full tensors."""
    import numpy as np
    import torch

    from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_dryrun_step
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_arch(arch), num_layers=SERVE_LAYERS, compute_dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(28), cfg)
    toks = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_T + SERVE_STEPS))).to(dev)
    steps = range(SERVE_T, SERVE_T + SERVE_STEPS)
    kv_bytes = lambda st: sum(t.numel() * t.element_size() for n, t in SH.leaves_with_path(st)
                              if SH.is_kv(SH.path_str(n), t.dim()))
    if mesh is None:
        lg, v, st = prefill(params, cfg, {"tokens": toks[:, :SERVE_T]})
        res = [lg[:, -1], v[:, -1]]
        del lg
        for i in steps:
            dl, dv, st = decode_step(params, cfg, toks[:, i:i + 1], st, uniform=True)
            res += [dl, dv]
        return res + [t for _, t in SH.leaves_with_path(st)], kv_bytes(st)
    INPUT_SHAPES["two_ranks_prefill"] = InputShape("two_ranks_prefill", SERVE_T, SERVE_B,
                                                   "prefill")
    INPUT_SHAPES["two_ranks_decode"] = InputShape("two_ranks_decode", SERVE_T + 64, SERVE_B,
                                                  "decode")
    pre = make_dryrun_step(cfg, "two_ranks_prefill", mesh)
    dec = make_dryrun_step(cfg, "two_ranks_decode", mesh)
    pd = from_local(params, pre["in_shardings"][0], mesh)
    del params
    lg, v, st = pre["fn"](pd, from_local({"tokens": toks[:, :SERVE_T]}, pre["in_shardings"][1],
                                         mesh))
    res = [lg, v]
    for i in steps:
        dl, dv, st = dec["fn"](pd, from_local(toks[:, i:i + 1], dec["in_shardings"][1], mesh), st)
        res += [dl, dv]
    local = kv_bytes(SH.map_with_path(lambda _, t: t.to_local(), st))
    return [full(t, mesh) for t in res] + [full(t, mesh) for _, t in SH.leaves_with_path(st)], \
        local


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
                got, nbytes = serve_steps(dev, arch, mesh)
                each = SH.all_gather(torch.tensor([nbytes], device=dev), 0, mesh, ("model",))
                torch.cuda.empty_cache()
                if rank == 0:
                    want, single = serve_steps(dev, arch, None)
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
                                                      "single_rank": single}}), flush=True)
                    del want
                del got
                torch.cuda.empty_cache()
            dist.barrier()
        return int(bad > 0)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe-only", action="store_true")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("mesh_two_ranks: needs a CUDA card", file=sys.stderr)
        return 2
    (ROOT / "build").mkdir(exist_ok=True)
    found = probe(args.ranks)
    print(json.dumps({"probe": "gloo on CUDA tensors, one card", "world": args.ranks,
                      "refused": {k: v for k, v in found.items() if v},
                      "taken": [k for k, v in found.items() if v is None],
                      "torch": torch.__version__}), flush=True)
    if args.probe_only or any(found[k] for k in STEP_PROBES):
        return 0
    store = os.path.join(tempfile.mkdtemp(dir=ROOT / "build"), "store")
    codes = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_entry, args=(args.ranks, store, codes),
                       nprocs=args.ranks, join=True, start_method="spawn")
    rc = 0
    while not codes.empty():
        rc = max(rc, codes.get())
    return rc


def _entry(rank, world, store, codes):
    codes.put(rank_main(rank, world, store))


if __name__ == "__main__":
    sys.exit(main())

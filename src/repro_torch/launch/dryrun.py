"""Multi-pod dry-run: for every (arch x input-shape x mesh), the real step
function's per-device memory and FLOPs on the production meshes, without a
device and without allocating a tensor of the model; counterpart of
`repro.launch.dryrun`.

`repro` lowers and compiles each step with XLA on 512 forced host devices
and reads XLA's memory and cost analyses. The port has no compiler to ask.
It builds the same step (`launch/steps.make_dryrun_step`) on meta tensors
and reads:
  - `memory.argument_size_in_bytes` / `output_size_in_bytes`: PER DEVICE,
    the sum over leaves of the shard shape's elements x itemsize under the
    step's in/out specs (`repro`'s `NamedSharding.shard_shape` sums);
  - `measured.global_flops`: `torch.utils.flop_counter.FlopCounterMode`
    over the step evaluated on meta tensors (`dispatch.abstract()`) at 1
    and 2 repeat units, extrapolated by `repro`'s `_measure_shallow`
    formula total = m(1) + (R_full - 1) * (m(2) - m(1)). This counts the
    whole (global) step's matmul and attention FLOPs. `repro`'s
    `measured.flops` is XLA's count for one device of the partitioned
    program, which the port cannot take: the record names it under
    `not_measured`, with XLA's temp bytes, bytes accessed and collective
    bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_dryrun_step
from repro_torch.models import moe as MOE

ASSIGNED = [
    "qwen3-8b", "mistral-large-123b", "command-r-35b", "pixtral-12b",
    "rwkv6-3b", "hubert-xlarge", "gemma2-2b", "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b", "hymba-1.5b",
]

DEFAULT_OUT = "experiments/dryrun_torch"

NOT_MEASURED = {
    "flops": "per device: no partitioned program to count (global_flops is the whole step's)",
    "temp_size_in_bytes": "no compiler: the eager step's temporaries are not planned ahead",
    "bytes_accessed": "no compiler cost analysis",
    "collective_bytes": "no compiled program to read collectives from",
}


def _outputs_bytes(built, mesh) -> int:
    """Per-device bytes of the step's outputs under its out specs."""
    return sum(SH.per_device_bytes(o, spec, mesh)
               for o, spec in zip(built["outs"], built["out_shardings"]))


def _arguments_bytes(built, mesh) -> int:
    return sum(SH.per_device_bytes(a, s, mesh)
               for a, s in zip(built["args"], built["in_shardings"]))


def count_flops(cfg, shape: str, mesh, **kw) -> float:
    """FLOPs of one evaluation of the step on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    built = make_dryrun_step(cfg, shape, mesh, **kw)
    counter = FlopCounterMode(display=False)
    with torch.device("meta"), dispatch.abstract(), counter:
        built["fn"](*built["args"])
    return float(counter.get_total_flops())


def units(cfg):
    """(repeat unit length, dense prefix, repeat units at full depth)."""
    u = len(cfg.layer_pattern)
    fkd = cfg.moe.first_k_dense if cfg.moe else 0
    return u, fkd, (cfg.num_layers - fkd) // u


def at_units(cfg, reps: int):
    u, fkd, _ = units(cfg)
    return dataclasses.replace(cfg, num_layers=fkd + u * reps)


def _measure_shallow(cfg, shape, mesh, **kw) -> dict:
    """FLOPs at 1 and 2 repeat units, extrapolated to full depth:
        total = m(1) + (R_full - 1) * (m(2) - m(1)).
    Exact for per-layer-homogeneous stacks (all assigned archs)."""
    r_full = units(cfg)[2]
    m1, m2 = (count_flops(at_units(cfg, reps), shape, mesh, **kw) for reps in (1, 2))
    return {"global_flops": m1 + (r_full - 1) * (m2 - m1),
            "per_unit_global_flops": m2 - m1, "units": r_full}


def run_one(arch: str, shape: str, *, multi_pod: bool = False, fsdp: bool = True,
            shard_cache_len: bool = False, remat: bool = True, measure: bool = True,
            moe_ep: bool = False, verbose: bool = True, cfg=None) -> dict:
    cfg = cfg or get_arch(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": SH.mesh_label(mesh),
           "chips": mesh.size, "fsdp": fsdp, "shard_cache_len": shard_cache_len,
           "remat": remat, "moe_ep": moe_ep,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    kw = dict(fsdp=fsdp, shard_cache_len=shard_cache_len, remat=remat, moe_ep=moe_ep)
    t0 = time.time()
    try:
        with torch.device("meta"):
            built = make_dryrun_step(cfg, shape, mesh, **kw)
        if built["kind"] == "skip":
            rec["status"] = "skip"
            rec["reason"] = "encoder-only arch: no decode step"
            return rec
        rec["kind"] = built["kind"]
        rec["memory"] = {"argument_size_in_bytes": _arguments_bytes(built, mesh),
                         "output_size_in_bytes": _outputs_bytes(built, mesh)}
        rec["not_measured"] = dict(NOT_MEASURED)
        rec["build_s"] = round(time.time() - t0, 2)
        if measure:
            rec["measured"] = _measure_shallow(cfg, shape, mesh, **kw)
        rec["status"] = "ok"
        if verbose:
            flops = rec.get("measured", {}).get("global_flops", -1)
            print(f"[dryrun] {arch} x {shape} x {rec['mesh']} ({rec['kind']}): OK "
                  f"args/dev={rec['memory']['argument_size_in_bytes'] / 2**30:.2f} GiB "
                  f"global flops={flops:.3e}", flush=True)
    except Exception as e:          # noqa: BLE001 — recorded, and fails main()
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape}: FAIL {rec['error'][:200]}", flush=True)
    finally:
        MOE.set_expert_parallel(False)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--shard-cache-len", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE (moe_apply_ep) in the step")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip the 1-and-2-unit FLOP count")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    os.makedirs(args.out, exist_ok=True)
    results = []
    for a in archs:
        for s in shapes:
            rec = run_one(a, s, multi_pod=args.multi_pod, fsdp=not args.no_fsdp,
                          shard_cache_len=args.shard_cache_len,
                          remat=not args.no_remat, measure=not args.no_measure,
                          moe_ep=args.moe_ep)
            results.append(rec)
            tag = f"{a}_{s}_{rec['mesh']}" + ("_scl" if args.shard_cache_len else "") \
                + ("_nofsdp" if args.no_fsdp else "") + ("_ep" if args.moe_ep else "")
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail / {len(results)} pairs")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Multi-pod dry-run: for every (arch x input-shape x mesh), the real step
function's per-device memory, FLOPs, bytes and collectives on the
production meshes, without a device and without allocating a tensor of the
model; counterpart of `repro.launch.dryrun`.

`repro` lowers and compiles each step with XLA on 512 forced host devices
and reads XLA's memory and cost analyses and the collectives of the
compiled HLO. The port has no compiler to ask. It builds the same step
(`launch/steps.make_dryrun_step`) on meta tensors and reads:
  - `memory.argument_size_in_bytes` / `output_size_in_bytes`: PER DEVICE,
    the sum over leaves of the shard shape's elements x itemsize under the
    step's in/out specs (`repro`'s `NamedSharding.shard_shape` sums);
  - `measured` (`repro`'s `_measure_shallow` keys): the sharded step run on
    rank 0 of a counting mesh of the production shape
    (`launch/mesh.make_counting_mesh`: a fake process group, so its
    collectives move nothing), its args the meta args laid out by the
    in-specs as DTensors, under the per-rank counter
    (`launch/counters.Counter`): per-device `flops` (matmuls as
    `FlopCounterMode` counts them, each kernel's work by `kernels/cost.py`),
    `bytes` (accessed), `collective_bytes` with `coll_breakdown` (operand
    bytes by kind) and `coll_counts`, and `temp_size_in_bytes` (the peak of
    storage allocated in the step, the largest of `temp_by_phase`, each
    phase's peak extrapolated on its own); `global_flops`, the same
    counter over the unsharded step. Each is counted at 1 and 2 repeat units and
    extrapolated by `repro`'s formula total = m(1) + (R_full - 1) *
    (m(2) - m(1)). They are rank 0's (`measured.rank`), which holds the
    largest chunk of an uneven shard.
`not_measured` names what has no counterpart, with the reason.

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
from repro_torch.launch.counters import COLLECTIVES, Counter
from repro_torch.launch.mesh import make_counting_mesh, make_production_mesh
from repro_torch.launch.steps import make_dryrun_step
from repro_torch.models import moe as MOE

ASSIGNED = [
    "qwen3-8b", "mistral-large-123b", "command-r-35b", "pixtral-12b",
    "rwkv6-3b", "hubert-xlarge", "gemma2-2b", "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b", "hymba-1.5b",
]

DEFAULT_OUT = "experiments/dryrun_torch"

NOT_MEASURED = {
    "memory.generated_code_size_in_bytes": "no compiler: the port runs eagerly and "
                                           "generates no program",
    "hlo_lines": "no compiler: there is no HLO text",
    "lower_s": "no compiler: nothing is lowered",
    "compile_s": "no compiler: nothing is compiled",
    "memory.temp_size_in_bytes": "read off the compiled full-depth program in repro; "
                                 "the port gives measured's 1-and-2-unit extrapolation",
    "cost": "read off the compiled full-depth program in repro; the port gives "
            "measured's 1-and-2-unit extrapolation",
    "collectives": "read off the compiled full-depth program in repro; the port gives "
                   "measured's 1-and-2-unit extrapolation",
}


def _outputs_bytes(built, mesh) -> int:
    """Per-device bytes of the step's outputs under its out specs."""
    return sum(SH.per_device_bytes(o, spec, mesh)
               for o, spec in zip(built["outs"], built["out_shardings"]))


def _arguments_bytes(built, mesh) -> int:
    return sum(SH.per_device_bytes(a, s, mesh)
               for a, s in zip(built["args"], built["in_shardings"]))


def count(cfg, shape: str, mesh, **kw) -> dict:
    """The counter's result (`Counter.result`, and its `live` bytes) for
    one evaluation of the step on meta tensors: on an `AbstractMesh` the
    whole (unsharded) step, on a DeviceMesh (a counting mesh) this rank's
    share of the sharded one."""
    with torch.device("meta"):
        built = make_dryrun_step(cfg, shape, mesh, **kw)
        args = built["args"]
        if not isinstance(mesh, SH.AbstractMesh):
            args = tuple(SH.distribute(a, s, mesh)
                         for a, s in zip(args, built["in_shardings"]))
    with torch.device("meta"), dispatch.abstract(), Counter() as counter:
        built["fn"](*args)
    return {**counter.result(), "live": counter.live}


def units(cfg):
    """(repeat unit length, dense prefix, repeat units at full depth)."""
    u = len(cfg.layer_pattern)
    fkd = cfg.moe.first_k_dense if cfg.moe else 0
    return u, fkd, (cfg.num_layers - fkd) // u


def at_units(cfg, reps: int):
    u, fkd, _ = units(cfg)
    return dataclasses.replace(cfg, num_layers=fkd + u * reps)


def _measure_shallow(cfg, shape, mesh_shape, **kw) -> dict:
    """Rank 0's counts on a counting mesh of `mesh_shape`, and the
    unsharded step's FLOPs, at 1 and 2 repeat units, extrapolated to full
    depth: total = m(1) + (R_full - 1) * (m(2) - m(1)). Exact for the
    additive counts of per-layer-homogeneous stacks (all assigned archs).

    The peak of temporaries is extrapolated phase by phase (a train step's
    forward and backward, then its update) and the largest taken, since
    the phase that holds the step's peak can change with depth. It is
    extrapolated from 2 and 3 units (counted directly at R_full <= 2): at
    one unit the first unit is also the last, and the peak may sit where
    it sits at no other depth (hubert-xlarge's train step on (16, 16):
    0.67 GB under the line through 2, 3 and more units). A phase that runs the same
    allocations at each depth (the update, leaf by leaf) is extrapolated
    point by point, exact although which leaf's transients top it changes
    with depth; one whose allocations grow with the units (the forward and
    backward) has its peak extrapolated, exact while the peak keeps its
    place in the repeat structure. `tests/test_torch_dryrun_counts.py`
    holds every key against direct counts at 4 units;
    `tools/dryrun_direct_count.py` against the full-depth step."""
    r_full = units(cfg)[2]
    reps = (1, 2, 3) if r_full > 2 else (1, 2)
    with make_counting_mesh(mesh_shape) as mesh:
        m = [count(at_units(cfg, r), shape, mesh, **kw) for r in reps]
        axes = mesh.mesh_dim_names
    g = [count(at_units(cfg, r), shape, SH.AbstractMesh(mesh_shape, axes), **kw)
         for r in (1, 2)]

    def extrap(pair, get):
        a, b = get(pair[0]), get(pair[1])
        return a + (r_full - 1) * (b - a)

    def by_op(pair):
        ops = sorted(set(pair[0]["flops_by_op"]) | set(pair[1]["flops_by_op"]))
        return {o: extrap(pair, lambda r: r["flops_by_op"].get(o, 0)) for o in ops}

    coll = lambda k: (lambda r: r["collectives"][k])
    # peaks: from the two deepest counts, k units past the deeper one
    lo, hi, k = m[-2], m[-1], r_full - reps[-1]

    def phase_peak(p):
        a, b = lo["live"][p], hi["live"][p]
        if len(a) != len(b):
            return hi["temp_by_phase"][p] + k * (hi["temp_by_phase"][p] - lo["temp_by_phase"][p])
        # the same allocations at each depth (the update's, leaf by leaf):
        # the bytes alive at each extrapolate, and the peak is their largest
        return max(y + k * (y - x) for x, y in zip(a, b))

    temp_by_phase = {p: phase_peak(p) for p in hi["live"]}
    m = m[:2]
    return {
        "rank": 0,
        "flops": extrap(m, lambda r: r["flops"]),
        "bytes": extrap(m, lambda r: r["bytes"]),
        "collective_bytes": extrap(m, coll("total")),
        "per_unit_flops": m[1]["flops"] - m[0]["flops"],
        "per_unit_coll": m[1]["collectives"]["total"] - m[0]["collectives"]["total"],
        "units": r_full,
        "coll_breakdown": {k: extrap(m, coll(k)) for k in COLLECTIVES},
        "coll_counts": {f"n_{k}": extrap(m, coll(f"n_{k}")) for k in COLLECTIVES},
        "temp_size_in_bytes": max(temp_by_phase.values()),
        "temp_by_phase": temp_by_phase,
        "flops_by_op": by_op(m),
        "global_flops": extrap(g, lambda r: r["flops"]),
        "per_unit_global_flops": g[1]["flops"] - g[0]["flops"],
        "global_flops_by_op": by_op(g),
    }


def run_one(arch: str, shape: str, *, multi_pod: bool = False, fsdp: bool = True,
            shard_cache_len: bool = False, remat: bool = True, measure: bool = True,
            moe_ep: bool = False, verbose: bool = True, cfg=None, mesh_shape=None) -> dict:
    """One (arch, shape) record. `cfg` replaces the arch's config (a depth
    cut, other dtypes) and `mesh_shape` the production mesh's shape."""
    cfg = cfg or get_arch(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if mesh_shape is not None:
        mesh = SH.AbstractMesh(mesh_shape, mesh.axis_names[-len(mesh_shape):])
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
            rec["measured"] = _measure_shallow(cfg, shape, tuple(mesh.shape.values()), **kw)
        rec["status"] = "ok"
        if verbose:
            ms = rec.get("measured", {})
            print(f"[dryrun] {arch} x {shape} x {rec['mesh']} ({rec['kind']}): OK "
                  f"args/dev={rec['memory']['argument_size_in_bytes'] / 2**30:.2f} GiB "
                  f"flops/dev={ms.get('flops', -1):.3e} "
                  f"coll/dev={ms.get('collective_bytes', -1):.3e}B "
                  f"global flops={ms.get('global_flops', -1):.3e} "
                  f"({time.time() - t0:.1f} s)", flush=True)
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
                    help="skip the 1-and-2-unit counts")
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

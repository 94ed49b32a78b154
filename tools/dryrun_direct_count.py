"""The dry-run's extrapolated per-device counts beside a direct count of the
full-depth step: rank 0 of a counting mesh of the production shape runs
every layer under the counter (`launch/dryrun.count`), and each measured
key is set beside `launch/dryrun._measure_shallow`'s 1-and-2-unit
extrapolation. Meta tensors and a fake process group: CPU only, no card.
A full-depth count costs about as many seconds as the layers the arch has
(the ssm archs' loops over time make theirs far longer).

Usage:
  PYTHONPATH=src python tools/dryrun_direct_count.py --arch qwen3-8b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_counting_mesh

KEYS = ("flops", "bytes", "temp_size_in_bytes")
MESH = (16, 16)                  # the production mesh


def compare(arch: str, shape: str) -> dict:
    cfg = get_arch(arch)
    if SP.input_specs(cfg, shape)[0] == "skip":
        return {"arch": arch, "shape": shape, "status": "skip"}
    t0 = time.time()
    ext = dryrun._measure_shallow(cfg, shape, MESH)
    t1 = time.time()
    with make_counting_mesh(MESH) as mesh:
        direct = dryrun.count(cfg, shape, mesh)
    t2 = time.time()
    got = {k: direct[k] for k in KEYS}
    got["temp_by_phase"] = direct["temp_by_phase"]
    got["collectives"] = direct["collectives"]
    want = {k: ext[k] for k in KEYS}
    want["temp_by_phase"] = ext["temp_by_phase"]
    want["collectives"] = {"total": ext["collective_bytes"], **ext["coll_breakdown"],
                           **ext["coll_counts"]}
    rel = {k: (want[k] - got[k]) / got[k] if got[k] else float(want[k] != 0) for k in KEYS}
    return {"arch": arch, "shape": shape, "mesh": list(MESH), "layers": cfg.num_layers,
            "direct": got, "extrapolated": want, "rel_err": rel,
            "collectives_equal": got["collectives"] == want["collectives"],
            "extrapolate_s": t1 - t0, "direct_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    for arch in args.arch:
        print(json.dumps(compare(arch, args.shape)), flush=True)


if __name__ == "__main__":
    main()

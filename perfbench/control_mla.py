#!/usr/bin/env python3
"""Readings that set the limits of a `learn_mla` cell's correctness check,
on the chip at the cell's own size, as `control.py` reads a `learn` cell's:

    python3 perfbench/control_mla.py --workload <cell> --seeds 11,12,13 [--control] [--faults]

For each seed, the port's readings against the plain reference (the lower
readings of the limits, what every run compares), with `--control` the
reference itself computed with fp8 products in the port's place (the next
precision below the configuration's bf16; the upper readings), and with
`--faults` the port fed half of each unroll (a state left unchanged reads
1 on `change` by definition, with no run). Each reading names the leaf
that gives its `grad1` and `change`. One JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import ROOT  # noqa: E402
from perfbench import harness as H  # noqa: E402
from perfbench.reference.learn import _gap  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _free():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reading(port, ref) -> dict:
    """`learn.compare`'s numbers, and the leaves that give grad1 and change."""
    from perfbench.reference import learn as RL
    out = RL.compare(port, ref)
    med_g = float(np.median(list(ref["grad1"].values())))
    med_raw = float(np.median(list(ref["grad1_raw"].values())))
    moving = [k for k, g in ref["grad1_raw"].items() if g >= 1e-3 * med_raw]
    med_c = float(np.median([ref["change"][k] for k in moving]))
    out["grad1_leaf"] = max(ref["grad1"], key=lambda k: _gap(port["grad1"][k], ref["grad1"][k],
                                                             med_g))
    out["change_leaf"] = max(moving, key=lambda k: _gap(port["change"][k], ref["change"][k],
                                                        med_c))
    return out


def seed_readings(cell, control, faults):
    from perfbench.cells import learn_mla as C
    from repro_torch import learners
    prep = C.Prepared(cell)
    port = C.first_steps(cell, prep)
    ref_batches = prep.ref_batches
    del prep
    _free()
    ref = C.reference(cell, ref_batches)
    out = {"port": reading(port, ref)}
    if faults:
        build = learners.build_seq_train_step

        def halved(*a, **kw):
            step = build(*a, **kw)

            def train_step(params, state, batch):
                T = batch["tokens"].shape[1]
                return step(params, state, {k: (v[:, :T // 2] if v.dim() == 2 else v)
                                            for k, v in batch.items()})
            return train_step
        learners.build_seq_train_step = halved
        try:
            prep = C.Prepared(cell)
            bad = C.first_steps(cell, prep)
        finally:
            learners.build_seq_train_step = build
        del prep
        _free()
        out["half_unroll"] = reading(bad, ref)
    if control:
        out["control_fp8"] = reading(C.reference(cell, ref_batches, lowp=True), ref)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    manifest = H.load_json(ROOT / "BENCHMARK.json")
    for seed in map(int, args.seeds.split(",")):
        cell = H.find_cell(manifest, args.workload, seed, 0.0, False)
        cell.device = torch.device("cuda" if torch.cuda.is_available() else "cpu", 0)
        cell.arch = H.program_config(cell.cfg)
        t0 = cell.t_start = time.perf_counter()
        out = seed_readings(cell, args.control, args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Readings that set the limits of a cell's correctness check, on the chip
at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--control] [--faults]

For each seed, the port's readings against the plain reference (what every
run of the benchmark compares; the lower readings of the limits), then with
`--control` the reference itself computed with fp8 products in the port's
place (the next precision below the configuration's bf16; the upper
readings), and with `--faults` the faults a cell of its kind can have,
planted in the port: for a learner, half of each batch left out (a state
left unchanged reads 1 on `change` by definition, with no run); for a
server, the served actions altered where they are produced (each flush's
actions off by one) and one slot of each actor answered from another
slot's observation; a server's readings also give `rows_off` at several
row gaps. One JSON line per seed and reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import ROOT  # noqa: E402
from perfbench import harness as H  # noqa: E402

import torch  # noqa: E402


# gaps at which `rows_off` is also read, to place `reference.serve.ROW_GAP`
SERVE_ROW_GAPS = (0.05, 0.075, 0.1, 0.15, 0.2, 0.3)


def _free():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def learn_seed(cell, control, faults):
    from perfbench.cells import learn as C
    from repro_torch import learners
    prep = C.Prepared(cell)
    port = C.first_steps(cell, prep)
    ref_batches = prep.ref_batches
    del prep
    _free()
    out = {}
    ref = C.reference(cell, ref_batches)
    out["port"] = C.RL.compare(port, ref)
    if faults:
        build = learners.build_seq_train_step

        def halved(*a, **kw):
            step = build(*a, **kw)

            def train_step(params, state, batch):
                B, T = batch["tokens"].shape
                cut = ({k: v[:B // 2] for k, v in batch.items()} if B > 1 else
                       {k: (v[:, :T // 2] if v.dim() == 2 else v) for k, v in batch.items()})
                return step(params, state, cut)
            return train_step
        learners.build_seq_train_step = halved
        try:
            prep = C.Prepared(cell)
            bad = C.first_steps(cell, prep)
        finally:
            learners.build_seq_train_step = build
        del prep
        _free()
        out["half_batch"] = C.RL.compare(bad, ref)
    if control:
        out["control_fp8"] = C.RL.compare(C.reference(cell, ref_batches, lowp=True), ref)
    return out


def stale_rows(every):
    """A fault of `InfServer._forward`: every `every`-th row of a flush
    (one slot of each actor where `every` is its slots) computed on the
    next row's observation, as a slot fed a stale or another slot's
    observation would be."""
    def fault(forward, self, params, obs, grouped=False):
        obs = obs.copy()
        obs[0::every] = obs[1::every]
        return forward(self, params, obs, grouped)
    return fault


def altered_actions(num_actions):
    """A fault of `InfServer._forward`: each served action off by one."""
    def fault(forward, self, params, obs, grouped=False):
        a, logp, v = forward(self, params, obs, grouped)
        return (a + 1) % num_actions, logp, v
    return fault


def serve_seed(cell, control, faults):
    from perfbench.cells import serve as C
    from repro_torch.infserver import server as S
    tr = cell.traffic
    rows = tr["actors"] * tr["slots"]

    def served(fault=None):
        forward = S.InfServer._forward
        if fault:
            S.InfServer._forward = lambda self, *a, **kw: fault(forward, self, *a, **kw)
        try:
            params = C.W.program_tree(cell.cfg, C.W.make(cell.cfg, cell.seed, cell.device))
            server = S.InfServer(cell.arch, tr["num_actions"], params, device=cell.device,
                                 max_batch=tr["max_batch"],
                                 seed=C.W.derive(cell.seed, "server"))
            del params
            pool = C.observations(cell)
            res = [C.serve_round(server, pool[i])[1] for i in range(tr["check_rounds"])]
            del server
        finally:
            S.InfServer._forward = forward
        _free()
        return pool, res

    def reading(res):
        out = C.RS.compare(res, ref)
        lp, v = C.RS.gaps(res, ref)
        out["rows_off_at"] = {t: C.RS.rows_off(lp, v, t) for t in SERVE_ROW_GAPS}
        return out

    pool, res = served()
    flushes = [pool[i].reshape(rows, -1) for i in range(tr["check_rounds"])]
    ref = C.RS.readings(cell.cfg, cell.seed, flushes, tr["num_actions"], cell.device)
    out = {"port": reading(res)}
    if faults:
        out["altered_actions"] = reading(served(altered_actions(tr["num_actions"]))[1])
        out["stale_slot"] = reading(served(stale_rows(tr["slots"]))[1])
    if control:
        lo = C.RS.readings(cell.cfg, cell.seed, flushes, tr["num_actions"], cell.device,
                           lowp=True)
        picks = [(a, lp.gather(-1, torch.as_tensor(a, device=lp.device).long()[:, None])[:, 0]
                  .cpu().numpy(), v.cpu().numpy())
                 for (a, _, _), (lp, v) in zip(res, lo)]
        out["control_fp8"] = reading(picks)
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
        fn = learn_seed if cell.traffic["kind"] == "learn" else serve_seed
        out = fn(cell, args.control, args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                          **out}), flush=True)


if __name__ == "__main__":
    main()

"""One run of one cell: `python3 perfbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`.

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration's file (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose `kind` names the general runner in
`cells/`), the limits of its correctness check (`limits/<cell>.json`) and,
with `--trace 1`, one reader per per-layer metric (`metrics/<metric>.py`,
whose `read(summary)` returns a number or None).

The run's last line on standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` and, traced, `breakdown`, then
`checks`, each compared number beside its limit; the same numbers are the
last lines on standard error. The run fails, and prints no result, where
there is no CUDA device (or fewer than the cell asks for), where the port
or the manifest is missing, and where `jax`, `jaxlib`, `flax` or `repro`
(by whole top-level module name) is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result."""


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict            # the configuration's file
    traffic: dict        # the traffic mix's file
    limits: dict         # {number: limit} of the correctness check
    seed: int
    seconds: float
    trace: bool
    device: object = None
    arch: object = None  # the port's ArchConfig, built from `cfg`
    t_start: float = 0.0  # the process's start on the host clock


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict        # end-to-end values by name (untraced)
    checks: dict         # {number: value} for the correctness check
    memory_peak: int
    summary: dict = None  # traced: what the per-layer readers read


def phase(cell, name: str) -> None:
    """Note on standard error how far set-up has come, on the host clock."""
    print(f"setup {name} {time.perf_counter() - cell.t_start:.3f} s", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


ARCH_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
             "d_ff", "vocab_size", "qk_norm", "attn_bias", "rope_theta", "attn_logit_softcap",
             "final_logit_softcap", "sliding_window", "post_block_norms", "norm", "activation",
             "mlp_gated", "tie_embeddings", "embed_scale", "param_dtype", "compute_dtype",
             "value_head_hidden")
PLAIN = {"attn_bias": False, "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0,
         "sliding_window": 0, "post_block_norms": False, "norm": "rmsnorm",
         "activation": "silu", "mlp_gated": True, "tie_embeddings": False,
         "embed_scale": False}


def program_config(cfg: dict):
    """The port's ArchConfig for a configuration file: its registered arch
    with every size of the file, each held equal afterwards. The plain
    reference covers pre-norm RMSNorm blocks with SiLU-gated MLPs or MoEs
    and untied heads: a file that asks for more is refused."""
    from repro_torch.configs import MoEConfig, get_arch
    for k, v in PLAIN.items():
        if cfg.get(k, v) != v:
            raise Refused(f"{cfg['name']}: the reference has no {k}={cfg[k]!r}")
    fields = {k: cfg[k] for k in ARCH_KEYS if k in cfg}
    fields["moe"] = MoEConfig(**cfg["moe"]) if cfg.get("moe") else None
    arch = dataclasses.replace(get_arch(cfg["arch"]), **fields)
    for k, v in fields.items():
        got = getattr(arch, k)
        if (dataclasses.asdict(got) if k == "moe" and got else got) != (
                cfg.get("moe") if k == "moe" else v):
            raise Refused(f"{cfg['name']}: the port's {k} is {got!r}, the file's {v!r}")
    return arch


def find_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(name=name, cfg=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                seed=seed, seconds=seconds, trace=trace)


def metrics_of(manifest: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or traced its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if cell in m.get("workloads", [cell])]


def read_metric(name: str, summary: dict):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(summary)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cell(cell: Cell) -> Outcome:
    kind = cell.traffic["kind"]
    if not (HERE / "cells" / f"{kind}.py").is_file():
        raise Refused(f"no runner for traffic kind {kind!r}")
    return importlib.import_module(f"perfbench.cells.{kind}").run(cell)


def verdict(cell: Cell, out: Outcome):
    """(correct, [(number, value, limit)]): every number at or under its
    limit (a NaN is over), and every attempt answered, none failed."""
    rows = [(k, out.checks.get(k, float("nan")), lim) for k, lim in cell.limits.items()]
    ok = all(v <= lim for _, v, lim in rows) and out.attempted > 0 and out.failed == 0
    return ok, rows


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        manifest = load_json(ROOT / "BENCHMARK.json")
        cell = find_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace))
        chips = next(w for w in manifest["workloads"] if w["name"] == cell.name)["chips"]
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA device(s); "
                          f"{torch.cuda.device_count()} available")
        cell.device = torch.device("cuda", 0)
        cell.arch = program_config(cell.cfg)
        cell.t_start = t_start
        out = run_cell(cell)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    ok, rows = verdict(cell, out)
    wanted = metrics_of(manifest, cell.name, cell.trace)
    metrics = {}
    for m in wanted:
        v = read_metric(m["name"], out.summary) if cell.trace else out.metrics.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out.memory_peak, "name_power_limit": power_limit()}
    result = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if cell.trace:
        s = out.summary
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

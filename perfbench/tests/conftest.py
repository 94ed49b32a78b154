"""Shared set-up of the benchmark's tests: the checkout's root and `src/`
on the path, and tiny versions of the benchmark's cells for the CPU.

Run them from the root of a checkout: `python -m pytest -q perfbench/tests`
(the card's: `python -m pytest -q -m cuda perfbench/tests`)."""
import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import perfbench  # noqa: E402,F401  (puts the port's src/ on the path)

TINY = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
            num_layers=2)
TINY_TRAFFIC = {"learn": dict(batch=2, unroll=48, pool=4),
                "serve": dict(actors=4, slots=4, max_batch=16, pool_rounds=4)}


@pytest.fixture(scope="session")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(manifest, workload, seed=5, dtype="float32", seconds=0.5, trace=False):
    """A cell of the manifest at a tiny width on the CPU, with its own
    limits and traffic kind."""
    import torch
    from perfbench import harness as H
    cell = H.find_cell(manifest, workload, seed, seconds, trace)
    cfg = dict(cell.cfg, param_dtype=dtype, compute_dtype=dtype, **TINY)
    if cfg.get("moe"):
        cfg["moe"] = dict(cfg["moe"], num_experts=8, experts_per_token=2, d_ff_expert=32)
    cell = dataclasses.replace(cell, cfg=cfg, device=torch.device("cpu"),
                               traffic=dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["kind"]]),
                               t_start=time.perf_counter())
    cell.arch = H.program_config(cfg)
    return cell

"""On the card: the port's own phases measure the same work as the
benchmark's outside wrappers, on one traced run of each cell.

- serve: `moe_route_ms.serve` + `moe_gemm_ms.serve` within 5 % of
  `moe_ms.serve` (the kernels inside the span around `moe_apply`);
- learn: `grad_norm_ms.learn` + `adamw_ms.learn` within 5 % of
  `optim_update_ms.learn` (an event at `cost.phase("update")` to the step's
  end), and the four learner phases within 5 % of the traced step time
  (`window_s` over the traced steps).

Each run's result line is printed (`-s` shows it)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["learn.mistral-large-l2.b4-t2048", "serve.qwen3-moe-l8.a32x8-o26",
         "learn.mistral-large-l2.b1-t8192"]
SEED = 3000000023


def _near(got, want, share=0.05):
    return abs(got - want) <= share * want


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_programs_phases_add_up_to_the_outside_wrappers(manifest, workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(SEED), "--seconds", "20", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"\n{workload} {json.dumps(res)}")
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    w = next(x for x in manifest["workloads"] if x["name"] == workload)
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["kind"] == "serve":
        route_gemm = m["moe_route_ms.serve"] + m["moe_gemm_ms.serve"]
        print(f"sums {workload} moe_route+moe_gemm {route_gemm!r} moe_ms {m['moe_ms.serve']!r}")
        assert _near(route_gemm, m["moe_ms.serve"])
    else:
        step_ms = 1e3 * res["device"]["window_s"] / traffic["trace_steps"]
        opt = m["grad_norm_ms.learn"] + m["adamw_ms.learn"]
        phases = opt + m["learn_fwd_ms.learn"] + m["learn_bwd_ms.learn"]
        print(f"sums {workload} norm+adamw {opt!r} optim_update {m['optim_update_ms.learn']!r}"
              f" phases {phases!r} step {step_ms!r}")
        assert _near(opt, m["optim_update_ms.learn"])
        assert _near(phases, step_ms)

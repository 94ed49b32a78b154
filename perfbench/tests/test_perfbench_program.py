"""The readers of the port's own spans and counters (`program.py`): they
give nothing where nothing was recorded, and a number for every metric of
a cell from a tiny traced run of it on the CPU (where a phase is timed on
the host clock)."""
import json

import pytest

from conftest import ROOT, tiny_cell
from perfbench import harness as H

READERS = ["learn_fwd_ms.learn", "learn_bwd_ms.learn", "grad_norm_ms.learn", "adamw_ms.learn",
           "head_ms.serve", "moe_route_ms.serve", "moe_gemm_ms.serve",
           "infserver_host_ms.serve", "infserver_queue_ms.serve"]


def _program_metrics(manifest, workload):
    return [m["name"] for m in H.metrics_of(manifest, workload, True)
            if m["source"] in ("program_span", "program_counter") and m["name"] in READERS]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    from repro_torch.utils import trace
    trace.profiled.clear()
    empty = {"kind": "other", "units": 0, "window_s": 0.0, "busy_s": 0.0, "spans": {},
             "flushes": 0}
    assert H.read_metric(name, empty) is None
    for kind in ("learn", "serve"):
        assert H.read_metric(name, dict(empty, kind=kind)) is None


def test_every_reader_is_in_the_manifest_with_its_cells(manifest):
    named = {w: _program_metrics(manifest, w) for w in (x["name"] for x in manifest["workloads"])}
    assert sorted({n for v in named.values() for n in v}) == sorted(READERS)
    for w, names in named.items():
        kind = json.loads((ROOT / "perfbench" / "traffic" /
                           f"{next(x for x in manifest['workloads'] if x['name'] == w)['traffic']}"
                           ".json").read_text())["kind"]
        assert names and all(n.endswith("." + kind) for n in names)


@pytest.mark.parametrize("workload", ["learn.mistral-large-l2.b4-t2048",
                                      "learn.mistral-large-l2.b1-t8192",
                                      "serve.qwen3-moe-l8.a32x8-o26"])
def test_a_traced_run_gives_every_reader_of_its_cell_a_number(manifest, workload):
    from repro_torch.utils import trace
    trace.profiled.clear()
    cell = tiny_cell(manifest, workload, trace=True)
    out = H.run_cell(cell)
    got = {n: H.read_metric(n, out.summary) for n in _program_metrics(manifest, workload)}
    assert got and all(v is not None and v >= 0 for v in got.values()), got
    rec = trace.profiled
    if cell.traffic["kind"] == "learn":
        steps = cell.traffic["trace_steps"]
        for name in ("learner.forward", "learner.backward", "optim.norm", "optim.update"):
            assert len(rec.phase_ms(name)) == steps, name
    else:
        assert len(rec.host_s["infserver.flush"]) == out.summary["flushes"] == \
            cell.traffic["trace_rounds"]
        assert len(rec.queue_waits_s) == cell.traffic["trace_rounds"] * cell.traffic["actors"]
        assert len(rec.phase_ms("moe.experts")) == out.summary["flushes"] * cell.cfg["num_layers"]
    trace.profiled.clear()


def test_the_idle_split_gives_each_flush_step_its_share_of_the_window(manifest, monkeypatch):
    from perfbench import idle_split
    from perfbench import trace as TR
    kept = []
    summarize = TR.summarize
    monkeypatch.setattr(TR, "summarize", lambda ev: kept.append(list(ev)) or summarize(ev))
    cell = tiny_cell(manifest, "serve.qwen3-moe-l8.a32x8-o26", trace=True)
    H.run_cell(cell)
    out = idle_split.split(kept[-1])
    assert out["flushes"] == cell.traffic["trace_rounds"]
    per_flush = out["per_flush_ms"]
    # no device on the CPU: the whole window is one idle gap, split whole
    assert sum(per_flush.values()) * out["flushes"] == pytest.approx(out["idle_ms"])
    assert out["idle_ms"] == pytest.approx(out["window_ms"])
    steps = {"repro_torch.infserver." + s for s in ("pad", "h2d", "forward", "d2h", "scatter")}
    assert steps <= set(per_flush) and all(per_flush[s] > 0 for s in steps)
    assert all(v >= 0 for v in per_flush.values())

"""On the card: the control (the reference with fp8 products in the port's
place) and the planted faults fail the cell's committed limits, and the
port passes them, at the published widths with the depth and the batch a
test run can hold. The full-size readings that set the limits come from
`perfbench/control.py` (see `PERF.md`)."""
import dataclasses

import pytest

from perfbench import harness as H

CELLS = {"learn.mistral-large-l2.b4-t2048": (dict(num_layers=1), dict(batch=2, unroll=1024)),
         "learn.mistral-large-l2.b1-t8192": (dict(num_layers=1), dict(batch=1, unroll=4096)),
         "serve.qwen3-moe-l8.a32x8-o26": (dict(num_layers=2), dict(check_rounds=2))}


def _over(cell, reading):
    return any(reading[k] > lim for k, lim in cell.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_and_the_faults_fail_and_the_port_passes(manifest, workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import control
    cut, traffic = CELLS[workload]
    cell = H.find_cell(manifest, workload, 3000000019, 0.0, False)
    cfg = dict(cell.cfg, **cut)
    cell = dataclasses.replace(cell, cfg=cfg, traffic=dict(cell.traffic, **traffic),
                               device=torch.device("cuda", 0), arch=H.program_config(cfg))
    fn = control.learn_seed if cell.traffic["kind"] == "learn" else control.serve_seed
    out = fn(cell, control=True, faults=True)
    assert not _over(cell, out.pop("port")), "the port fails its own limits"
    for name, reading in out.items():
        assert _over(cell, reading), f"{name} passes every limit: {reading}"

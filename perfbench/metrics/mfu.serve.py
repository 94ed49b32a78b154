"""The forward the traced flushes need (`work.serve_flush_flops`:
attention and the active experts at every position, the action columns and
the value head at the last) over the traced window and the bf16 peak, in
%."""
from perfbench import work


def read(s):
    if not s or s.get("kind") != "serve" or not s["flushes"] or s["window_s"] <= 0:
        return None
    return 100.0 * s["required_flops_per_flush"] * s["flushes"] / s["window_s"] / work.PEAK_FLOPS

"""Device ms a train step of the MoE outside its expert products: the
sigmoid routing and the scatter into the held experts' buffers, then the
combine, the shared expert and the balance term (the port's phases
`moe.route` and `moe.combine`, every MoE layer, forward and remat
recompute), the mean over the traced steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = [m for n in ("moe.route", "moe.combine") for m in rec.phase_ms(n)] if rec else []
    return sum(ms) / s["units"] if ms and s["units"] else None

"""Device ms a flush of the MoE outside its expert products: routing and
the scatter into the expert buffers, then the combine (the port's phases
`moe.route` and `moe.combine`, every layer), over the traced flushes."""
from perfbench import program


def read(s):
    return program.phase_ms_per_flush(s, "moe.route", "moe.combine")

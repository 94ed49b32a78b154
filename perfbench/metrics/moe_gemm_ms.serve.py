"""Device ms a flush of the MoE's expert products (the port's phase
`moe.experts`: the three batched matmuls and the activation, every layer),
over the traced flushes."""
from perfbench import program


def read(s):
    return program.phase_ms_per_flush(s, "moe.experts")

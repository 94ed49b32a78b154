"""Device ms a flush of the policy's heads over every position (final norm,
the full-vocabulary LM head, the value head: the port's phase
`model.head`), over the traced flushes."""
from perfbench import program


def read(s):
    return program.phase_ms_per_flush(s, "model.head")

"""The mean ms a request waits in the InfServer's queue, from its submit to
the start of the flush that serves it, over the traced rounds (the port's
counter of each flush's waits)."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "serve")
    waits = rec.queue_waits_s if rec else None
    return 1e3 * sum(waits) / len(waits) if waits else None

"""Host ms a flush of the InfServer's own work around the forward: grouping
and padding, the upload, and the scatter of results to tickets (the
port's spans `infserver.pad`, `.h2d` and `.scatter`), over the traced
flushes."""
from perfbench import program


def read(s):
    return program.host_ms_per_flush(s, "infserver.pad", "infserver.h2d", "infserver.scatter")

"""Device ms of AdamW's loop over the leaves (the port's phase
`optim.update`), the mean over the traced steps."""
from perfbench import program


def read(s):
    return program.mean_phase_ms(s, "optim.update")

"""Device ms of the optimizer's prologue: the global gradient norm, the
clip scale, the lr and the bias corrections (the port's phase
`optim.norm`), the mean over the traced steps."""
from perfbench import program


def read(s):
    return program.mean_phase_ms(s, "optim.norm")

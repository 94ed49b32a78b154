"""Device ms of the learner step's backward, the remat recompute and
attention's backward included (the port's phase `learner.backward`), the
mean over the traced steps."""
from perfbench import program


def read(s):
    return program.mean_phase_ms(s, "learner.backward")

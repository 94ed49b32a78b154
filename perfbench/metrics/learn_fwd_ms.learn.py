"""Device ms of the learner step's forward, the loss included (the port's
phase `learner.forward`: a CUDA event pair on the step's stream), the mean
over the traced steps."""
from perfbench import program


def read(s):
    return program.mean_phase_ms(s, "learner.forward")

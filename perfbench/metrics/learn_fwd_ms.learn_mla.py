"""Device ms of the latent-attention MoE learner step's forward, the loss
included (the port's phase `learner.forward`), the mean over the traced
steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = rec.phase_ms("learner.forward") if rec else []
    return sum(ms) / len(ms) if ms else None

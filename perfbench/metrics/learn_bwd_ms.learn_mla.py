"""Device ms of the latent-attention MoE learner step's backward, the remat
recompute and attention's backward included (the port's phase
`learner.backward`), the mean over the traced steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = rec.phase_ms("learner.backward") if rec else []
    return sum(ms) / len(ms) if ms else None

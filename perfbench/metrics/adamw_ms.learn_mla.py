"""Device ms of the latent-attention MoE learner's AdamW loop over the
leaves (the port's phase `optim.update`), the mean over the traced steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = rec.phase_ms("optim.update") if rec else []
    return sum(ms) / len(ms) if ms else None

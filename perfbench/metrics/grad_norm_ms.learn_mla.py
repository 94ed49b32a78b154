"""Device ms of the latent-attention MoE learner's optimizer prologue: the
global gradient norm, the clip scale, the lr and the bias corrections (the
port's phase `optim.norm`), the mean over the traced steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = rec.phase_ms("optim.norm") if rec else []
    return sum(ms) / len(ms) if ms else None

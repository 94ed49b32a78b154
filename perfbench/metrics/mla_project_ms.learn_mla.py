"""Device ms a train step of latent attention's projections (the port's
phase `mla.project`: the input projections, latent norms and rotary
embeddings, and the output projection, each layer's forward and its remat
recompute; not their backward), summed over a step's calls, the mean over
the traced steps."""
from perfbench import program


def read(s):
    rec = program.recorder(s, "learn_mla")
    ms = rec.phase_ms("mla.project") if rec else []
    return sum(ms) / s["units"] if ms and s["units"] else None

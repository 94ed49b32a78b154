"""Device ms from the start of the latent-attention MoE learner's optimizer
update (a CUDA event recorded by a listener on the port's
`cost.phase("update")`) to the end of the step, the mean over the traced
steps."""


def read(s):
    ms = s.get("update_ms") if s else None
    if not ms or s.get("kind") != "learn_mla":
        return None
    return sum(ms) / len(ms)

"""1 - the union of device-operation intervals over the latent-attention
MoE learner's traced window, in %."""


def read(s):
    if not s or s.get("kind") != "learn_mla" or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

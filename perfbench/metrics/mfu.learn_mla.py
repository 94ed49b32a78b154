"""The latent-attention MoE learner's step FLOPs on this chip's share
(`work_mla.learn_step_flops`) over the traced step time and the bf16 peak,
in %."""
from perfbench import work_mla


def read(s):
    if not s or s.get("kind") != "learn_mla" or not s["units"]:
        return None
    step_s = s["window_s"] / s["units"]
    return 100.0 * s["model_flops_per_unit"] / step_s / work_mla.PEAK_FLOPS

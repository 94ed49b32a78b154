"""The train step's model FLOPs (`work.learn_step_flops`) over the traced
step time and the bf16 peak, in %."""
from perfbench import work


def read(s):
    if not s or s.get("kind") != "learn" or not s["units"]:
        return None
    step_s = s["window_s"] / s["units"]
    return 100.0 * s["model_flops_per_unit"] / step_s / work.PEAK_FLOPS

"""The attention forward calls' bound (the frozen work counts of every
call, the remat recompute included) over the device time of the kernels
launched inside the harness's spans around `dispatch.attention`, in %."""


def read(s):
    a = s.get("spans", {}).get("attention") if s else None
    if not a or s.get("kind") != "learn" or a["device_s"] <= 0:
        return None
    return 100.0 * s["attention_fwd_bound_s"] / a["device_s"]

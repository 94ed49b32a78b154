"""The (192, 128) attention forward calls' bound (`work_mla.attention_fwd`
of every call, the remat recompute included, v's width from the file)
over the device time of the kernels launched inside the harness's spans
around `dispatch.attention`, in %."""


def read(s):
    a = s.get("spans", {}).get("attention") if s else None
    if not a or s.get("kind") != "learn_mla" or a["device_s"] <= 0:
        return None
    return 100.0 * s["attention_fwd_bound_s"] / a["device_s"]

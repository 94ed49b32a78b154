"""The (192, 128) attention backward's bound (`work_mla.attention_bwd`, for
each call whose backward node ran) over the device time of those backward
nodes, in %."""


def read(s):
    a = s.get("spans", {}).get("attention") if s else None
    if not a or s.get("kind") != "learn_mla" or a["bwd_device_s"] <= 0:
        return None
    return 100.0 * s["attention_bwd_bound_s"] / a["bwd_device_s"]

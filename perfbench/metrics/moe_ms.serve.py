"""Device ms per flush of the kernels launched inside the harness's spans
around `models.moe.moe_apply`."""


def read(s):
    m = s.get("spans", {}).get("moe") if s else None
    if not m or s.get("kind") != "serve" or not s["flushes"] or m["device_s"] <= 0:
        return None
    return 1e3 * m["device_s"] / s["flushes"]

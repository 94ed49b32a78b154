"""The InfServer's own host clock per flush (`_latency_sum / batches_run`
over the traced rounds): upload, forward and the device-to-host copy."""


def read(s):
    if not s or s.get("kind") != "serve" or not s["flushes"]:
        return None
    return 1e3 * s["flush_s"]

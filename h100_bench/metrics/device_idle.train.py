"""device_idle.train: the share of time in which no operation ran on the
device, in %, in a training cell: the model's host dispatch
shows here. The device's busy time comes from the
profiler's trace of the trace batches; the time it is set against is the
same batches' wall time run untraced just before, since the profiler's own
host cost stretches the traced window."""


def read(r):
    t = r.get("trace")
    if not t or "model_flops" not in t or not t.get("untraced_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["untraced_s"])

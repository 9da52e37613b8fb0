"""device_idle.loss: the share of time in which no operation ran on the
device, in %, in a loss cell: the host glue of the loss
entry points, validation and the operator wrappers shows here. The device's busy time comes from the
profiler's trace of the trace batches; the time it is set against is the
same batches' wall time run untraced just before, since the profiler's own
host cost stretches the traced window."""


def read(r):
    t = r.get("trace")
    if not t or "least_s" not in t or not t.get("untraced_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["untraced_s"])

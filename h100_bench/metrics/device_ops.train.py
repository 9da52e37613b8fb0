"""device_ops.train: the device operations of one traced training step:
the operations the profiler saw on the device over the trace batches,
over the steps those batches took (``trace_steps``, which a training
entry that reports it counts a traced step as). A fused kernel in place of
many small ops reads lower."""


def read(r):
    t = r.get("trace")
    if not t or "model_flops" not in t or not t.get("trace_steps"):
        return None
    return t["device_op_count"] / t["trace_steps"]

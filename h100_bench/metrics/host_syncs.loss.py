"""host_syncs.loss: the port's host syncs (each read of device data on the
host, its counter ``syncs``) a loss call, in a loss cell, where each step
is one call: the sum of the sync counters over the launches of the padded
loss's forward kernel, one a call, over every call of the run before the
comparison (set-up's warm cycle, the window, the trace batches). The
counters are the program's own, read in this process; a program without
them reads nothing."""

from h100_bench.spans import syncs_a_call


def read(r):
    t = r.get("trace")
    if not t or "least_s" not in t:
        return None
    return syncs_a_call()

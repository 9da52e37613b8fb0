"""loss_roofline: the loss's least time by its shapes (counts.py: the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s), summed
over the traced window's steps, over the device-busy time of that window
(the union of the device operations' intervals in the profiler's trace),
in %."""


def read(r):
    t = r.get("trace")
    if not t or "least_s" not in t or not t["busy_s"]:
        return None
    return 100.0 * t["least_s"] / t["busy_s"]

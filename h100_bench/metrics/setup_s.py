"""setup_s: seconds from the start of the process to the first timed step
(imports, the kernel libraries' build or load, inputs, weights, warm-up)."""


def read(r):
    return r.get("setup_s")

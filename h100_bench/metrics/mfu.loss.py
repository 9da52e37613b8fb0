"""mfu.loss: the loss's least time by its shapes, summed over the timed
window's steps, over the window's wall time, in %: the whole loss step's
share of the card's peak, whatever kernels implement it."""


def read(r):
    least = r.get("least_s")
    return None if least is None else 100.0 * least / r["window_s"]

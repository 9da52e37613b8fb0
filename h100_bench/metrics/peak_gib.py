"""peak_gib: torch.cuda.max_memory_allocated over the timed window, the
inputs the cell holds included, in GiB."""


def read(r):
    peak = r.get("window_peak_bytes")
    return None if peak is None else peak / 2 ** 30

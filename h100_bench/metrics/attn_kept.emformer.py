"""attn_kept.emformer: of the attention score cells an Emformer encoder
computed over the traced steps (the program's ``counters()["emformer"]``
``attn_cells``, which its training entry reports a step), the share the
block mask keeps at the padded length (``attn_kept``), in %. A dense
masked attention reads the mask's sparsity; one that computes only the
kept blocks reads near 100. None where the program keeps no such
counters."""


def read(r):
    t = r.get("trace")
    if not t or not t.get("attn_cells") or "attn_kept" not in t:
        return None
    return 100.0 * t["attn_kept"] / t["attn_cells"]

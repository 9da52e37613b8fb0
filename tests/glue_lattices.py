"""The lattices of the glue kernels around rows 1-2 (csrc/loss_glue.cu),
shared by the CPU tests (tests/test_torch_kernels.py holds their plain
versions against the JAX package's glue) and the card's
(tests/test_torch_cuda.py holds the kernels against the plain versions),
and the invalid lengths that validation refuses after the padded loss has
queued them (tests/test_torch_helpers_bands.py, tests/test_torch_cuda.py).
It imports no JAX."""

import numpy as np

# (name, seed, B, T, S, V, blank, T_b, S_b, band): band None is the default
# bands, an int the alignment band's max_distance_from_alignment. S_b = 0,
# T_b = S_b and T_b = T_max samples; +-inf logits in every padding cell;
# lengths past the padded shape (T_b > T_max, S_b > S_max), which only a
# traced graph takes (no length check): NaN cost, zero gradient. Then the
# loss cell's four bucket shapes [B, T', S_pad + 1] with lengths drawn under
# them (T_b None; V = 8: no glue kernel reads the logits). A name ending in
# "-i64" takes int64 labels.
GLUE_LATTICES = [
    ("default", 31, 3, 9, 4, 37, 2, (9, 6, 4), (4, 0, 4), None),
    ("align-0", 32, 3, 9, 4, 37, 0, (9, 7, 5), (4, 2, 3), 0),
    ("align-3-i64", 33, 3, 9, 4, 37, 0, (9, 7, 5), (4, 2, 3), 3),
    ("s_b-0", 34, 2, 6, 3, 11, 0, (6, 4), (0, 0), None),
    ("t_b-eq-s_b", 35, 3, 6, 5, 11, 1, (5, 3, 1), (5, 3, 1), None),
    ("t_b-t_max", 36, 2, 7, 3, 11, 0, (7, 7), (3, 1), None),
    ("inf-padding", 37, 3, 9, 4, 37, 0, (9, 6, 3), (4, 2, 1), None),
    ("past-shape", 38, 3, 6, 3, 11, 0, (7, 6, 4), (3, 4, 2), None),
    ("bucket-72x299x54", 41, 72, 299, 53, 8, 0, None, None, None),
    ("bucket-36x390x70-i64", 42, 36, 390, 69, 8, 0, None, None, 2),
    ("bucket-30x452x81", 43, 30, 452, 80, 8, 0, None, None, None),
    ("bucket-26x500x89", 44, 26, 500, 88, 8, 0, None, None, None),
]


# (name, T_b, S_b) of a batch of 2 on the padded [2, 5, 3, V] lattice (T_max
# 5, S_max 2; (5, 3), (2, 1) is valid) that validation refuses: each
# value check once, then int32's extremes +-(2^31 - 1) in each length. The
# padded loss launches its forward kernels before it checks the lengths,
# so they take these too.
INT32_MAX = 2**31 - 1
BAD_LENGTHS = [
    ("ilen_zero", (0, 3), (2, 1)),
    ("slen_negative", (5, 3), (-1, 1)),
    ("ilen_below_slen", (5, 1), (2, 2)),
    ("ilen_above_tmax", (6, 3), (2, 1)),
    ("slen_above_smax", (5, 3), (3, 1)),
    ("ilen_int32_max", (INT32_MAX, 3), (2, 1)),
    ("ilen_int32_neg", (-INT32_MAX, 3), (2, 1)),
    ("slen_int32_max", (5, 3), (INT32_MAX, 1)),
    ("slen_int32_neg", (5, 3), (-INT32_MAX, 1)),
]


def glue_case(case):
    """(logits with its padding as the case has it, the same with finite
    padding, labels, T_b, S_b, alignment or None), numpy arrays."""
    kind, seed, batch, t, s, v, blank, ilen, slen, band = case
    rng = np.random.RandomState(seed)
    logits = (rng.randn(batch, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(0, v - 1, (batch, s))
    labels = np.where(labels >= blank, labels + 1, labels)
    labels = labels.astype(np.int64 if kind.endswith("-i64") else np.int32)
    if ilen is None:                  # a bucket: T_b in [T/2, T], S_b <= T_b
        ilen = rng.randint(t // 2, t + 1, batch)
        ilen[0] = t
        slen = np.minimum(rng.randint(0, s + 1, batch), ilen)
        slen[1] = s
    ilen, slen = np.asarray(ilen, np.int32), np.asarray(slen, np.int32)
    clean = logits.copy()
    if kind == "inf-padding":
        pad = ((np.arange(t)[None, :, None] >= ilen[:, None, None])
               | (np.arange(s + 1)[None, None, :] > slen[:, None, None]))
        logits[..., ::2][pad] = np.inf
        logits[..., 1::2][pad] = -np.inf
    if band is None:
        return logits, clean, labels, ilen, slen, None
    align = np.full((batch, t), blank, np.int32)
    for b in range(batch):
        at = np.sort(rng.choice(min(ilen[b], t), size=min(slen[b], s),
                                replace=False))
        align[b, at] = labels[b, :len(at)]
    return logits, clean, labels, ilen, slen, align

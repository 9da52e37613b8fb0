"""A torch model of the CUDA stats reduction's order, and the rows that
exercise its rules, shared by the CPU tests (tests/test_torch_split.py holds
the model against the JAX package) and the card's (tests/test_torch_cuda.py
holds the kernels against it). It imports no JAX."""

import torch

NEG_INF = float("-inf")


def stats_model(x):
    """Each row's (m, s) of x [..., V] (f32 or bf16) in the order of the CUDA
    stats reduction: a group of g lanes a row (16 where the row fits in half
    a 2 KB round, V <= 256 f32 or 512 bf16, else 32); rounds of 4g 16-byte
    vectors, lane i holding vectors i, i + g, i + 2g, i + 3g (values past V
    are -inf); per round and lane a max, one rescale, then exp(x - mn) added
    in index order; across lanes a max tree, one rescale a lane, then an add
    tree; all in f32, each exponential exp(x - max) (the card's expf is
    within 2 ulps of torch.exp). The max propagates NaN. Returns f32 tensors
    of x.shape[:-1]."""
    vn = 16 // x.element_size()                # values a 16-byte vector
    lead, v = x.shape[:-1], x.shape[-1]
    g = 16 if v <= 2 * 32 * vn else 32         # lanes a row
    rv = 4 * g * vn                            # values a round
    f = x.reshape(-1, v).float()
    n, rounds = f.shape[0], max(1, -(-v // rv))
    pad = torch.full((n, rounds * rv), NEG_INF)
    pad[:, :v] = f.cpu()
    # [n, round, lane, the lane's values in index order]
    lanes = pad.reshape(n, rounds, 4, g, vn).permute(0, 1, 3, 2, 4).reshape(
        n, rounds, g, 4 * vn)
    m = torch.full((n, g), NEG_INF)
    s = torch.zeros((n, g))
    for r in range(rounds):
        vals = lanes[:, r]
        mn = torch.maximum(m, vals.amax(-1))
        live = mn != NEG_INF
        s = torch.where(live & (mn != m), s * torch.exp(m - mn), s)
        for j in range(vals.shape[-1]):
            s = torch.where(live, s + torch.exp(vals[..., j] - mn), s)
        m = torch.where(live, mn, m)
    mx = m.amax(-1, keepdim=True)
    s = torch.where((mx != NEG_INF) & (m != mx), s * torch.exp(m - mx), s)
    while s.shape[-1] > 1:                     # lane 0's butterfly
        half = s.shape[-1] // 2
        s = s[:, :half] + s[:, half:]
    return mx.reshape(lead), s.reshape(lead)


def special_rows(x):
    """Writes the reduction's rule cases into x [B, T, S1, V] (B >= 2,
    T >= 2, S1 >= 3): an all -inf row, a row with one NaN, a row with one
    +inf; and -inf in every other value of a slot. Returns the (b, t, s) of
    the +inf row, whose stats are NaN in the kernels (inf - inf) and in the
    model, where torch.logsumexp gives -inf."""
    v = x.shape[-1]
    x[0, 1, 0] = NEG_INF
    x[1, 0, 1, v // 2] = float("nan")
    x[1, 1, 2, (v - 1) // 3] = float("inf")
    x[0, :, 2, ::2] = NEG_INF
    return (1, 1, 2)

"""A torch model of the CUDA beta_scan chain's slot layout and lane exchange
(csrc/split.cu, mrnnt_beta_warps_kernel), shared by the CPU tests
(tests/test_torch_split.py holds it against the JAX package's beta_scan and
the plain version). It imports no JAX."""

import torch

from monotonic_rnnt_tpu_torch.ops.helpers import NEG_INF, log_sum_exp

LANES = 32


def beta_chain_model(lp_blank, lp_label, beta_maskadd, input_lengths,
                     beta_virtual):
    """beta_scan's betas [B, T, S1] as the chain computes them: K =
    ceil(S1/32) warps of 32 lanes a sample, slot j*32 + lane in warp j (the
    slots past S1 carry values from clamped operand columns); each step
    reads nx = t+1 >= T_b ? the virtual row : the carry, shuffles each warp
    down one lane with lane 31 taking lane 0 of warp j+1 (the last warp's
    lane 31 keeps its own value), replaces by -inf every neighbour that
    lies past S1, then takes
    mask(log_sum_exp(nx + lp_blank, neighbour + lp_label)) slot by slot: -inf
    where the additive mask is -inf, the mask added elsewhere. The
    log_sum_exp is the port's, the kernels' arithmetic on the same operands
    in the same order."""
    batch, t_max, s1 = lp_blank.shape
    k = max(1, -(-s1 // LANES))
    slots = torch.arange(k * LANES)
    live = (slots < s1).reshape(k, LANES)
    edge = (slots + 1 >= s1).reshape(k, LANES)
    col = slots.clamp(max=s1 - 1)

    def regs(x):                               # [B, S1] -> [B, K, 32]
        return x[:, col].reshape(batch, k, LANES)

    virt = torch.where(live, regs(beta_virtual), NEG_INF)
    carry = torch.full((batch, k, LANES), NEG_INF)
    betas = torch.empty_like(lp_blank)
    for t in range(t_max - 1, -1, -1):
        use_virt = (t + 1 >= input_lengths)[:, None, None]
        nx = torch.where(use_virt, virt, carry)
        up = torch.cat([nx[..., 1:], nx[..., -1:]], dim=-1)   # shuffle down
        up[:, :-1, -1] = nx[:, 1:, 0]          # lane 31 <- warp j+1's lane 0
        n1 = torch.where(edge, NEG_INF, up)
        new = log_sum_exp(nx + regs(lp_blank[:, t]),
                          n1 + regs(lp_label[:, t]))
        mask = regs(beta_maskadd[:, t])
        carry = torch.where(mask == NEG_INF, NEG_INF, new + mask)
        betas[:, t] = carry.reshape(batch, k * LANES)[:, :s1]
    return betas

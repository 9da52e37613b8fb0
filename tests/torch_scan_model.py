"""Torch models of the CUDA register chains' slot layout and lane exchange
(csrc/split.cu, alpha_warps and beta_warps: the scans at S1 <= 128), shared
by the CPU tests (tests/test_torch_split.py holds them against the JAX
package's alpha_scan, beta_scan and fwdbwd_scan and the plain versions). It
imports no JAX."""

import torch

from monotonic_rnnt_tpu_torch.ops.helpers import NEG_INF, log_sum_exp

LANES = 32


def _layout(s1):
    """K = ceil(S1/32) warps: slot j*32 + lane in warp j; each slot's
    operand column, clamped to S1-1 for the slots past S1."""
    k = max(1, -(-s1 // LANES))
    slots = torch.arange(k * LANES)
    return k, slots, slots.clamp(max=s1 - 1)


def alpha_chain_model(lp_blank, lp_label, alpha_maskadd):
    """alpha_scan's alphas [B, T, S1] as the chain computes them: K warps of
    32 lanes a sample (the slots past S1 carry values from clamped operand
    columns that no live slot reads). The carry starts at 0 in slot 0 and
    -inf elsewhere; each step every slot offers carry + lp_label[t] (its
    own column), which each warp shuffles up one lane, lane 0 taking lane
    31 of warp j-1, and slot 0 takes -inf; then
    mask(log_sum_exp(carry + lp_blank, offer from below)) slot by slot: -inf
    where the additive mask is -inf, the mask added elsewhere."""
    batch, t_max, s1 = lp_blank.shape
    k, slots, col = _layout(s1)

    def regs(x):                               # [B, S1] -> [B, K, 32]
        return x[:, col].reshape(batch, k, LANES)

    carry = torch.where(slots == 0, 0.0, NEG_INF).reshape(1, k, LANES)
    carry = carry.expand(batch, k, LANES)
    alphas = torch.empty_like(lp_blank)
    for t in range(t_max):
        offer = carry + regs(lp_label[:, t])
        emit = torch.cat([offer[..., :1], offer[..., :-1]], dim=-1)  # up
        emit[:, 1:, 0] = offer[:, :-1, -1]     # lane 0 <- warp j-1's lane 31
        emit[:, 0, 0] = NEG_INF                # slot 0
        new = log_sum_exp(carry + regs(lp_blank[:, t]), emit)
        mask = regs(alpha_maskadd[:, t])
        carry = torch.where(mask == NEG_INF, NEG_INF, new + mask)
        alphas[:, t] = carry.reshape(batch, k * LANES)[:, :s1]
    return alphas


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
    k, slots, col = _layout(s1)
    live = (slots < s1).reshape(k, LANES)
    edge = (slots + 1 >= s1).reshape(k, LANES)

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

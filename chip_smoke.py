#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the monotonic RNN-T loss on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``monotonic_rnnt_tpu_torch/csrc``,
then measures the card's copy ceiling (``run_ceiling``): the three copy
kernels of csrc/stream.cu (``stream_copy`` in its vmem and dma modes,
``stream_copy_blocked``, ``stream_copy_blocked_tbsv``) bit for bit against
their plain versions and their inputs, at bench.py's sizes ([327680, 1024]
flat; [32, 200, 51, 1024] blocked, tt=1 f32 and 2 bf16; its t-major
control) in f32 and bf16, at V=7 and odd blocks, at every divisor, at the
redesigned copies' edge cases (CEIL_EDGES, random bytes) and, for those
copies, on one f32 tensor past 2^31 bytes; then a ping-pong chain of 24
copies per configuration after one untimed copy (so that the host's first
launch is not in the window), 5 interleaved trials, median, printed as
GB/s = 2*bytes/t beside ``Tensor.copy_`` and the 3.35 TB/s spec, and as
each rate over ``copy_``'s. A dtype's copy ceiling is the best of the flat
modes.
Then it holds each loss kernel wrapper against its plain PyTorch version,
rows 1-2 (the persistent ``stats_alpha_fused`` and ``beta_grad_fused``)
also at EDGE_CASES, one launch a call, probing there exact -inf from
LSE(-inf, -inf), +inf cost with a zero gradient on an infeasible lattice, an
exact zero gradient on +-inf padding, and bf16 summed in f32 and written in
bf16, and at the benchmark lattice in f32 and bf16 rows 1, 3 and 7
(``stats_alpha_fused``, ``softmax_stats`` and ``softmax_stats_banded`` on a
band of W = S1 whose windows mask nothing) for stats equal bit for bit (they
share one row reduction); then it drives the padded loss's main path (forward, cost-only and backward at the
benchmark lattice B=32, T=200, S=50, V=1000, in float32 and bfloat16)
against the plain-torch oracle, checks the golden values of the
reference's worked example, takes five SGD steps, and times the kernels
with CUDA events (rows 1-2: the wrapper, the kernel alone on zeroed
scratch, and their difference, the host prelude; the glue kernels around
them, csrc/loss_glue.cu: a call, queued, alone in a CUDA graph, and their
plain versions); the end-to-end line carries bench.py's roofline fraction
of the padded step (3 passes over the logits at the measured ceiling over
the fwd+bwd time, and at the blocked ceiling and the spec).

The banded phase then builds the banded acceptance case (B=2, T=1600,
S=200, V=1024, alignment band +-20; benchmarks/banded_bench.py) with the
port's own functions and, in float32 and bfloat16: holds the four banded
kernels against their plain versions on the case's operands, and
``softmax_stats`` against ``softmax_stats_banded`` bit for bit on the band's
rows where the windows add 0; in float32 prints the stats drift
(``band_stats_drift``: how many of row 7's denoms equal torch.logsumexp's,
and which alphas and betas move when the scan reads them instead of the
oracle's); drives
``monotonic_rnnt_loss_banded`` (a training step with per-sample weights, then
a cost-only call, launch counts read after each part) against the banded
oracle, and against the padded loss on the full [2, 1600, 201, 1024]
lattice through ``unpack_band``; checks the banded goldens, five SGD steps,
and the banded loss at the benchmark lattice (+-8 band, variable T_b and
S_b) against the padded restricted result; and times each kernel beside its
byte bound, its plain version and a PyTorch yardstick, the scans also in ns
per dependent step and queued back to back (``queued_ms``: each call's host
prelude then overlaps the kernel before it; the stats kernels of rows 3, 7
and 10 and grad_pass are queued too), and ``fwdbwd_scan_banded``
once more with the second
sample at T_b = T/2 (its beta chain then reads the virtual row on half its
steps), held against its plain version there too.

The split phase holds the four split kernels (softmax_stats, fwdbwd_scan,
alpha_scan, beta_scan), which serve alignment, the fused-joint losses and
sharding (the padded loss has one CUDA route, rows 1-2), against their
plain versions at S1 = 1, 51 and 1101, at the scans' register-chain edges
(S1 = 31-33, 64, 65, 96, 97, 128, 129, 256, 257: warp counts and the cut),
at the benchmark lattice in float32 and bfloat16, and on the banded case's
full [2, 1600, 201, 1024] lattice (the scans at T=1600). The split scans'
times are also printed in ns per dependent step, from one call, queued,
and as the kernel alone (``kernel_queued_ms``: wrapper calls captured in a
CUDA graph and replayed).

The fused-joint phase runs ``rnnt_loss_fused_joint`` at
benchmarks/memory_bench.py's case (B=4, T'=1024, S=63, V=8192, H=512,
chunk_t=64) against the materialised route (the joint's 8 GiB logits, then
``monotonic_rnnt_loss``) and a float64 truth, with the peak memory of each;
then ``rnnt_loss_fused_joint_banded`` at benchmarks/fused_banded_bench.py's
case (B=2, T=1600, S=200, V=1024, H=512, shift 20) against the
materialised banded route and the full-lattice fused-joint loss with the
same bands. On each fused-joint path one more training step keeps the
operands of its kernel calls for the last T-chunk and an interior one (and
of its one alpha scan over all of T), and each of those calls is held
against its plain version: softmax_stats on the chunk's logits (2-D labels
on the full lattice, per-t [B, Tc, W] labels on the band), the chunk's beta
scan fed the next chunk's carry as its virtual row, and grad_pass. The
interior chunk's beta scan and grad_pass are timed there, one call and
queued (grad_pass beside torch.softmax on the same logits, its bound from
the chunk's live rows), and the one alpha scan over all of T one call,
queued and as the kernel alone. Then it times both training steps.

The sharded phase (``run_sharded``) saves what its ranks read to a
temporary directory (the parent's single-process costs, the banded case's
packed band tensor, each fused case with the single-process training
step's costs and gradients of the mean), then starts 4 ranks of this script
(``--sharded-rank``) on the one card as a gloo group (NCCL takes one rank
per card). Each rank: holds ``softmax_stats_partial`` against its plain
version on its shard of the padded lattice and at V_local = 1, 250, 500 and
4096 with all -inf rows; drives ``make_dp_tp_loss`` at the benchmark
lattice on meshes (2,2) and (1,4) in f32 and bf16 (a training step of the
mean, a cost-only call, a weighted step through ``rnnt_loss_vocab_sharded``;
launch counts read after each), with the blank on shard 2, and the
data-parallel losses on (4,1); ``make_dp_tp_banded_loss`` at the banded
case on (2,2); ``make_dp_tp_fused_loss`` at memory_bench's case and
``make_dp_tp_fused_banded_loss`` at the banded case on (2,2), with the peak
memory of each rank. Each result is held against the single-process port
route on the rank's batch slice (the loss is batch-separable) or against the
parent's saved single-process numbers, and one training step's kernel
calls on every path (data-parallel, padded, banded and fused TP) are kept
and held against their plain versions. The
parent fails as soon as a rank fails or the ranks pass SHARDED_TIMEOUT_S,
sums the fused gradients' squared errors over the shards, and times
``softmax_stats_partial`` at a rank's padded shard [16, 200, 51, 500].

The model phase (``run_model``) builds the port's Conformer transducer at
benchmarks/train_bench.py's defaults (B=16, 400 input frames, 25 labels, 80
features; a 4x256 Conformer with 4 heads, an LSTM predictor with embed_dim
128, joint_dim 256, V=1024, dropout 0; its lattice [16, 100, 26, 1024])
from a seeded torch.Generator, in float32 (TF32 off) and bfloat16. In
float32 it holds the card against the same model on the CPU, where the loss
runs rows 1-2's plain versions: the costs, every parameter's gradient and
the greedy hypotheses (max_labels 50, decode_bench.py's default; a sample
whose hypothesis differs must differ first at a frame whose CPU top-2
margin is below 1e-4, printed); holds rows 1-2 against their plain versions
on the model's logits; reads the launch counts of the loss step (rows 1-2
and the glue kernels around them, LOSS_STEP), of a cost-only forward under
torch.no_grad (row 1 and its glue, COST_ONLY) and of greedy decode (none);
and
runs the Joint as the joint_fn of rnnt_loss_fused_joint and, under
default_bands, of rnnt_loss_fused_joint_banded, and its banded form under
monotonic_rnnt_loss_banded, each against the materialised model loss, with
every kept kernel call held against its plain version. The bf16 model's
costs are held against the f32 model's. The benchmark's train cells
(h100_bench) time the model; this phase times nothing.

The train phase (``run_train``) drives ``models/train.py`` at the model
cell: ``create_train_state`` (lr 3e-3, one warmup update, so the first
update has lr 0) from seed 0, the same weights as run_model's. In float32
it takes 3 ``train_step``s on the card (LOSS_STEP's launches each) and 3
on the CPU (the loss's oracle) and holds the
losses, grad_norms and every parameter after them (the attention's key
bias apart: its true gradient is exactly 0, so it is held finite and
within Adam's drift bound), then two more card steps, over which the loss
must descend; the memory-efficient step (``make_memory_efficient_loss``,
chunk 32, through ``train_step_with_loss``; softmax_stats, alpha_scan,
beta_scan and grad_pass in the chunking's counts) against the padded
steps; ``make_grad_accum_train_step(4)`` against the first two; and a
checkpoint round trip on the card (saved, restored into a state from seed
7, one more step on each); it times nothing, as run_model. The sharded
phase's ranks also take two
``make_sharded_train_step`` steps on (4,1) and two
``make_tp_sharded_train_step`` steps (chunk 32) on (2,2) of the model cell
cut to one Conformer block, held against the parent's single-process
``train_step`` run on the same weights; the launches of both go into the
kernels JSON (paths train_dp, train_tp, beside train and
train_fused_joint). Each of the four paths keeps the kernel calls of one
step (rows 1-2; or the stats of the backward's last and an interior
chunk, the beta scan and grad_pass on those chunks and the alpha scan)
and holds them against their plain versions on the same operands. The
traced phase also traces one train_step a dtype.

The decode phase (``run_decode``) drives the serving decoders at the model
cell (decode_bench.py's defaults: K=4, max_labels 50; f32 and bf16):
``beam_search_decode`` plain, with ``merge_paths``, and fused at weight 0.3
with a BigramLm (a seeded log-softmax [V, V] table) and with an LstmLm of
LstmLmConfig's widths; K=1 against ``greedy_decode``; in f32 each beam form
against the CPU port on the same weights; each sample's merged top score
against the marginal of its sequence (the model's logits through
``monotonic_rnnt_loss``, cost-only: one stats_alpha_fused, held against its
plain version, and its glue, path decode_marginal); then the same widths made causal
(attn_left_context 16) stream the batch in 32-frame chunks with
``streaming_lookback`` of history (``streaming_step``, and
``streaming_beam_step`` with the LstmLm), against that model's
full-utterance greedy and beam decodes. No decoder may launch a kernel
(paths decode, decode_lm, stream, stream_beam: 0). A decode that differs
from its reference must part first at a frame whose reference margin (the
top-2 logits; for beam, the smallest gap between adjacent candidates among
the K+1 best) is below 1e-4, found by replaying both loops frame by frame;
equal hypotheses' scores agree within 1e-6 + 1e-5|ref|. Then CUDA-event
medians of 10 calls: each beam form's ms and x realtime (16 x 400 frames of
10 ms), streaming greedy and streaming beam ms per chunk and x realtime.
The traced phase traces one beam decode and one streaming chunk a dtype.

The serving phase (``run_serving``, after the decode phase, before the
alignment phase) prints the port's provenance stamp, then exports the padded
loss with ``serving.export_loss(backend="cuda")`` at the benchmark lattice in
f32 and bf16 and imports it from the bytes: the imported call launches rows
1 and 2 once each (the torch.library operators; their CUDA implementations'
operands are kept and held against the plain versions, path export) and
its costs and gradients equal a live ``rnnt_loss_cuda(with_grads=True)`` bit
for bit; it prints the export's and import's seconds, the blob's bytes, the
imported and the live call's CUDA-event medians of 20, timed in turns, and
the padded ``fwd_bwd_ms`` of the timing phase. The reference artifact at
tests/test_serving.py's [3, 12, 5, 11] runs on the card against the oracle;
``export_greedy_decoder`` at the model cell (f32, the weights an argument)
against the live ``greedy_decode`` token for token; and
``export_streaming_decoder`` at the streaming cell over the lookback's
chunks and four more (every chunk's emitted ids against the live
``streaming_step``), each timed against its live decoder in turns. Last,
one training step of the padded loss with debug_space, debug_fwdbwd,
check_fwd_bwd, debug_grads and debug_time on: each line printed, row 2's
betas handed to emit_loss_debug with no mismatch, the step's rows 1-2 calls
held against the plain versions (path export_debug).

The traced-routes phase (``phase_traced_routes``, after the serving
phase) takes each kernel route as one traced graph, as JAX's jax.export
and jax.jit take them: it exports through bytes the banded kernel route's
costs and grads and its cost-only costs at the banded case, the
fused-joint loss's cost-only forward at memory_bench's cell and Viterbi
with the occupancies at TRACED_ALIGN_CASE (the serving phase exports the
padded loss), and compiles with ``torch.compile(fullgraph=True,
backend="aot_eager")`` the padded loss, the banded loss (forward and
backward) and the fused-joint forward. Each artifact and compiled call
equals its live call bit for bit and launches what the live call does
(so no export and no trace launched a kernel), and every kernel call of
the phase is held against its plain version (a Hold at the operators'
CUDA implementations, path traced). It logs two probes, whether the
fused-joint training step and the vocab-sharded loss compile fullgraph
(the first breaks at ``torch.autograd.grad``; ROADMAP.md section 3), and
prints the export, import and first-call seconds and each traced call's
ms against its live call's, timed in turns outside the Hold.

After the packed phase, ``phase_gather_cost`` times on the host the
final-cell gather with its bounds check (JAX's out-of-bounds fill, which an
exported loss needs) against the bare gather, beside the host time of a
training step of the oracle, the vocab-sharded core and the banded loss at
a small lattice: the check's cost against each step's quartile spread.

The acceptance phase (``run_acceptance``, last, after the traced phases:
it allocates 8.4 GB and runs thousands of small ops) runs the
port's acceptance harness short (``monotonic_rnnt_tpu_torch/scripts/``):
``fuzz_gpu``'s overflow probe (the NaN-cost input with finite logits at
c = 50, 100 and 1e4 through rows 1-2: the same non-finite gradient cells
as the plain versions and the oracle) and its ACCEPTANCE_CASES drawn cases
at seed 0 (each the kernel route against the oracle, banded cases on the
packed layout too;
among them cases at scale 50/100, sharded cases on a one-rank gloo group
with a NaN-cost sample, and export cases at T_b = T + 1 and S_b = S + 1
through the reference and cuda artifacts), then ``gpu_acceptance``'s
large-V, odd-V, large-shape and over-cap parity checks, which no other
phase makes. A Hold shims every operator's CUDA implementation for the
phase: each call
on the card is held, before it returns, against its plain version on the
same operands (the same NaN cells, the rest within the kernel checks'
tolerances), and every launch must be a held call. Its launches go into
the kernels JSON under the path acceptance, with each kernel's max |d|
against its plain version; it prints the fuzz's and each check's seconds,
the losses' worst |d| against the oracle and the phase's seconds against
its 120 s budget.

The packed-layout, binding and alignment paths run last, so that every
figure above is taken in the same state as without them. The alignment phase
(``run_alignment``) runs ``viterbi_alignment`` on the banded case's full
lattice (the clipped band) and ``viterbi_alignment_banded`` on its band,
and both occupancy posteriors: identical alignments, each score at least
the loss and equal to its own alignment's score, occupancies that sum to 1
and agree between the two layouts; the Viterbi path's +-20 band through
the binding's restricted loss on the packed acts against
``monotonic_rnnt_loss_banded``; launch counts; the four calls' kernel
calls held against their plain versions; both Viterbi calls timed.
The packed phase (``run_packed``) packs the benchmark lattice to the
reference's [sum T_b(S_b+1), V] layout and drives the torch binding
(``monotonic_rnnt_loss``, ``MonotonicRNNTLoss`` none/sum/mean) and
``monotonic_rnnt_loss_packed`` against the padded loss on the same logits:
a weighted training step, a cost-only call (launch counts read after each),
the +-8 restricted variant and bf16 (the step's rows 1-2 calls held
against their plain versions); the native engine on the host on the
first 4 samples against the card; the goldens through the binding; the
packed step, the padded step and the two index ops timed. Last, one
training step of the padded loss, then one loss step of the model cell in
float32 and bfloat16, runs under the port's
``utils/profiling.device_trace``: the top 10 device operations, the
device ops counted and the device time over the step's wall time (a trace
without device time is printed, not failed).

Every path in a kernel's launches_by_path has a max_abs_err_by_path entry
from its own run, or the script fails. Any failed check raises, and the
script exits non-zero. The last three lines
of its output are the kernels JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.

Tolerances, each with its reason:
  * copy kernels vs plain versions and inputs: byte for byte (a copy has no
    arithmetic);
  * kernel vs plain version, same inputs: stats |d| <= 1e-5 + 1e-6|ref|
    (the kernel's warp reduction sums V in another order than
    torch.logsumexp); the stats kernels among themselves bit for bit (one
    reduction, in one order for every kernel and load width); alphas and betas |d| <= 1e-4 + 1e-5|ref| (that
    rounding carried through T log-space steps of magnitude up to ~1e3);
    f32 grads |d| <= 1e-6 + 1e-4|ref|; bf16 grads |d| <= 1e-6 + 8e-3|ref|
    (one bf16 ulp: both sides round an f32 value whose last bits may differ);
  * loss vs oracle: costs |d| <= 1e-4 + 1e-5|ref|; f32 grads
    |d| <= 1e-6 + 1e-3|ref| (the oracle's alphas come from other stats
    roundings, and at T=200 a log-space sum of ~1e3 carries that into the
    exponent of every occupancy coefficient); bf16 grads
    |d| <= 1e-6 + 1.6e-2|ref| (two bf16 ulps: the oracle scales an f32
    gradient by the cotangent and rounds, the kernel rounds once);
  * goldens: cost 1e-4, gradient table 1e-2, as the JAX package's tests;
  * banded kernels vs plain versions: as the padded kernels above (the same
    online-LSE code for the stats; the scans' alphas and betas reach ~1.1e4
    at T=1600, so 1e-5 relative is a few ulps); grad_pass f32 1e-4, bf16
    8e-3 relative (one ulp);
  * banded loss vs the banded oracle: costs as above; grads f32
    |d| <= 1e-6 + 1e-3|ref|, bf16 1.6e-2 (the padded main path's bounds: the
    oracle's stats come from torch.logsumexp, whose rounding the T=1600
    log-space sums carry into every occupancy exponent);
  * banded vs padded on the same band: costs as above, unpacked grads f32
    1e-4, bf16 8e-3 relative. Both routes share the stats code and the DP
    operation order, so they differ at most by the exp of the occupancy
    coefficients (in-kernel expf against torch.exp), a few ulps;
  * split kernels vs plain versions: as the padded kernels above (the
    same stats and DP arithmetic); every kernel call a path made, against
    its plain version on the same operands, as kernel vs plain above;
  * fused-joint losses: costs |d| <= 1e-4 + 1e-5|ref| against every other
    route; gradients of d_enc, d_pred and each joint parameter by their
    relative L2 error, <= 2e-3 between two f32 routes and <= 5e-3 against
    the float64 truth. At T' >= 1024 the f32 alphas reach ~1e4, whose ulp
    (~1e-3) enters the exponent of every occupancy coefficient, and a
    chunk's joint product rounds otherwise than the whole lattice's: every
    f32 route, the plain oracle included, is ~2-3e-3 from the truth;
  * softmax_stats_partial vs its plain version: m bit for bit (a max), se
    |d| <= 1e-5 + 1e-6|ref| (another summation order);
  * sharded losses vs the single-process routes: the loss (the mean over
    the global batch) and costs |d| <= 1e-4 + 1e-5|ref|; padded gradients
    as "loss vs oracle" above (the combined denominator rounds in another
    order, and T=200 log-space sums carry that into every occupancy
    exponent); the banded TP gradients at T=1600 and the fused-joint TP
    gradients by relative L2 <= 2e-3, the bound between two f32 routes
    above (bf16 banded entry by entry, 1.6e-2); data-parallel costs
    relative 1e-6 (the same kernels on the same rows);
  * packed binding and packed loss vs the padded loss on the same logits:
    costs and packed grads 1e-6 relative, expected bit for bit (the same
    kernels on the same valid cells; unpacking copies rows and its backward
    gathers them);
  * native engine on the host vs the card's binding: costs as "loss vs
    oracle" above; gradients |d| <= 1e-6 + max(1e-3, 16 ulp(|ll_b|))|ref|
    (~2e-3 at the benchmark lattice, |ll| ~ 1.3e3): another f32 implementation,
    whose ll rounds otherwise in every occupancy exponent (the card showed
    1.1e-3 at one entry, past the oracle's 1e-3);
    binding goldens as above, restricted 1.22 / 2.7 at 1e-2 as
    tests/test_interop.py;
  * the model, card vs CPU in float32: costs 1e-4 relative, every
    parameter's gradient a relative L2 error of 1e-3 (the attention's key
    bias, whose exact gradient is 0, against its key weight's gradient
    norm), greedy hypotheses equal (or first apart at a CPU top-2 margin
    below 1e-4); the bf16 model's costs 2e-2 relative to the f32 model's
    (two roundings of every layer); the Joint as joint_fn and its banded
    form vs the materialised model loss: costs |d| <= 1e-4 + 1e-5|ref|,
    gradients relative L2 <= 2e-3, as the fused-joint losses above;
  * the train step, card vs CPU in float32 over 3 steps: losses 1e-4
    relative, grad_norm 1e-3, every parameter's relative L2 error 1e-3
    (TRAIN_PARAM_REL: Adam's step does not see a gradient's scale, so
    run_model's <= 8.61e-5 gradient agreement carries into each leaf's error
    at about that size; the rest is room for the elements at the noise
    floor, whose steps noise decides), the key bias within Adam's drift
    bound of its initial 0 on both sides; the memory-efficient step vs
    train_step: losses |d| <= 1e-4 + 1e-5|ref|, parameters at the
    fused-joint gradient bound 2e-3; gradient accumulation vs one step:
    losses 1e-5 relative, parameters 1e-3; the resumed checkpoint's loss
    1e-6 relative (CUDA atomics in the backward vary the bits); the
    sharded train steps vs the single-process run: losses |d| <= 1e-4 +
    1e-5|ref|, grad_norm 1e-3 relative, each rank's parameters (its shard
    of the vocab projection) at 1e-3 (DP) and 2e-3 (TP, the fused-joint
    route);
  * Viterbi on the band vs the full lattice: alignments identical, scores
    |d| <= 1e-4 + 1e-5|ref| (the same max-plus steps on stats from two
    stats kernels); each score vs its own alignment's restricted loss at
    that tolerance, and at least the loss less it; occupancy sums: a
    frame's sum misses 1 by the f32 rounding of alpha + beta - ll, so its
    bound is max(1e-4, 32 ulps of |ll|): 0.031 at T=1600, where |ll| ~ 1.1e4
    and the card showed 0.0097 (~10 ulps); banded vs full occupancy relative L2
    <= 2e-3, the long-T bound between two f32 routes; the realigned
    binding loss vs the banded loss as costs above;
  * the export artifacts: the cuda loss bit for bit against the live
    rnnt_loss_cuda (the same two kernels on the same operands; row 2's
    tickets decide which CTA writes a row, not its value); the reference
    artifact against the oracle as tests/test_serving.py holds it (costs
    1e-6 relative, gradients 1e-6 + 1e-7); the decoder artifacts token for
    token against the live decoders on the card (the same ops);
  * the acceptance phase: fuzz_tpu's tolerances (costs 2e-3 relative to
    max(1, |cost|), gradients 1e-3; 2e-2 in bf16; at scale 50 and 100 the
    non-finite gradient cells the same cells and the finite ones within
    those), the export cases' out-of-range samples NaN with a zero
    gradient; tpu_acceptance.py's parity tolerances (costs 1e-3, gradients
    5e-4 absolute; the over-cap shapes costs 2e-3; bf16 2e-2);
  * the decoders: hypotheses equal token for token, or first apart at a
    frame whose reference margin is below 1e-4 (phase_model_decode's rule:
    two sides' matmuls round apart, ~1e-6 in a logit); the scores of equal
    hypotheses |d| <= 1e-6 + 1e-5|ref| (100 frames of ~-7 log-probs each
    carry that rounding); a merged score at most the marginal + 1e-4 (the
    loss tests' cost bound: a sum over a subset of the paths can only be
    lower).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from monotonic_rnnt_tpu_torch.scripts._cases import (CheckFailed, assert_close,
                                                     banded_case, check,
                                                     make_inputs,
                                                     one_rank_group,
                                                     random_alignment)

ROOT = Path(__file__).resolve().parent
SEED = 0
B, T, S, V = 32, 200, 50, 1000
ALIGN_SHIFT = 8
# The banded acceptance case (benchmarks/banded_bench.py:10) and its band.
BANDED_CASE = (2, 1600, 200, 1024)
BAND_SHIFT = 20
TIMING_REPS = 20
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and f32 outside the
# tensor cores (the kernels do elementwise f32 work only).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


LOG_PREFIX = ""   # a rank of the sharded phase prefixes its lines
# Rows 1 and 7 reduce their rows with rows 3 and 10's stats reduction.
SHARED_REDUCTION = "reduction shared with rows 3 and 10 (PR 9)"


def log(msg: str) -> None:
    print(LOG_PREFIX + msg, flush=True)


def launched(K) -> dict:
    """The wrappers that launched since the last reset, with their counts."""
    return {name: n for name, n in K.LAUNCHES.items() if n}


# A padded loss call's launches on its DP-fused route: with a gradient, rows
# 1-2 and the glue kernels around them (csrc/loss_glue.cu); cost-only, row 1
# and its glue, no beta_operands.
LOSS_STEP = {"loss_prologue": 1, "stats_alpha_fused": 1, "loss_costs": 1,
             "beta_operands": 1, "beta_grad_fused": 1}
COST_ONLY = {"loss_prologue": 1, "stats_alpha_fused": 1, "loss_costs": 1}


def times(launches: dict, n: int) -> dict:
    return {row: k * n for row, k in launches.items()}


def worst_share(got, ref, atol: float, rtol: float) -> float:
    """The largest |got - ref| / (atol + rtol|ref|): 1 is at the tolerance."""
    got, ref = got.detach().double(), ref.detach().double()
    diff = torch.where(got == ref, 0.0, (got - ref).abs())
    return float((diff / (atol + rtol * ref.abs())).max())


def ulps(x):
    """The f32 spacing at |x|."""
    x = x.float().abs()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


def cuda_times(fn, reps: int, warmup: int = 3) -> list:
    """`reps` CUDA-event timings of fn() in ms, each from an idle card,
    after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    return statistics.median(cuda_times(fn, reps, warmup))


def queued_ms(fn, reps: int = TIMING_REPS) -> float:
    """Per-call ms of `reps` calls of fn() queued back to back between two
    CUDA events, after one untimed call: each call's host prelude overlaps
    the kernel before it, so a kernel that outlasts its prelude is timed
    alone (cuda_ms times one call from an idle card, prelude included)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = TIMING_REPS) -> float:
    """Per-call ms of `reps` calls of fn() captured in one CUDA graph and
    replayed between two CUDA events, after one untimed replay: the
    kernels alone, without the host prelude that queued_ms overlaps."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def kernel_ms(launch, scratch, reps: int = TIMING_REPS,
              warmup: int = 3) -> float:
    """Median CUDA-event time of launch() alone: its scratch is zeroed
    before each start event, outside the timed window."""
    times = []
    for i in range(warmup + reps):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Capture:
    """Shims over a path module's kernel wrappers that keep the arguments of
    chosen calls: keep[name] holds the indices (0-based, per wrapper) of the
    calls to keep. The shims call the wrappers, so launches count as usual;
    compare_captured then holds each kernel against its plain version on
    exactly the operands the path built."""

    def __init__(self, module, keep):
        self.module, self.keep = module, keep
        self.calls = {name: [] for name in keep}

    def __enter__(self):
        self.saved = {name: getattr(self.module, name) for name in self.keep}
        for name, fn in self.saved.items():
            self._shim(name, fn)
        return self

    def _shim(self, name, fn):
        seen = [0]

        def shim(*args, **kwargs):
            if seen[0] in self.keep[name]:
                self.calls[name].append((seen[0], args, kwargs))
            seen[0] += 1
            return fn(*args, **kwargs)

        setattr(self.module, name, shim)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def plain_pairs(mt):
    """Each wrapper a path calls: (wrapper, plain version, atol, rtol)."""
    SK, K, BK = mt.SK, mt.K, mt.BK
    scan = (1e-4, 1e-5)
    return {"softmax_stats": (SK.softmax_stats, SK.softmax_stats_plain,
                              1e-5, 1e-6),
            "alpha_scan": (SK.alpha_scan, SK.alpha_scan_plain, *scan),
            "beta_scan": (SK.beta_scan, SK.beta_scan_plain, *scan),
            "fwdbwd_scan": (SK.fwdbwd_scan, SK.fwdbwd_scan_plain, *scan),
            "alpha_scan_banded": (BK.alpha_scan_banded,
                                  BK.alpha_scan_banded_plain, *scan),
            "fwdbwd_scan_banded": (BK.fwdbwd_scan_banded,
                                   BK.fwdbwd_scan_banded_plain, *scan),
            "softmax_stats_banded": (BK.softmax_stats_banded,
                                     BK.softmax_stats_banded_plain, 1e-5,
                                     1e-6),
            "grad_pass": (K.grad_pass, K.grad_pass_plain, 1e-6, 1e-4),
            "softmax_stats_partial": (SK.softmax_stats_partial,
                                      SK.softmax_stats_partial_plain, 1e-5,
                                      1e-6),
            # The glue kernels: selects and integer arithmetic, exact.
            "loss_prologue": (K.loss_prologue, K.loss_prologue_plain, 0, 0),
            "loss_costs": (K.loss_costs, K.loss_costs_plain, 0, 0),
            "beta_operands": (K.beta_operands, K.beta_operands_plain, 0, 0)}


def compare_captured(mt, cap, what):
    """Every captured call's kernel against its plain version on the same
    arguments; returns each wrapper's max |d| over its captured calls."""
    pairs, errs = plain_pairs(mt), {}
    with torch.no_grad():
        for name, calls in cap.calls.items():
            kern, plain, atol, rtol = pairs[name]
            check(len(calls) == len(cap.keep[name]),
                  f"{what}: {name} made {len(calls)} of the calls "
                  f"{sorted(cap.keep[name])}")
            for idx, args, kwargs in calls:
                if kwargs.get("out_dtype") == torch.bfloat16:
                    rtol = 8e-3
                got, ref = kern(*args, **kwargs), plain(*args, **kwargs)
                got, ref = ((got, ref) if isinstance(got, tuple)
                            else ((got,), (ref,)))
                shape = "x".join(map(str, args[0].shape))
                errs[name] = max([errs.get(name, 0.0)] + [
                    assert_close(g, r, atol, rtol, f"{what} {name} call "
                                 f"{idx} [{shape}] output {i}")
                    for i, (g, r) in enumerate(zip(got, ref))])
    torch.cuda.synchronize()
    log(f"{what}: the path's own kernel calls vs plain, max|d| "
        + ", ".join(f"{n} {e:.3g} ({len(cap.calls[n])} calls at "
                    + "/".join("x".join(map(str, a[0].shape))
                               for _, a, _ in cap.calls[n][:1]) + ")"
                    for n, e in errs.items()))
    return errs


def hold_close(got, ref, atol, rtol, what):
    """assert_close, where NaN on both sides at the same cells counts as
    equal (a NaN-cost sample's cells, an overflowed gradient's); with no
    tolerance at all, equality."""
    nan = torch.isnan(ref)
    check(torch.equal(torch.isnan(got), nan), f"{what}: NaN cells differ "
          f"({int(torch.isnan(got).sum())} vs {int(nan.sum())})")
    got, ref = got.masked_fill(nan, 0), ref.masked_fill(nan, 0)
    if atol == 0 and rtol == 0:     # an exact row: equal, infinities too
        check(torch.equal(got, ref), f"{what}: not equal to the plain version")
        return 0.0
    return assert_close(got, ref, atol, rtol, what)


class Hold:
    """Shims over the fourteen operators' CUDA implementations (the
    ``<row>_cuda`` functions that ``mt.K.OPS`` names, where their modules
    define them), which every route reaches: a live wrapper, an exported
    artifact or a compiled graph. Each call on the card is held, as the
    route makes it, against the operator's CPU implementation (the plain
    version) on the same arguments (hold_close, at compare_captured's and
    compare_kernels' tolerances; 8e-3 relative on a bf16 output). The
    plain version runs before the call returns, so no operand is kept and
    no kernel launched beside the route's own: the counts stay the
    route's. calls[row] counts the held calls, errs[row] their max |d|."""

    def __init__(self, mt, what):
        self.mt, self.what, self.pairs = mt, what, plain_pairs(mt)
        self.errs, self.calls, self.saved = {}, {}, []

    def __enter__(self):
        self.saved = []
        for row, (cpu, module, attr) in self.mt.K.OPS.items():
            self._shim(module, attr, row, cpu)
        return self

    def _shim(self, module, name, row, cpu):
        fn = getattr(module, name)
        self.saved.append((module, name, fn))

        def shim(*args):
            out = fn(*args)
            with torch.no_grad():
                self._hold(row, cpu, args, out)
            return out

        setattr(module, name, shim)

    def _hold(self, row, cpu, args, out):
        ref = cpu(*args)
        if row == "stats_alpha_fused":     # the stacked [4, B, T, S1]
            outs = [(out[:3], ref[:3], 1e-5, 1e-6),
                    (out[3], ref[3], 1e-4, 1e-5)]
        elif row == "beta_grad_fused":
            outs = [(out[0], ref[0], 1e-6, 1e-4), (out[1], ref[1], 1e-4, 1e-5)]
        else:
            _, _, atol, rtol = self.pairs[row]
            out, ref = ((out, ref) if isinstance(out, tuple)
                        else ((out,), (ref,)))
            outs = [(g, r, atol, rtol) for g, r in zip(out, ref)]
        n = self.calls.get(row, 0)
        shape = "x".join(map(str, args[0].shape))
        err = max(hold_close(g, r, atol,
                             8e-3 if g.dtype == torch.bfloat16 else rtol,
                             f"{self.what} {row} call {n} [{shape}] output "
                             f"{i}")
                  for i, (g, r, atol, rtol) in enumerate(outs))
        self.errs[row] = max(self.errs.get(row, 0.0), err)
        self.calls[row] = n + 1

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def compare_captured_rows12(mt, cap, what,
                            names=("stats_alpha_fused", "beta_grad_fused")):
    """Rows 1-2's captured calls (a Capture on mt.fused keeping the same
    call indices of stats_alpha_fused and beta_grad_fused, or on mt.K of
    the operators' CUDA implementations, `names`) against their plain
    versions on the operands the path built (compare_kernels); returns
    each wrapper's max |d| over its captured calls."""
    sa, bg = cap.calls[names[0]], cap.calls[names[1]]
    for name, calls in cap.calls.items():
        check(len(calls) == len(cap.keep[name]), f"{what}: {name} made "
              f"{len(calls)} of the calls {sorted(cap.keep[name])}")
    # The wrapper takes grad_scale by keyword, the operator's CUDA
    # implementation by position (its 11th argument).
    scale = lambda args, kw: args[10] if len(args) > 10 else kw.get(
        "grad_scale")
    errs = [compare_kernels(
        mt, s_args, b_args[:10], scale(b_args, b_kw),
        f"{what} call {idx} [{'x'.join(map(str, s_args[0].shape))}]")
        for (idx, s_args, _), (_, b_args, b_kw) in zip(sa, bg)]
    return {"stats_alpha_fused": max(e[0] for e in errs),
            "beta_grad_fused": max(e[1] for e in errs)}


def rows12_capture(mt, call):
    """A Capture of rows 1-2's call `call` on the padded loss's path."""
    return Capture(mt.fused, {"stats_alpha_fused": {call},
                              "beta_grad_fused": {call}})


def fused_joint_capture(module, n_chunks, beta_name="beta_scan",
                        alpha_name="alpha_scan", stats=None):
    """A Capture of a fused-joint step's chunk kernels: the stats of the
    backward's first (the last chunk) and an interior chunk, the beta scan
    and grad_pass on those chunks, and the one alpha scan. `stats`: the
    (module, name) of the stats wrapper where it is not `module`'s
    softmax_stats (the vocab-sharded path's softmax_stats_partial)."""
    mid = n_chunks // 2
    chunk = {beta_name: {0, mid}, "grad_pass": {0, mid}, alpha_name: {0}}
    stats_mod, stats_name = stats or (module, "softmax_stats")
    keep_stats = {stats_name: {n_chunks, n_chunks + mid}}
    if stats_mod is module:
        return (Capture(module, {**keep_stats, **chunk}),)
    return Capture(stats_mod, keep_stats), Capture(module, chunk)


# --- inputs ---------------------------------------------------------------------

def kernel_operands(mt, logits, labels, ilen, slen, blank, bands=None):
    """Operands of both wrappers, from the plain glue and stats+alpha on
    the card."""
    K = mt.K
    _, t_max, s1, _ = logits.shape
    ilen, slen = ilen.to(torch.int32), slen.to(torch.int32)
    if bands is None:
        bands = mt.bands.default_bands(ilen, slen, t_max)
    lab, a_lo, a_hi, b_lo, b_hi = K.loss_prologue_plain(
        labels, ilen, slen, bands.min_s, bands.max_s, t_max, s1)
    sa_args = (logits, lab, a_lo, a_hi, ilen, slen, blank)
    denom, lpb, lpl, alphas = K.stats_alpha_fused_plain(*sa_args)
    ll, _ = K.loss_costs_plain(alphas, ilen, slen)
    lpbb, lplb, aprev, llb, bvirt = K.beta_operands_plain(
        lpb, lpl, alphas, ll, ilen, slen, b_lo, b_hi)
    scale = torch.linspace(-0.5, 2.0, logits.shape[0], device=logits.device)
    bg_args = (logits, denom, lpbb, lplb, aprev, ilen, llb, bvirt, lab, blank)
    return sa_args, bg_args, scale


def compare_kernels(mt, sa_args, bg_args, scale, what, valid=None):
    """Each wrapper against its plain version on the same inputs; the stats
    only on the `valid` cells where given (a row of +-inf logits has NaN
    stats in the kernel and -inf in torch.logsumexp; no valid cell reads
    them)."""
    K = mt.K
    bf16 = sa_args[0].dtype == torch.bfloat16
    got = K.stats_alpha_fused(*sa_args)
    ref = K.stats_alpha_fused_plain(*sa_args)
    pick = (lambda x: x) if valid is None else (lambda x: x[valid])
    errs_sa = [assert_close(pick(g), pick(r), 1e-5, 1e-6, f"{what} stats {n}")
               for n, g, r in zip(("denom", "lp_blank", "lp_label"), got, ref)]
    errs_sa.append(assert_close(got[3], ref[3], 1e-4, 1e-5, f"{what} alphas"))
    g_k, b_k = K.beta_grad_fused(*bg_args, grad_scale=scale)
    g_p, b_p = K.beta_grad_fused_plain(*bg_args, grad_scale=scale)
    check(g_k.dtype == sa_args[0].dtype, f"{what}: grads dtype {g_k.dtype}")
    errs_bg = [assert_close(g_k, g_p, 1e-6, 8e-3 if bf16 else 1e-4,
                            f"{what} grads"),
               assert_close(b_k, b_p, 1e-4, 1e-5, f"{what} betas")]
    torch.cuda.synchronize()
    log(f"kernel-vs-plain {what}: stats_alpha_fused max|d| "
        f"{[f'{e:.3g}' for e in errs_sa]} beta_grad_fused max|d| "
        f"{[f'{e:.3g}' for e in errs_bg]}")
    return max(errs_sa), max(errs_bg)


# --- phases ---------------------------------------------------------------------

def phase_build(mt):
    t0 = time.perf_counter()
    mt.build.build()
    for name in mt.build.SOURCES:
        mt.build.load(name)
    log(f"build: {len(mt.build.SOURCES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s")


# Edge cases of the persistent kernels of rows 1-2: (kind, B, T, S, V,
# blank, T_b, S_b). 16-byte rows at V = 1000 and 1024; the scalar path at
# V = 79 and 1030 and on a logits view one element off a 16-byte boundary;
# one-warp beta chains at S1 <= 32, strided chains at S1 = 41 and 1101; B =
# 2048 past the resident grid (T_b 2..4, S_b 0..2); T_b = 1 and S_b = 0; an
# infeasible sample (its band never reaches S_b); +-inf padding logits.
EDGE_CASES = (
    ("vec-v1000", 2, 50, 40, 1000, 3, (50, 44), (40, 31)),
    ("vec-v1024", 4, 9, 6, 1024, 0, (9, 9, 7, 6), (6, 4, 6, 0)),
    ("scalar-v79", 3, 17, 6, 79, 5, (17, 1, 12), (6, 0, 3)),
    ("scalar-v1030", 2, 6, 5, 1030, 2, (6, 5), (5, 2)),
    ("misaligned", 2, 8, 10, 1000, 0, (8, 8), (7, 2)),
    ("s1-1101", 1, 1200, 1100, 16, 3, (1200,), (1100,)),
    ("b2048", 2048, 4, 2, 16, 0, None, None),
    ("infeasible", 3, 12, 4, 20, 0, (12, 12, 9), (4, 3, 3)),
    ("inf-padding", 3, 12, 4, 1000, 0, (12, 7, 5), (4, 2, 1)),
)


def edge_operands(mt, case, dtype):
    """(sa_args, bg_args, scale, padding mask [B, T, S1], T_b, S_b) of an
    edge case."""
    kind, b, t, s, v, blank, ilen, slen = case
    if ilen is None:
        ilen = 2 + np.arange(b) % 3
        slen = np.minimum(np.arange(b) % 3, ilen)
    lg, lab, il, sl = make_inputs(b, t, s, v, blank=blank, dtype=dtype,
                                  seed=1, device=DEVICE)
    il = torch.as_tensor(np.asarray(ilen), dtype=torch.int32, device=DEVICE)
    sl = torch.as_tensor(np.asarray(slen), dtype=torch.int32, device=DEVICE)
    t_idx = torch.arange(t, device=DEVICE)[None, :, None]
    s_idx = torch.arange(s + 1, device=DEVICE)[None, None, :]
    pad = (t_idx >= il[:, None, None]) | (s_idx > sl[:, None, None])
    if kind == "misaligned":
        flat = torch.empty(lg.numel() + 1, dtype=dtype, device=DEVICE)
        flat[1:] = lg.reshape(-1)
        lg = flat[1:].view(lg.shape)
        check(lg.is_contiguous() and lg.data_ptr() % 16 != 0,
              "misaligned logits view")
    if kind == "inf-padding":
        lg[..., ::2][pad] = float("inf")
        lg[..., 1::2][pad] = float("-inf")
    bands = mt.bands.default_bands(il, sl, t)
    if kind == "infeasible":
        bands.max_s[2] = sl[2] - 1
    sa, bg, scale = kernel_operands(mt, lg, lab, il, sl, blank, bands)
    return sa, bg, scale, pad, il, sl


def probe_edge(mt, case, dtype):
    """Rows 1-2 against their plain versions on one edge case, one launch
    each, then the contracts the case probes; returns the max errors."""
    K = mt.K
    kind = case[0]
    sa, bg, scale, pad, ilen, slen = edge_operands(mt, case, dtype)
    valid = ~pad if kind == "inf-padding" else None
    before = dict(K.LAUNCHES)
    errs = compare_kernels(mt, sa, bg, scale, f"edge {kind} {dtype}",
                           valid=valid)
    check(K.LAUNCHES["stats_alpha_fused"] == before["stats_alpha_fused"] + 1
          and K.LAUNCHES["beta_grad_fused"] == before["beta_grad_fused"] + 1,
          f"edge {kind}: one launch a wrapper call")
    # Exact -inf from LSE(-inf, -inf): unreachable cells are -inf, not NaN.
    alphas = K.stats_alpha_fused(*sa)[3]
    grads, betas = K.beta_grad_fused(*bg, grad_scale=scale)
    torch.cuda.synchronize()
    for name, x in (("alphas", alphas), ("betas", betas)):
        check(not bool(torch.isnan(x).any()), f"edge {kind}: NaN in {name}")
        check(bool((x[pad] == float("-inf")).all()),
              f"edge {kind}: {name} not exactly -inf on padding cells")
    check(bool(torch.isfinite(grads.float()).all()),
          f"edge {kind}: grads finite")
    check(bool((grads[pad] == 0).all()),
          f"edge {kind}: gradient exactly zero on padding cells")
    if kind == "infeasible":
        ll = mt.reference._gather_ll(alphas, ilen, slen)
        check(bool(torch.isinf(ll[2])) and float(ll[2]) < 0
              and bool((grads[2] == 0).all()),
              f"edge {kind}: cost +inf and a zero gradient ({ll})")
    return errs


def probe_bf16_accumulation(mt):
    """bf16 logits are summed in f32 and the gradient is written in bf16:
    the bf16 kernels agree with the f32 kernels on the same (rounded)
    values at the f32 tolerances for the stats and the DP, and within one
    bf16 ulp (their f32 result rounded) for the gradient."""
    K = mt.K
    lg, lab, il, sl = make_inputs(4, 40, 12, 1000, dtype=torch.bfloat16,
                                  seed=2, t_range=(30, 40), s_range=(6, 12),
                                  device=DEVICE)
    sa16, bg16, scale = kernel_operands(mt, lg, lab, il, sl, 0)
    sa32 = (lg.float(),) + sa16[1:]
    bg32 = (lg.float(),) + bg16[1:]
    got16, got32 = K.stats_alpha_fused(*sa16), K.stats_alpha_fused(*sa32)
    errs = [assert_close(a, b, 1e-5, 1e-6, f"bf16 vs f32 stats {n}")
            for n, a, b in zip(("denom", "lp_blank", "lp_label"), got16[:3],
                               got32[:3])]
    errs.append(assert_close(got16[3], got32[3], 1e-4, 1e-5,
                             "bf16 vs f32 alphas"))
    g16, _ = K.beta_grad_fused(*bg16, grad_scale=scale)
    g32, _ = K.beta_grad_fused(*bg32, grad_scale=scale)
    check(g16.dtype == torch.bfloat16, f"bf16 grads dtype {g16.dtype}")
    errs.append(assert_close(g16, g32.to(torch.bfloat16), 1e-6, 8e-3,
                             "bf16 grads vs f32 grads rounded"))
    torch.cuda.synchronize()
    log(f"bf16 accumulates in f32, writes bf16: max|d| "
        f"{[f'{e:.3g}' for e in errs]}")


def phase_kernels(mt, main_inputs):
    """Kernel wrappers vs plain versions; returns the benchmark-shape errors."""
    for (b, t, s, v, blank) in ((3, 17, 6, 79, 5), (2, 391, 300, 79, 0),
                                (1, 1200, 1100, 16, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            lg, lab, il, sl = make_inputs(b, t, s, v, blank=blank,
                                          dtype=dtype, seed=1, t_range=(s, t),
                                          s_range=(0, s))
            compare_kernels(mt, *kernel_operands(mt, lg, lab, il, sl, blank),
                            f"({b},{t},{s},{v}) blank={blank} {dtype}")
    for case in EDGE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            probe_edge(mt, case, dtype)
    probe_bf16_accumulation(mt)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg, lab, il, sl = main_inputs
        ops = kernel_operands(mt, lg.to(dtype), lab, il, sl, 0)
        errs[dtype] = compare_kernels(mt, *ops, f"benchmark {dtype}")
        stats_bit_equality(mt, ops[0][0], ops[0][1], 0, f"benchmark {dtype}")
    return errs


def stats_bit_equality(mt, logits, lab, blank, what):
    """Rows 1, 3 and 7 on the same rows: stats_alpha_fused, softmax_stats,
    and softmax_stats_banded on a band of W = S1 whose windows mask nothing
    give denom, lp_blank and lp_label equal bit for bit (softmax_stats' raw
    lp_label where the id is valid). They share one reduction."""
    K, SK, BK = mt.K, mt.SK, mt.BK
    batch, t_max, s1, _ = logits.shape
    zeros = torch.zeros((batch, t_max), dtype=torch.int32, device=DEVICE)
    full = torch.full_like(zeros, s1)
    # Full lengths: every cell is live, as rows 3 and 7 read all.
    t_b = torch.full((batch,), t_max, dtype=torch.int32, device=DEVICE)
    row1 = K.stats_alpha_fused(logits, lab, zeros, full - 1, t_b,
                               torch.full_like(t_b, s1 - 1), blank)
    row3 = SK.softmax_stats(logits, lab, blank)
    lab3 = lab[:, None, :].expand(-1, t_max, -1).contiguous()
    row7 = BK.softmax_stats_banded(logits, lab3,
                                   (zeros, full, zeros, full - 1), blank)
    valid = (lab >= 0)[:, None, :].expand(-1, t_max, -1)
    for name, ref, others in (
            ("denom", row1[0], (row3[0], row7[0])),
            ("lp_blank", row1[1], (row3[1], row7[1], row7[3])),
            ("lp_label", row1[2], (row7[2], row7[4])),
            ("lp_label (valid ids)", row1[2][valid], (row3[2][valid],))):
        for i, got in enumerate(others):
            check(torch.equal(got, ref), f"{what}: {name} of the stats "
                  f"kernels differ (pair {i}) from stats_alpha_fused's")
    torch.cuda.synchronize()
    log(f"stats bit for bit {what} [{batch},{t_max},{s1},{logits.shape[3]}]"
        ": stats_alpha_fused == softmax_stats == softmax_stats_banded (W = "
        "S1) on denom, lp_blank, lp_label")


def phase_main(mt, main_inputs, weights, dtype):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    logits = logits.to(dtype)
    # The main path: the loss, a weighted sum, backward -- nothing else
    # between resetting the launch counts and reading them.
    K.reset_launch_counts()
    x = logits.detach().clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen)
    (costs * weights).sum().backward()
    costs, grads = costs.detach(), x.grad
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launched(K) == LOSS_STEP,
          f"main path {dtype} launches {launches}")
    check(grads.dtype == dtype, f"grad dtype {grads.dtype} != {dtype}")
    check(tuple(costs.shape) == (B,) and bool(torch.isfinite(costs).all()),
          "costs must be [B] and finite")
    check(bool(torch.isfinite(grads.float()).all()), "grads must be finite")

    x = logits.detach().clone().requires_grad_(True)
    ref_costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen,
                                       backend="reference")
    (ref_costs * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, ref_costs, 1e-4, 1e-5, f"main {dtype} costs")
    e_g = assert_close(grads, x.grad, 1e-6, 1.6e-2 if bf16 else 1e-3,
                       f"main {dtype} grads")
    log(f"main path {dtype}: launches {launches}; vs oracle costs max|d| "
        f"{e_c:.3g}, grads max|d| {e_g:.3g}; mean cost "
        f"{float(costs.mean()):.4f}")
    return launches, costs


def phase_cost_only(mt, main_inputs, costs_f32):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    K.reset_launch_counts()
    with torch.no_grad():
        costs = mt.monotonic_rnnt_loss(logits, labels, ilen, slen)
    torch.cuda.synchronize()
    check(launched(K) == COST_ONLY,
          f"cost-only launches {K.LAUNCHES}")
    check(torch.equal(costs, costs_f32), "cost-only costs differ from fwd+bwd")
    log(f"cost-only: launches {launched(K)}; costs equal to fwd+bwd")


def phase_goldens(mt, golden):
    conv = mt.convert

    def run(lg, lb, il, sl, **kw):
        lg, lb, il, sl = conv.loss_inputs_from_numpy(lg, lb, il, sl)
        x = lg.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, lb, il, sl, backend="cuda", **kw)
        costs.sum().backward()
        return costs.detach().cpu().numpy(), x.grad.cpu().numpy()

    costs, grads = run(*golden.readme_batch())
    check(abs(costs[0] - golden.README_LOSS) < 1e-4, f"README loss {costs}")
    check(np.abs(grads[0] - golden.README_GRADS).max() < 1e-2, "README grads")
    for t_pad, s_pad in ((None, None), (7, 5)):
        lg, lb, il, sl, exp_l, exp_g = golden.multibatch(t_pad, s_pad)
        costs, grads = run(lg, lb, il, sl)
        check(np.abs(costs - exp_l).max() < 1e-4, f"multibatch loss {costs}")
        check(np.abs(grads - exp_g).max() < 1e-2, "multibatch grads")
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            costs, grads = run(*golden.readme_batch(),
                               alignment=torch.from_numpy(align[None]).cuda(),
                               max_distance_from_alignment=shift)
            check(abs(costs[0] - expected) < 1e-4,
                  f"restricted loss shift={shift}: {costs} vs {expected}")
            check(np.isfinite(grads).all(), "restricted grads finite")
    log("goldens (deferred route): README -log 0.363 + gradient table, "
        "multibatch 0.39/0.363, restricted 0.2958/0.072/0.192/0.0672 ok")


def phase_restricted(mt, main_inputs, weights):
    """Returns the alignment and the CUDA route's (costs, grads) at +-8."""
    logits, labels, ilen, slen = main_inputs
    rng = np.random.RandomState(SEED + 7)
    align = torch.from_numpy(random_alignment(
        rng, ilen.cpu().numpy(), slen.cpu().numpy(), labels.cpu().numpy(),
        T)).cuda()
    out = {}
    for backend in ("cuda", "reference"):
        x = logits.detach().clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen, alignment=align,
                                       max_distance_from_alignment=ALIGN_SHIFT,
                                       backend=backend)
        (costs * weights).sum().backward()
        out[backend] = (costs.detach(), x.grad)
    check(bool(torch.isfinite(out["cuda"][0]).all()), "restricted costs finite")
    e_c = assert_close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5,
                       "restricted costs")
    e_g = assert_close(out["cuda"][1], out["reference"][1], 1e-6, 1e-3,
                       "restricted grads")
    log(f"alignment-restricted +-{ALIGN_SHIFT} at the benchmark shape: costs "
        f"max|d| {e_c:.3g}, grads max|d| {e_g:.3g}; mean cost "
        f"{float(out['cuda'][0].mean()):.4f}")

    # Infeasible sample: no aligned label, S_b = 3, exact path (shift 0).
    lg, lab, il, sl = make_inputs(3, 12, 4, 20, seed=3)
    sl[2] = 3
    align_inf = torch.zeros((3, 12), dtype=torch.int32, device="cuda")
    align_inf[0, :4] = lab[0]
    align_inf[1, 2:6] = lab[1]
    x = lg.clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, lab, il, sl, alignment=align_inf)
    costs.sum().backward()
    costs = costs.detach()
    check(bool(torch.isinf(costs[2])) and float(costs[2]) > 0,
          f"infeasible cost {costs}")
    check(bool((x.grad[2] == 0).all()) and bool(torch.isfinite(x.grad).all()),
          "infeasible sample: gradient exactly zero, all finite")

    # +-inf padding logits: same costs as finite padding, zero gradient there.
    lg, lab, il, sl = make_inputs(3, 12, 4, 20, seed=4, t_range=(5, 12),
                                  s_range=(1, 4))
    padded = lg.clone()
    for b in range(3):
        padded[b, int(il[b]):, :, ::2] = float("inf")
        padded[b, int(il[b]):, :, 1::2] = float("-inf")
        padded[b, :, int(sl[b]) + 1:, 3] = float("inf")
    c_fin = mt.monotonic_rnnt_loss(lg, lab, il, sl)
    x = padded.clone().requires_grad_(True)
    c_inf = mt.monotonic_rnnt_loss(x, lab, il, sl)
    c_inf.sum().backward()
    check(torch.equal(c_fin, c_inf), f"inf padding costs {c_inf} vs {c_fin}")
    t_idx = torch.arange(12, device="cuda")[None, :, None]
    s_idx = torch.arange(5, device="cuda")[None, None, :]
    pad = (t_idx >= il[:, None, None]) | (s_idx > sl[:, None, None])
    check(bool((x.grad[pad] == 0).all()) and bool(torch.isfinite(x.grad).all()),
          "inf padding: gradient exactly zero in padding, finite everywhere")
    log("infeasible sample: cost +inf, gradient zero; +-inf padding: costs "
        "unchanged, padding gradient zero")
    return align, out["cuda"]


def phase_train(mt, main_inputs):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    x = logits.detach().clone().requires_grad_(True)
    opt = torch.optim.SGD([x], lr=0.5)
    losses = []
    for step in range(5):
        K.reset_launch_counts()
        opt.zero_grad(set_to_none=True)
        loss = mt.monotonic_rnnt_loss(x, labels, ilen, slen).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        check(launched(K) == LOSS_STEP,
              f"train step {step} launches {K.LAUNCHES}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss must fall at every step: {losses}")
    log(f"5 SGD steps (lr 0.5) on a logits leaf: summed loss {losses}")


def rows12_alone_ms(mt, sa_args, bg_args, scale):
    """Rows 1 and 2's kernels alone on their wrappers' operands, each on its
    scratch zeroed outside the timed window: (stats_alpha ms, beta_grad ms,
    the coefficients [3, B, T, S1] that beta_grad wrote)."""
    K = mt.K
    lg, lab, a_lo, a_hi, il, sl, blank = sa_args
    n_b, n_t, n_s1 = lg.shape[:3]
    out4 = torch.empty((4, n_b, n_t, n_s1), device=DEVICE)
    betas = torch.empty((n_b, n_t, n_s1), device=DEVICE)
    coef = torch.empty((3, n_b, n_t, n_s1), device=DEVICE)
    sync_sa = torch.zeros(n_b * n_t + 2, dtype=torch.int32, device=DEVICE)
    sync_bg = torch.zeros(n_b + 2, dtype=torch.int32, device=DEVICE)
    grads = torch.empty_like(lg)
    _, denom, lpbb, lplb, aprev, il32, llb, bvirt, _, _ = bg_args
    t_sa = kernel_ms(lambda: K.launch_stats_alpha(
        lg, lab, a_lo, a_hi, il, sl, blank, out4, sync_sa), sync_sa)
    t_bg = kernel_ms(lambda: K.launch_beta_grad(
        lg, denom, lpbb, lplb, aprev, il32, llb, scale, bvirt, lab, blank,
        grads, betas, coef, sync_bg), sync_bg)
    return t_sa, t_bg, coef


def phase_timing(mt, main_inputs, weights, errs, main_launches):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    n_cells = logits.shape[0] * logits.shape[1] * logits.shape[2]
    small = n_cells * 4
    n_b, n_t, n_s1 = logits.shape[0], logits.shape[1], logits.shape[2]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg = logits.to(dtype)
        isz = lg.element_size()
        big = lg.numel() * isz
        sa_args, bg_args, _ = kernel_operands(mt, lg, labels, ilen, slen, 0)
        scale = weights
        # The wrappers' times less the kernels' alone are host time.
        t_sa, t_bg, coef = rows12_alone_ms(mt, sa_args, bg_args, scale)
        t_zero_sa = cuda_ms(lambda: torch.zeros(n_b * n_t + 2,
                                                dtype=torch.int32,
                                                device="cuda"))
        t_zero_bg = cuda_ms(lambda: torch.zeros(n_b + 2, dtype=torch.int32,
                                                device="cuda"))
        # The gradient tiles read only rows whose coefficients are not all 0.
        occ, cb, cl = coef
        live = int(((occ != 0) | (cb != 0) | (cl != 0)).sum())
        read_live = live * lg.shape[3] * isz
        # Row 1 reads the live cells t < T'_b, s <= S_b only.
        live_sa = int(K.live_cells(*sa_args[4:6], n_t, n_s1).sum())
        sa = {
            "ms": cuda_ms(lambda: K.stats_alpha_fused(*sa_args)),
            "plain_ms": cuda_ms(lambda: K.stats_alpha_fused_plain(*sa_args)),
            "library_ms": cuda_ms(lambda: torch.logsumexp(lg, dim=-1)),
            "bound": bound_ms(live_sa * lg.shape[3] * isz + n_b * n_s1 * 4
                              + 2 * n_b * n_t * 4 + 2 * n_b * 4 + 4 * small,
                              4 * live_sa * lg.shape[3]),
            "live_rows": live_sa, "rows": n_cells,
            "kernel_ms": t_sa,
            "parts": [
                {"name": "mrnnt_stats_alpha_kernel", "ms": t_sa},
                {"name": "scratch zeros (int32 [B*T+2])", "ms": t_zero_sa},
            ],
        }
        bg = {
            "ms": cuda_ms(lambda: K.beta_grad_fused(*bg_args,
                                                    grad_scale=scale)),
            "plain_ms": cuda_ms(lambda: K.beta_grad_fused_plain(
                *bg_args, grad_scale=scale)),
            "library_ms": cuda_ms(lambda: torch.softmax(lg, dim=-1)),
            "bound": bound_ms(read_live + big + 5 * small + 2 * n_b * n_s1 * 4
                              + 3 * n_b * 4, 6 * live * lg.shape[3]),
            "live_rows": live, "rows": n_cells,
            "kernel_ms": t_bg,
            "parts": [
                {"name": "mrnnt_beta_grad_kernel", "ms": t_bg},
                {"name": "scratch zeros (int32 [B+2])", "ms": t_zero_bg},
            ],
        }
        for row in (sa, bg):
            row["host_ms"] = row["ms"] - row["kernel_ms"]
            row["parts"][0]["bound_ms"] = row["bound"][0]
        lg_leaf = lg.detach().clone().requires_grad_(True)

        def fwd_bwd():
            costs = mt.monotonic_rnnt_loss(lg_leaf, labels, ilen, slen)
            (costs * weights).sum().backward()
            lg_leaf.grad = None

        def cost_only():
            with torch.no_grad():
                mt.monotonic_rnnt_loss(lg, labels, ilen, slen)

        e2e = {"fwd_bwd_ms": cuda_ms(fwd_bwd), "cost_only_ms": cuda_ms(cost_only)}
        rows[dtype] = (sa, bg, e2e)
        log(f"timing {dtype}: stats_alpha_fused {sa['ms']:.4f} ms (bound "
            f"{sa['bound'][0]:.4f}, plain {sa['plain_ms']:.4f}, logsumexp "
            f"{sa['library_ms']:.4f}); beta_grad_fused {bg['ms']:.4f} ms (bound "
            f"{bg['bound'][0]:.4f}, plain {bg['plain_ms']:.4f}, softmax "
            f"{bg['library_ms']:.4f}); kernels alone: stats_alpha "
            f"{sa['kernel_ms']:.4f} ms, beta_grad {bg['kernel_ms']:.4f} ms; "
            f"wrapper minus kernel (host): stats_alpha {sa['host_ms']:.4f} "
            f"ms, beta_grad {bg['host_ms']:.4f} ms; parts "
            + ", ".join(f"{p['name']} {p['ms']:.4f} ms"
                        for p in sa["parts"] + bg["parts"])
            + f"; live rows {live}/{n_cells}; loss fwd+bwd "
            f"{e2e['fwd_bwd_ms']:.4f} ms, cost-only {e2e['cost_only_ms']:.4f} ms")
        del coef, sa_args, bg_args, lg_leaf
        torch.cuda.empty_cache()

    kernels = []
    spec = (("stats_alpha_fused", "stats_alpha.cu", 586, 0),
            ("beta_grad_fused", "beta_grad.cu", 712, 1))
    for name, src, line, i in spec:
        f32, b16 = rows[torch.float32][i], rows[torch.bfloat16][i]
        entry = {
            "name": name, "route": "cuda",
            "source": f"monotonic_rnnt_tpu_torch/csrc/{src}",
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/kernels.py:{line}",
            "launches": main_launches[name],
            "max_abs_err": errs[torch.float32][i],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
            "library_ms": f32["library_ms"],
            "status": "redesigned", "dtype": "float32",
            "kernel_ms": f32["kernel_ms"], "host_ms": f32["host_ms"],
            "parts": f32["parts"],
            "bf16": {"max_abs_err": errs[torch.bfloat16][i], "ms": b16["ms"],
                     "plain_ms": b16["plain_ms"], "bound_ms": b16["bound"][0],
                     "library_ms": b16["library_ms"],
                     "kernel_ms": b16["kernel_ms"], "host_ms": b16["host_ms"],
                     "parts": b16["parts"]},
        }
        if "live_rows" in f32:
            entry["live_rows"] = f32["live_rows"]
            entry["rows"] = f32["rows"]
        if name == "stats_alpha_fused":
            entry["note"] = SHARED_REDUCTION
        kernels.append(entry)
    e2e = {str(d).removeprefix("torch."): rows[d][2] for d in rows}
    return kernels, e2e


def glue_timing(mt, main_inputs):
    """The glue kernels around rows 1-2 (csrc/loss_glue.cu) at the main
    path's lattice, f32: one wrapper call from an idle card (ms), calls
    queued back to back (queued_ms), the kernel alone in a CUDA graph
    (kernel_ms), and the plain version (plain_ms: the torch glue it
    replaced)."""
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    _, t_max, s1, _ = logits.shape
    il, sl = ilen.to(torch.int32), slen.to(torch.int32)
    bands = mt.bands.default_bands(il, sl, t_max)
    pro_args = (labels, il, sl, bands.min_s, bands.max_s, t_max, s1)
    lab, a_lo, a_hi, b_lo, b_hi = K.loss_prologue_plain(*pro_args)
    _, lpb, lpl, alphas = K.stats_alpha_fused_plain(logits, lab, a_lo, a_hi,
                                                    il, sl, 0)
    ll, _ = K.loss_costs_plain(alphas, il, sl)
    calls = {"loss_prologue": pro_args, "loss_costs": (alphas, il, sl),
             "beta_operands": (lpb, lpl, alphas, ll, il, sl, b_lo, b_hi)}
    figs = {}
    for name, args in calls.items():
        call = lambda f=getattr(K, name), a=args: f(*a)
        plain = lambda f=getattr(K, name + "_plain"), a=args: f(*a)
        figs[name] = {"ms": cuda_ms(call), "queued_ms": queued_ms(call),
                      "kernel_ms": graph_ms(call), "plain_ms": cuda_ms(plain)}
    log(f"glue kernels at B,T,S,V={B},{T},{S},{V}: {json.dumps(figs)}")
    return figs


# --- the banded path ------------------------------------------------------------

def leaf(x, dtype):
    """A fresh leaf copy in `dtype` (x.to(x.dtype) would be x itself)."""
    return x.detach().to(dtype).clone().requires_grad_(True)


def banded_operands(mt, case, weights, dtype):
    """Every banded kernel's operands on the case, from the plain versions."""
    bd, BK = mt.bands, mt.BK
    x = case["logits_band"].to(dtype)
    labels, ilen, slen = case["labels"], case["ilen"], case["slen"]
    layout, bands = case["layout"], case["bands"]
    t_max, s1 = x.shape[1], labels.shape[1] + 1
    lab = mt.banded.band_labels(labels, slen, layout, s1).contiguous()
    rel = tuple(r.contiguous() for r in bd.band_relative_bounds(
        ilen, slen, bands, layout, t_max, s1))
    stats_args = (x, lab, rel, 0)
    denom, lpba, lpla, lpbb, lplb = BK.softmax_stats_banded_plain(*stats_args)
    scan_args = (lpba, lpla, layout.d.contiguous(), lpbb, lplb,
                 layout.d_next.contiguous(), ilen,
                 bd.band_virtual_next_rows(layout, slen).contiguous())
    alphas, betas = BK.fwdbwd_scan_banded_plain(*scan_args)
    ll = bd.band_final_slot(alphas, layout, ilen, slen)
    sc = weights[:, None, None]
    occ, cb, cl = (c * sc for c in mt.banded.band_occupancy_coefficients(
        alphas, betas, ll, ilen, slen, layout))
    grad_args = (x, denom, occ.contiguous(), cb.contiguous(), cl.contiguous(),
                 lab, 0)
    return {"stats": stats_args, "scan": scan_args, "grad": grad_args}


def compare_banded_kernels(mt, ops, what):
    """The four banded wrappers against their plain versions, same inputs.

    Returns each kernel's max |d|."""
    BK, K = mt.BK, mt.K
    errs = {}
    for with_beta in (True, False):
        got = BK.softmax_stats_banded(*ops["stats"], with_beta=with_beta)
        ref = BK.softmax_stats_banded_plain(*ops["stats"], with_beta=with_beta)
        check(len(got) == len(ref), f"{what} stats outputs")
        errs["softmax_stats_banded"] = max(
            [errs.get("softmax_stats_banded", 0.0)]
            + [assert_close(g, r, 1e-5, 1e-6, f"{what} stats {i} beta="
                            f"{with_beta}") for i, (g, r) in
               enumerate(zip(got, ref))])
    # Rows 3 and 7 on the band's rows: equal bits where the windows add 0.
    x, lab_band, (ra_lo, ra_hi, _, _), blank = ops["stats"]
    row3 = mt.SK.softmax_stats(x, lab_band, blank)
    row7 = BK.softmax_stats_banded(*ops["stats"], with_beta=False)
    w_idx = torch.arange(x.shape[2], device=x.device)
    in_a = (w_idx >= ra_lo[..., None]) & (w_idx <= ra_hi[..., None])
    in_l = ((w_idx >= ra_lo[..., None] - 1) & (w_idx <= ra_hi[..., None] - 1)
            & (lab_band >= 0))
    for name, got, ref in (("denom", row3[0], row7[0]),
                           ("lp_blank", row3[1][in_a], row7[1][in_a]),
                           ("lp_label", row3[2][in_l], row7[2][in_l])):
        check(torch.equal(got, ref), f"{what}: softmax_stats and "
              f"softmax_stats_banded {name} differ on the band's rows")
    log(f"{what}: softmax_stats == softmax_stats_banded bit for bit on the "
        f"band's rows (denom; lp_blank on {int(in_a.sum())}, lp_label on "
        f"{int(in_l.sum())} unmasked cells)")
    got = BK.fwdbwd_scan_banded(*ops["scan"])
    ref = BK.fwdbwd_scan_banded_plain(*ops["scan"])
    errs["fwdbwd_scan_banded"] = max(
        assert_close(g, r, 1e-4, 1e-5, f"{what} {n}")
        for n, g, r in zip(("alphas", "betas"), got, ref))
    got_a = BK.alpha_scan_banded(*ops["scan"][:3])
    errs["alpha_scan_banded"] = assert_close(got_a, ref[0], 1e-4, 1e-5,
                                             f"{what} alpha_scan")
    check(torch.equal(got_a, got[0]), f"{what}: the two alpha scans differ")
    x = ops["grad"][0]
    bf16 = x.dtype == torch.bfloat16
    got = K.grad_pass(*ops["grad"], out_dtype=x.dtype)
    ref = K.grad_pass_plain(*ops["grad"], out_dtype=x.dtype)
    check(got.dtype == x.dtype, f"{what}: grad_pass dtype {got.dtype}")
    errs["grad_pass"] = assert_close(got, ref, 1e-6, 8e-3 if bf16 else 1e-4,
                                     f"{what} grad_pass")
    # The split path's [B, S1] labels: one id per slot for every t.
    lab2 = ops["grad"][5][:, 0, :].contiguous()
    args2 = ops["grad"][:5] + (lab2, 0)
    assert_close(K.grad_pass(*args2, out_dtype=torch.float32),
                 K.grad_pass_plain(*args2, out_dtype=torch.float32), 1e-6,
                 1e-4, f"{what} grad_pass [B,S1] labels")
    torch.cuda.synchronize()
    log(f"banded kernel-vs-plain {what}: max|d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def phase_banded_main(mt, case, weights, dtype):
    """The banded main path: a training step (loss, weighted sum, backward),
    then a cost-only call; counts reset once before, read after each part.
    Costs and gradients against the banded oracle on the card."""
    K = mt.K
    args = (case["labels"], case["ilen"], case["slen"])
    x = leaf(case["logits_band"], dtype)
    K.reset_launch_counts()
    costs = mt.monotonic_rnnt_loss_banded(x, *args, bands=case["bands"])
    torch.cuda.synchronize()
    after_fwd = launched(K)
    (costs * weights).sum().backward()
    torch.cuda.synchronize()
    after_bwd = launched(K)
    with torch.no_grad():
        costs_only = mt.monotonic_rnnt_loss_banded(x, *args,
                                                   bands=case["bands"])
    torch.cuda.synchronize()
    launches = launched(K)
    costs, grads = costs.detach(), x.grad
    check(after_fwd == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1},
          f"banded forward {dtype} launches {after_fwd}")
    check(after_bwd == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1,
                        "grad_pass": 1},
          f"banded backward {dtype} launches {after_bwd}")
    check(launches == {"softmax_stats_banded": 2, "fwdbwd_scan_banded": 1,
                       "grad_pass": 1, "alpha_scan_banded": 1},
          f"banded cost-only {dtype} launches {launches}")
    check(torch.equal(costs_only, costs), "banded cost-only costs differ")
    check(grads.dtype == dtype, f"banded grad dtype {grads.dtype}")
    check(tuple(costs.shape) == (x.shape[0],)
          and bool(torch.isfinite(costs).all()), "banded costs finite, [B]")
    check(bool(torch.isfinite(grads.float()).all()), "banded grads finite")

    xr = leaf(case["logits_band"], dtype)
    ref = mt.monotonic_rnnt_loss_banded(xr, *args, bands=case["bands"],
                                        backend="reference")
    (ref * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, ref, 1e-4, 1e-5, f"banded {dtype} costs")
    g_tol = (1e-6, 1.6e-2 if bf16 else 1e-3)
    e_g = assert_close(grads, xr.grad, *g_tol,
                       f"banded {dtype} grads vs oracle")
    log(f"banded main path {dtype}: launches fwd {after_fwd}, +bwd "
        f"{after_bwd}, +cost-only {launches}; vs banded oracle costs max|d| "
        f"{e_c:.3g}, grads max|d| {e_g:.3g} (at "
        f"{worst_share(grads, xr.grad, *g_tol):.3g} of the tolerance); costs "
        f"{costs.tolist()}")
    return launches, costs, grads


def band_stats_drift(mt, ops):
    """Where the f32 banded gradients part from the oracle's: row 7's denom
    beside torch.logsumexp's on the rows inside the alpha window (the share
    equal bit for bit; each one's mean and largest error against the
    float64 value, in f32 ulps), and the alphas and betas that the banded
    scan kernel computes from row 7's stats and from the oracle's (cells
    that differ, by how many ulps of alpha, and alpha's largest ulp)."""
    BK = mt.BK
    x = ops["stats"][0]
    got = BK.softmax_stats_banded(*ops["stats"])
    ref = BK.softmax_stats_banded_plain(*ops["stats"])
    live = torch.isfinite(ref[1])
    truth = -torch.logsumexp(x[live].double(), dim=-1)
    spacing = ulps(truth).double()

    def err(d):
        e = (d[live].double() - truth) / spacing
        return f"mean {float(e.mean()):+.4f}, max {float(e.abs().max()):.3f}"

    scan = ops["scan"]
    mine = BK.fwdbwd_scan_banded(got[1], got[2], scan[2], got[3], got[4],
                                 *scan[5:])
    oracle = BK.fwdbwd_scan_banded(*scan)
    parts = []
    for name, a, b in zip(("alphas", "betas"), mine, oracle):
        fin = torch.isfinite(b)
        diff = (a != b) & fin
        n_ulp = ((a - b).abs()[diff] / ulps(b[diff])).max() if bool(
            diff.any()) else torch.tensor(0.0)
        parts.append(f"{name} differ in {int(diff.sum())} of {int(fin.sum())}"
                     f" cells, by <= {float(n_ulp):.3g} ulp")
    a_max = float(oracle[0][torch.isfinite(oracle[0])].abs().max())
    equal = float((got[0][live] == ref[0][live]).float().mean())
    torch.cuda.synchronize()
    log(f"banded f32 stats drift: softmax_stats_banded denom == "
        f"torch.logsumexp's on {equal:.4f} of {int(live.sum())} rows in the "
        f"alpha window; vs float64 "
        f"(ulps): kernel {err(got[0])}, logsumexp {err(ref[0])}; scan on "
        f"its stats vs the oracle's: {'; '.join(parts)}; |alpha| <= "
        f"{a_max:.5g} (ulp {float(ulps(torch.tensor(a_max))):.3g})")


def phase_banded_vs_padded(mt, case, weights, dtype, costs, grads):
    """Check 3: the padded path's restricted loss on the full lattice."""
    bd = mt.bands
    args = (case["labels"], case["ilen"], case["slen"])
    s1 = case["labels"].shape[1] + 1
    check(bool(bd.band_layout_is_exact(*args[1:], case["bands"],
                                       case["logits"].shape[1], s1,
                                       case["w"]).all()),
          "band_layout_is_exact must hold at the acceptance case")
    x = leaf(case["logits"], dtype)
    full = mt.monotonic_rnnt_loss(x, *args, bands=case["bands"])
    (full * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, full, 1e-4, 1e-5, f"banded vs padded {dtype}")
    e_g = assert_close(bd.unpack_band(grads, case["layout"], s1), x.grad,
                       1e-6, 8e-3 if bf16 else 1e-4,
                       f"unpacked banded grads vs padded {dtype}")
    log(f"banded vs padded restricted [{x.shape[0]},{x.shape[1]},{s1},"
        f"{x.shape[3]}] {dtype}: costs max|d| {e_c:.3g}, unpacked grads "
        f"max|d| {e_g:.3g}")


def phase_banded_goldens(mt, golden):
    conv, bd = mt.convert, mt.bands
    lg, lb, il, sl = conv.loss_inputs_from_numpy(*golden.readme_batch(),
                                                 device=DEVICE)
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            bands = bd.bands_from_alignment(
                torch.from_numpy(align[None]).to(DEVICE), il, sl, shift, 0)
            w = bd.suggested_band_width(il, sl, bands, 4, 3)
            layout = bd.compute_band_layout(il, sl, bands, 4, 3, w)
            x = bd.pack_band(lg, layout).requires_grad_(True)
            costs = mt.monotonic_rnnt_loss_banded(x, lb, il, sl, bands=bands,
                                                  backend="cuda")
            costs.sum().backward()
            costs = costs.detach()
            check(abs(float(costs[0]) - expected) < 1e-4,
                  f"banded golden shift={shift}: {costs} vs {expected}")
            check(bool(torch.isfinite(x.grad).all()), "banded golden grads")
    log("banded goldens: restricted 0.363/0.2958/0.072/0.192/0.0672 ok")


def phase_banded_train(mt, case):
    K = mt.K
    args = (case["labels"], case["ilen"], case["slen"])
    x = leaf(case["logits_band"], torch.float32)
    opt = torch.optim.SGD([x], lr=0.5)
    losses = []
    for step in range(5):
        K.reset_launch_counts()
        opt.zero_grad(set_to_none=True)
        loss = mt.monotonic_rnnt_loss_banded(x, *args,
                                             bands=case["bands"]).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        check(launched(K) == {"softmax_stats_banded": 1,
                              "fwdbwd_scan_banded": 1, "grad_pass": 1},
              f"banded train step {step} launches {K.LAUNCHES}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"banded loss must fall at every step: {losses}")
    log(f"5 SGD steps (lr 0.5) on logits_band: summed loss {losses}")


def phase_banded_restricted(mt, main_inputs, weights, align, padded):
    """Check 7: the banded loss at the padded benchmark lattice, +-8 band,
    variable T_b and S_b, against phase_restricted's padded result."""
    bd = mt.bands
    logits, labels, ilen, slen = main_inputs
    t_max, s1 = logits.shape[1], logits.shape[2]
    bands = bd.bands_from_alignment(align, ilen, slen, ALIGN_SHIFT, 0)
    w = bd.suggested_band_width(ilen, slen, bands, t_max, s1)
    check(bool(bd.band_layout_is_exact(ilen, slen, bands, t_max, s1,
                                       w).all()), "restricted layout exact")
    layout = bd.compute_band_layout(ilen, slen, bands, t_max, s1, w)
    x = leaf(bd.pack_band(logits, layout), torch.float32)
    costs = mt.monotonic_rnnt_loss_banded(x, labels, ilen, slen, bands=bands)
    (costs * weights).sum().backward()
    e_c = assert_close(costs.detach(), padded[0], 1e-4, 1e-5,
                       "banded restricted costs")
    e_g = assert_close(bd.unpack_band(x.grad, layout, s1), padded[1], 1e-6,
                       1e-4, "banded restricted unpacked grads")
    log(f"banded at the benchmark lattice, +-{ALIGN_SHIFT} (W={w} of "
        f"S1={s1}, T_b {int(ilen.min())}-{int(ilen.max())}): vs padded costs "
        f"max|d| {e_c:.3g}, unpacked grads max|d| {e_g:.3g}")


def phase_banded_timing(mt, case, weights, errs, launches):
    """Each banded kernel against its bound, plain version and yardstick,
    and the banded loss beside the padded loss on the same lattice."""
    K, BK = mt.K, mt.BK
    args = (case["labels"], case["ilen"], case["slen"])
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        ops = banded_operands(mt, case, weights, dtype)
        x = ops["stats"][0]
        n_b, n_t, n_w, n_v = x.shape
        isz = x.element_size()
        big = x.numel() * isz
        small = n_b * n_t * n_w * 4          # one [B, T, W] f32 or int32
        bt = n_b * n_t * 4                   # one [B, T] int32
        occ, cb, cl = ops["grad"][2:5]
        live = int(((occ != 0) | (cb != 0) | (cl != 0)).sum())
        scan = ops["scan"]
        timed = {
            "softmax_stats_banded": (
                lambda: BK.softmax_stats_banded(*ops["stats"]),
                lambda: BK.softmax_stats_banded_plain(*ops["stats"]),
                lambda: torch.logsumexp(x, dim=-1),
                bound_ms(big + small + 4 * bt + 5 * small, 4 * x.numel())),
            "fwdbwd_scan_banded": (
                lambda: BK.fwdbwd_scan_banded(*scan),
                lambda: BK.fwdbwd_scan_banded_plain(*scan), None,
                bound_ms(5 * small + 2 * bt + n_b * 4 + 2 * small,
                         2 * 8 * n_b * n_t * n_w)),
            "alpha_scan_banded": (
                lambda: BK.alpha_scan_banded(*scan[:3]),
                lambda: BK.alpha_scan_banded_plain(*scan[:3]), None,
                bound_ms(3 * small + bt, 8 * n_b * n_t * n_w)),
            "grad_pass": (
                lambda: K.grad_pass(*ops["grad"], out_dtype=x.dtype),
                lambda: K.grad_pass_plain(*ops["grad"], out_dtype=x.dtype),
                lambda: torch.softmax(x, dim=-1),
                bound_ms(live * n_v * isz + big + 5 * small,
                         6 * live * n_v)),
        }
        out = {}
        for name, (kern, plain, lib, bound) in timed.items():
            out[name] = {
                "ms": cuda_ms(kern),
                # The scans' plain versions loop over T in Python: once.
                "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                "library_ms": cuda_ms(lib) if lib else None,
                "bound": bound}
        out["grad_pass"].update(live_rows=live, rows=n_b * n_t * n_w,
                                queued_ms=queued_ms(timed["grad_pass"][0]))
        out["softmax_stats_banded"]["queued_ms"] = queued_ms(
            timed["softmax_stats_banded"][0])
        if x.is_cuda:   # row 7's persistent grid and its ring, as launched
            shape = BK.stats_banded_launch_shape(x)
            out["softmax_stats_banded"]["launch"] = shape
            log(f"softmax_stats_banded launch {dtype}: grid {shape['grid']} "
                f"x {shape['threads']} threads, {shape['stages']} stages of "
                f"{shape['stage_bytes']} bytes ({shape['smem_bytes']} bytes "
                f"of shared memory), {shape['unit_rows']} rows a stage, "
                f"{shape['stages_per_unit']} stage(s) a row, "
                f"{shape['load_bytes']}-byte loads, {shape['row_lanes']} "
                "lanes a row")
        for name in ("fwdbwd_scan_banded", "alpha_scan_banded"):
            out[name]["ns_per_step"] = out[name]["ms"] * 1e6 / n_t
            out[name]["queued_ms"] = queued_ms(timed[name][0])
            out[name]["queued_ns_per_step"] = (out[name]["queued_ms"] * 1e6
                                               / n_t)
        # Row 8 again with the second sample at T/2, so that its beta chain
        # reads the virtual row on half its steps; held against the plain
        # version on these operands too.
        short = (scan[:6] + (torch.tensor([n_t, n_t // 2], dtype=torch.int32,
                                          device=DEVICE),) + scan[7:])
        got, ref = BK.fwdbwd_scan_banded(*short), BK.fwdbwd_scan_banded_plain(
            *short)
        err = max(assert_close(g, r, 1e-4, 1e-5, f"banded {dtype} T_b = "
                               f"[{n_t}, {n_t // 2}] {n}")
                  for n, g, r in zip(("alphas", "betas"), got, ref))
        errs[dtype]["fwdbwd_scan_banded"] = max(
            errs[dtype]["fwdbwd_scan_banded"], err)
        ms = cuda_ms(lambda: BK.fwdbwd_scan_banded(*short))
        out["fwdbwd_scan_banded"]["short_second_sample"] = {
            "input_lengths": [n_t, n_t // 2], "ms": ms,
            "ns_per_step": ms * 1e6 / n_t, "max_abs_err": err}
        lg_leaf = leaf(x, dtype)
        full = case["logits"].to(dtype)
        full_leaf = leaf(full, dtype)

        def fwd_bwd(leaf, fn):
            costs = fn(leaf, *args, bands=case["bands"])
            (costs * weights).sum().backward()
            leaf.grad = None

        def cost_only(inp, fn):
            with torch.no_grad():
                fn(inp, *args, bands=case["bands"])

        band_fn, pad_fn = mt.monotonic_rnnt_loss_banded, mt.monotonic_rnnt_loss
        e2e = {"banded_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(lg_leaf,
                                                            band_fn)),
               "banded_cost_only_ms": cuda_ms(lambda: cost_only(x, band_fn)),
               "padded_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(full_leaf,
                                                            pad_fn), reps=5),
               "padded_cost_only_ms": cuda_ms(lambda: cost_only(full, pad_fn),
                                              reps=5)}
        rows[dtype] = (out, e2e)
        log(f"banded timing {dtype}: " + "; ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound'][0]:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']})"
            for n, r in out.items())
            + f"; live rows {live}/{n_b * n_t * n_w}; " + json.dumps(e2e))
        log(f"banded scans {dtype}, ns per dependent step (T={n_t}), one "
            "call / queued: " + ", ".join(
                f"{n} {out[n]['ns_per_step']:.1f} / "
                f"{out[n]['queued_ns_per_step']:.1f}"
                for n in ("fwdbwd_scan_banded", "alpha_scan_banded"))
            + f"; fwdbwd_scan_banded with T_b = [{n_t}, {n_t // 2}] "
            + "%.4f ms, %.1f ns" % tuple(
                out["fwdbwd_scan_banded"]["short_second_sample"][k]
                for k in ("ms", "ns_per_step")))
        del ops, lg_leaf, full, full_leaf
        torch.cuda.empty_cache()

    spec = (("softmax_stats_banded", 335), ("fwdbwd_scan_banded", 1219),
            ("alpha_scan_banded", 1271), ("grad_pass", 1322))
    kernels = []
    for name, line in spec:
        f32, b16 = rows[torch.float32][0][name], rows[torch.bfloat16][0][name]
        entry = {
            "name": name, "route": "cuda",
            "source": ("monotonic_rnnt_tpu_torch/csrc/grad_pass.cu"
                       if name == "grad_pass" else
                       "monotonic_rnnt_tpu_torch/csrc/banded.cu"),
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/kernels.py:{line}",
            "launches": launches.get(name, 0),
            "max_abs_err": errs[torch.float32][name],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
            "library_ms": f32["library_ms"],
            "status": ("redesigned" if name in ("softmax_stats_banded",
                                                "fwdbwd_scan_banded",
                                                "grad_pass") else "ported"),
            **({"note": SHARED_REDUCTION}
               if name == "softmax_stats_banded" else {}),
            "dtype": "float32",
            "shape": "B=%d,T=%d,W=%d,V=%d" % tuple(case["logits_band"].shape),
            "bf16": {"max_abs_err": errs[torch.bfloat16][name],
                     "ms": b16["ms"], "plain_ms": b16["plain_ms"],
                     "bound_ms": b16["bound"][0],
                     "library_ms": b16["library_ms"]},
        }
        if f32["library_ms"] is None:
            entry["library_note"] = "no single PyTorch call computes a scan"
        if "live_rows" in f32:
            entry.update(live_rows=f32["live_rows"], rows=f32["rows"])
        for key in ("ns_per_step", "queued_ms", "queued_ns_per_step",
                    "short_second_sample", "launch"):
            if key in f32:
                entry[key] = f32[key]
                entry["bf16"][key] = b16[key]
        kernels.append(entry)
    e2e = {str(d).removeprefix("torch."): rows[d][1] for d in rows}
    return kernels, e2e


def run_banded(mt, golden, main_inputs, weights, restricted):
    """Every banded phase; returns the kernels' JSON entries, the e2e times,
    the case's packed band tensor with its costs (for run_sharded) and the
    case itself (for run_alignment)."""
    b, t, s, v = BANDED_CASE
    t0 = time.perf_counter()
    case = banded_case(b, t, s, v, BAND_SHIFT, device=DEVICE)
    log(f"banded case B={b},T={t},S={s},V={v}, shift {BAND_SHIFT}: band width "
        f"W={case['w']} (required {case['w_req']}) of S+1={s + 1}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    band_w = torch.tensor([-0.5, 2.0], device=DEVICE)   # one negative
    errs, launches, costs_by_dtype = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        ops = banded_operands(mt, case, band_w, dtype)
        errs[dtype] = compare_banded_kernels(mt, ops, f"banded {dtype}")
        if dtype == torch.float32:
            band_stats_drift(mt, ops)
        del ops
        launched_d, costs, grads = phase_banded_main(mt, case, band_w, dtype)
        costs_by_dtype[str(dtype)] = costs
        if dtype == torch.float32:
            launches = launched_d
        phase_banded_vs_padded(mt, case, band_w, dtype, costs, grads)
        del grads
        torch.cuda.empty_cache()
    phase_banded_goldens(mt, golden)
    phase_banded_train(mt, case)
    phase_banded_restricted(mt, main_inputs, weights, *restricted)
    phase_split_long(mt, case)
    kernels, e2e = phase_banded_timing(mt, case, band_w, errs, launches)
    # What the sharded phase's ranks read: the packed band tensor, not the
    # 2.6 GB lattice it was packed from.
    keep = {"logits_band": case["logits_band"], "labels": case["labels"],
            "ilen": case["ilen"], "slen": case["slen"],
            "band_min": case["bands"].min_s, "band_max": case["bands"].max_s,
            "costs": costs_by_dtype}
    return kernels, e2e, keep, case


# --- the split kernels ----------------------------------------------------------

def split_operands(mt, logits, labels, ilen, slen, blank=0, bands=None):
    """Every split kernel's operands, from the plain stats on the card."""
    SK = mt.SK
    _, t_max, s1, _ = logits.shape
    ilen, slen = ilen.to(torch.int32), slen.to(torch.int32)
    if bands is None:
        bands = mt.bands.default_bands(ilen, slen, t_max)
    lab = mt.helpers.extend_labels(labels, slen, s1)
    denom, lpb, lpl_raw = SK.softmax_stats_plain(logits, lab, blank)
    s_idx = torch.arange(s1, dtype=torch.int32, device=logits.device)
    lpl = torch.where(s_idx[None, None, :] < slen[:, None, None], lpl_raw,
                      float("-inf"))
    masks = mt.bands.lattice_masks(ilen, slen, bands, t_max, s1)
    additive = mt.helpers.mask_to_additive
    bvirt = additive(s_idx[None, :] == slen[:, None])
    return {"stats": (logits, lab, blank),
            "scan": (lpb, lpl, additive(masks.alpha), additive(masks.beta),
                     ilen, bvirt)}


def compare_split_kernels(mt, ops, what):
    """The four split wrappers against their plain versions, same inputs.

    softmax_stats also runs on [B, T, S1] labels (the fused-joint banded
    loss's form); beta_scan must equal fwdbwd_scan's beta half and
    alpha_scan its alpha half. Returns each kernel's max |d|."""
    SK = mt.SK
    logits, lab, blank = ops["stats"]
    lab3 = lab[:, None, :].expand(-1, logits.shape[1], -1).contiguous()
    lab3[:, ::3, 0] = -1                       # ids that vary with t
    errs = {"softmax_stats": 0.0}
    for labels in (lab, lab3):
        got = SK.softmax_stats(logits, labels, blank)
        ref = SK.softmax_stats_plain(logits, labels, blank)
        errs["softmax_stats"] = max(
            [errs["softmax_stats"]]
            + [assert_close(g, r, 1e-5, 1e-6, f"{what} softmax_stats {n} "
                            f"labels {labels.dim()}-D")
               for n, g, r in zip(("denom", "lp_blank", "lp_label"), got,
                                  ref)])
    scan = ops["scan"]
    lpb, lpl, am, bm, ilen, bvirt = scan
    alphas, betas = SK.fwdbwd_scan(*scan)
    ref_a, ref_b = SK.fwdbwd_scan_plain(*scan)
    errs["fwdbwd_scan"] = max(
        assert_close(g, r, 1e-4, 1e-5, f"{what} fwdbwd_scan {n}")
        for n, g, r in (("alphas", alphas, ref_a), ("betas", betas, ref_b)))
    a_only = SK.alpha_scan(lpb, lpl, am)
    b_only = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    errs["alpha_scan"] = assert_close(a_only, ref_a, 1e-4, 1e-5,
                                      f"{what} alpha_scan")
    errs["beta_scan"] = assert_close(b_only, ref_b, 1e-4, 1e-5,
                                     f"{what} beta_scan")
    check(torch.equal(a_only, alphas), f"{what}: alpha_scan differs from "
          "fwdbwd_scan's alpha half")
    check(torch.equal(b_only, betas), f"{what}: beta_scan differs from "
          "fwdbwd_scan's beta half")
    torch.cuda.synchronize()
    log(f"split kernel-vs-plain {what}: max|d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + "; beta_scan == fwdbwd_scan betas, alpha_scan == its alphas")
    return errs


def phase_split_long(mt, case):
    """The split kernels on the banded case's full [2, 1600, 201, 1024]
    lattice with its band: the scans at T=1600 and S1=201, against their
    plain versions, and timed."""
    SK = mt.SK
    args = (case["labels"], case["ilen"], case["slen"])
    shape = "[%d,%d,%d,%d]" % tuple(case["logits"].shape)
    ops = split_operands(mt, case["logits"], *args, bands=case["bands"])
    compare_split_kernels(mt, ops, f"long-T {shape}")
    scan = ops["scan"]
    scan_ms = {"fwdbwd_scan": cuda_ms(lambda: SK.fwdbwd_scan(*scan)),
               "alpha_scan": cuda_ms(lambda: SK.alpha_scan(*scan[:3]))}
    del ops, scan
    log(f"long-T split scans on {shape}, +-{BAND_SHIFT} band, at "
        f"T={shape.split(',')[1]} (ms, f32): {json.dumps(scan_ms)}")
    torch.cuda.empty_cache()


def phase_split_timing(mt, main_inputs):
    """Each split kernel against its bound, plain version and yardstick, at
    the benchmark lattice."""
    SK = mt.SK
    logits, labels, ilen, slen = main_inputs
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg = logits.to(dtype)
        ops = split_operands(mt, lg, labels, ilen, slen)
        scan = ops["scan"]
        lpb, lpl, am, bm, il, bvirt = scan
        n_b, n_t, n_s1, n_v = lg.shape
        cells = n_b * n_t * n_s1
        small = cells * 4                    # one [B, T, S1] f32
        big = lg.numel() * lg.element_size()
        vec = n_b * n_s1 * 4 + n_b * 4       # beta_virtual and input_lengths
        timed = {
            "softmax_stats": (
                lambda: SK.softmax_stats(*ops["stats"]),
                lambda: SK.softmax_stats_plain(*ops["stats"]),
                lambda: torch.logsumexp(lg, dim=-1),
                bound_ms(big + n_b * n_s1 * 4 + 3 * small, 4 * lg.numel())),
            "fwdbwd_scan": (
                lambda: SK.fwdbwd_scan(*scan),
                lambda: SK.fwdbwd_scan_plain(*scan), None,
                bound_ms(6 * small + vec, 2 * 8 * cells)),
            "alpha_scan": (
                lambda: SK.alpha_scan(lpb, lpl, am),
                lambda: SK.alpha_scan_plain(lpb, lpl, am), None,
                bound_ms(4 * small, 8 * cells)),
            "beta_scan": (
                lambda: SK.beta_scan(lpb, lpl, bm, il, bvirt),
                lambda: SK.beta_scan_plain(lpb, lpl, bm, il, bvirt), None,
                bound_ms(4 * small + vec, 8 * cells)),
        }
        out = {}
        for name, (kern, plain, lib, bound) in timed.items():
            scan_plain = lib is None       # a Python loop over T: timed once
            out[name] = {
                "ms": cuda_ms(kern),
                "plain_ms": cuda_ms(plain, reps=1 if scan_plain else
                                    TIMING_REPS, warmup=0 if scan_plain
                                    else 3),
                "library_ms": cuda_ms(lib) if lib else None,
                "bound": bound}
            if scan_plain or name == "softmax_stats":
                out[name]["queued_ms"] = queued_ms(kern)
            if scan_plain:                 # T dependent steps a chain
                out[name]["ns_per_step"] = out[name]["ms"] * 1e6 / n_t
                out[name]["queued_ns_per_step"] = (out[name]["queued_ms"]
                                                   * 1e6 / n_t)
                out[name]["kernel_queued_ms"] = graph_ms(kern)
                out[name]["kernel_queued_ns_per_step"] = (
                    out[name]["kernel_queued_ms"] * 1e6 / n_t)
        rows[dtype] = out
        log(f"split timing {dtype}: " + "; ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound'][0]:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']})"
            for n, r in out.items()))
        log(f"split scans {dtype}, ns per dependent step (T={n_t}), one "
            "call / queued / kernel alone: " + ", ".join(
                f"{n} {r['ns_per_step']:.1f} / {r['queued_ns_per_step']:.1f}"
                f" / {r['kernel_queued_ns_per_step']:.1f}"
                for n, r in out.items() if "ns_per_step" in r))
        del ops, scan
        torch.cuda.empty_cache()
    return rows


def run_split(mt, main_inputs):
    """Every split phase at the benchmark lattice; returns the kernels'
    errors and the timing rows."""
    errs = {}
    # Small shapes first: S1 = 1, and S1 = 1101 (strided threads, T=1200).
    # Then the scans' register-chain edges: S1 = 31-33 (one or two warps),
    # 64-65, 96-97, 128-129, 256 (eight) and 257 (the block chain), T = 300.
    cases = [(3, 40, 0, 30, 2), (1, 1200, 1100, 16, 3)] + [
        (4, 300, s1 - 1, 30, 0) for s1 in (31, 32, 33, 64, 65, 96, 97, 128,
                                           129, 256, 257)]
    for (b, t, s, v, blank) in cases:
        lg, lab, il, sl = make_inputs(b, t, s, v, blank=blank, seed=2,
                                      t_range=(max(s, 1), t),
                                      s_range=(0, s))
        compare_split_kernels(mt, split_operands(mt, lg, lab, il, sl, blank),
                              f"({b},{t},{s},{v}) blank={blank}")
    for dtype in (torch.float32, torch.bfloat16):
        lg, lab, il, sl = main_inputs
        errs[dtype] = compare_split_kernels(
            mt, split_operands(mt, lg.to(dtype), lab, il, sl),
            f"benchmark {dtype}")
    return errs, phase_split_timing(mt, main_inputs)


def phase_step_floor(mt, shapes):
    """The step floor of a scan of B chains of T dependent steps: the same
    B chains of T steps on the lightest chain the port has, alpha_scan on a
    [B, T, 32] lattice (one warp, no barrier), the kernel alone in a CUDA
    graph. Returns {(B, T): ms}."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    floors = {}
    for b, t in shapes:
        lpb, lpl = (torch.randn((b, t, 32), generator=gen, device=DEVICE) - 1
                    for _ in range(2))
        am = torch.zeros_like(lpb)
        floors[(b, t)] = graph_ms(lambda: mt.SK.alpha_scan(lpb, lpl, am))
        log(f"step floor [{b},{t}]: the one-warp chain (alpha_scan at "
            f"[{b},{t},32], CUDA graph) takes {floors[(b, t)]:.5f} ms, "
            f"{floors[(b, t)] * 1e6 / t:.2f} ns a dependent step")
    return floors


def add_step_floor(entries, floors, shapes):
    """step_floor_ms on each scan entry (shapes: name -> its (B, T)), beside
    bound_ms; bound_by_floor says which of the two is the larger."""
    for e in entries:
        if e["name"] in shapes:
            b, t = shapes[e["name"]]
            e["step_floor_ms"] = floors[(b, t)]
            e["step_floor_ns_per_step"] = floors[(b, t)] * 1e6 / t
            e["bound_by_floor"] = ("step floor" if e["step_floor_ms"]
                                   > e["bound_ms"] else e["bound_by"])


def split_kernel_entries(errs, rows):
    """The four split kernels' JSON entries (f32, bf16 nested), with their
    errors at the benchmark lattice under path split, whose calls are
    checks, not a loss route (launches 0); by_path adds the other paths'."""
    spec = (("softmax_stats", 244), ("fwdbwd_scan", 1053),
            ("alpha_scan", 921), ("beta_scan", 947))
    kernels = []
    for name, line in spec:
        f32, b16 = rows[torch.float32][name], rows[torch.bfloat16][name]
        entry = {
            "name": name, "route": "cuda",
            "source": "monotonic_rnnt_tpu_torch/csrc/split.cu",
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/kernels.py:{line}",
            "launches": 0,
            "max_abs_err": errs[torch.float32][name],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
            "library_ms": f32["library_ms"],
            "status": "redesigned",
            "dtype": "float32",
            "shape": "B=%d,T=%d,S1=%d,V=%d" % (B, T, S + 1, V),
            "bf16": {"max_abs_err": errs[torch.bfloat16][name],
                     "ms": b16["ms"], "plain_ms": b16["plain_ms"],
                     "bound_ms": b16["bound"][0],
                     "library_ms": b16["library_ms"]},
        }
        for key in ("ns_per_step", "queued_ms", "queued_ns_per_step",
                    "kernel_queued_ms", "kernel_queued_ns_per_step"):
            if key in f32:
                entry[key] = f32[key]
                entry["bf16"][key] = b16[key]
        if f32["library_ms"] is None:
            entry["library_note"] = "no single PyTorch call computes a scan"
        if name == "beta_scan":
            entry["path_note"] = ("the fused-joint backward's per-chunk beta "
                                  "recurrence; fwdbwd_scan's beta half "
                                  "equals it")
        kernels.append(entry)
    return kernels


def by_path(entries, base, launches, errs):
    """Each entry's launches and max |d| per path: `base` (the entry's own
    numbers) and every path in launches / errs that runs or checked it.
    launches becomes their sum, max_abs_err their max."""
    for e in entries:
        name = e["name"]
        lp, ep = {base: e["launches"]}, {base: e["max_abs_err"]}
        lp.update({p: n[name] for p, n in launches.items()
                   if p != base and n.get(name)})
        ep.update({p: d[name] for p, d in errs.items()
                   if p != base and name in d})
        e.update(launches=sum(lp.values()), launches_by_path=lp,
                 max_abs_err=max(ep.values()), max_abs_err_by_path=ep)


# --- the fused-joint losses -----------------------------------------------------

# benchmarks/memory_bench.py's case (B, T', S, V, H; De = Dp = H) and chunk.
FUSED_CASE = (4, 1024, 63, 8192, 512)
FUSED_CHUNK = 64
# benchmarks/fused_banded_bench.py's case (B, T, S, V, H; De = Dp = H).
FUSED_BANDED_CASE = (2, 1600, 200, 1024, 512)


def joint_full(params, enc_c, pred):
    """The additive tanh joint of benchmarks/memory_bench.py:70-73."""
    h = torch.tanh((enc_c @ params["we"])[:, :, None, :]
                   + (pred @ params["wp"])[:, None, :, :])
    return h @ params["wv"] + params["bv"]


def joint_banded(params, enc_c, pred_band):
    """The same joint on band-gathered predictor rows
    (benchmarks/fused_banded_bench.py:36-42)."""
    h = torch.tanh((enc_c @ params["we"])[:, :, None, :]
                   + pred_band @ params["wp"])
    return h @ params["wv"] + params["bv"]


def fused_case(mt, b, t, s, v, h, seed=SEED):
    """memory_bench.py:55-68's inputs, drawn as it draws them."""
    rng = np.random.RandomState(seed)
    enc = rng.randn(b, t, h).astype(np.float32) * .1
    pred = rng.randn(b, s + 1, h).astype(np.float32) * .1
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    params = {"we": rng.randn(h, h).astype(np.float32) * 0.05,
              "wp": rng.randn(h, h).astype(np.float32) * 0.05,
              "wv": rng.randn(h, v).astype(np.float32) * 0.05,
              "bv": np.zeros((v,), np.float32)}
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=DEVICE)
    return {"enc": torch.from_numpy(enc).to(DEVICE),
            "pred": torch.from_numpy(pred).to(DEVICE),
            "labels": as_int(labels), "ilen": as_int(np.full(b, t)),
            "slen": as_int(np.full(b, s)),
            "params": mt.convert.joint_params_from_numpy(params,
                                                         device=DEVICE)}


def fused_banded_case(mt, b, t, s, v, h, shift, seed=SEED):
    """fused_banded_bench.py:63-85's inputs and bands, drawn as it draws them."""
    bd = mt.bands
    rng = np.random.RandomState(seed)
    enc = rng.randn(b, t, h).astype(np.float32) * 0.3
    pred = rng.randn(b, s + 1, h).astype(np.float32) * 0.3
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    align = np.zeros((b, t), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(t, size=s, replace=False))
        align[i, pos] = labels[i]
    scale = h ** -0.5
    params = {"we": rng.randn(h, h).astype(np.float32) * scale,
              "wp": rng.randn(h, h).astype(np.float32) * scale,
              "wv": rng.randn(h, v).astype(np.float32) * scale,
              "bv": np.zeros(v, np.float32)}
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=DEVICE)
    ilen, slen = as_int(np.full(b, t)), as_int(np.full(b, s))
    bands = bd.bands_from_alignment(as_int(align), ilen, slen, shift, 0)
    w = bd.suggested_band_width(ilen, slen, bands, t, s + 1)
    return {"enc": torch.from_numpy(enc).to(DEVICE),
            "pred": torch.from_numpy(pred).to(DEVICE),
            "labels": as_int(labels), "ilen": ilen, "slen": slen,
            "bands": bands, "w": w,
            "exact": bool(bd.band_layout_is_exact(ilen, slen, bands, t, s + 1,
                                                  w).all()),
            "params": mt.convert.joint_params_from_numpy(params,
                                                         device=DEVICE)}


def joint_step(mt, loss_fn, case, weights):
    """A weighted training step from fresh leaves: (costs, [d_enc, d_pred,
    d_params...], launches after the forward, launches after the step)."""
    K = mt.K
    e = case["enc"].clone().requires_grad_(True)
    p = case["pred"].clone().requires_grad_(True)
    pr = {k: v.clone().requires_grad_(True) for k, v in case["params"].items()}
    K.reset_launch_counts()
    costs = loss_fn(e, p, pr)
    torch.cuda.synchronize()
    fwd = launched(K)
    (costs * weights).sum().backward()
    torch.cuda.synchronize()
    return (costs.detach(), [e.grad, p.grad] + [pr[k].grad for k in pr],
            fwd, launched(K))


JOINT_GRADS = ("d_enc", "d_pred", "d_we", "d_wp", "d_wv", "d_bv")


def rel_l2(got, ref) -> float:
    got, ref = got.detach().double(), ref.detach().double()
    return float((got - ref).norm() / ref.norm())


def compare_joint_grads(got, ref, what, rel: float = 2e-3,
                        names=JOINT_GRADS):
    """Gradients of two routes through the joint, leaf by leaf: finite, and
    ||got - ref|| / ||ref|| <= rel (why not entry by entry: the module
    docstring's fused-joint tolerance)."""
    errs = {}
    for n, g, r in zip(names, got, ref, strict=True):
        check(bool(torch.isfinite(g).all()), f"{what} {n} finite")
        errs[n] = rel_l2(g, r)
        check(errs[n] <= rel, f"{what} {n}: relative L2 error {errs[n]:.3g} "
              f"> {rel}")
    return errs


def f64_truth(case, weights):
    """Costs and joint gradients of the full-lattice case in float64: the
    joint, log_softmax and the alpha recurrence under plain autograd, one
    sample at a time (4.3 GB of f64 logits each). Every T_b = T and S_b = S,
    so the final state is alpha(T-1, S) and no lattice mask is needed;
    -1e30 stands for log 0 so that no gradient meets -inf - -inf."""
    check(bool((case["ilen"] == case["enc"].shape[1]).all())
          and bool((case["slen"] == case["labels"].shape[1]).all()),
          "the float64 truth takes full-length samples only")
    dev = case["enc"].device
    f64 = lambda x: x.double().requires_grad_(True)
    params = {k: f64(x) for k, x in case["params"].items()}
    enc, pred = f64(case["enc"]), f64(case["pred"])
    n_b, t_max = enc.shape[:2]
    s = case["labels"].shape[1]
    costs = []
    for b in range(n_b):
        lp = torch.log_softmax(joint_full(params, enc[b:b + 1],
                                          pred[b:b + 1]), -1)[0]
        lp_blank = lp[:, :, 0]
        lp_label = lp[:, torch.arange(s, device=dev),
                      case["labels"][b].long()]           # [T, S]
        zero = torch.full((1,), -1e30, dtype=torch.float64, device=dev)
        row = torch.cat([zero + 1e30, zero.expand(s)])
        for t in range(t_max):
            row = torch.logaddexp(row + lp_blank[t],
                                  torch.cat([zero, row[:s] + lp_label[t]]))
        (-row[s] * weights[b].double()).backward()
        costs.append(-float(row[s].detach()))
        del lp, lp_blank, lp_label
    grads = [enc.grad, pred.grad] + [params[k].grad for k in params]
    return torch.tensor(costs, dtype=torch.float64, device=dev), grads


def fused_path_kernels(mt, module, beta_name, n_chunks, step, what):
    """One more training step of a fused-joint path, its kernel calls kept
    for the last chunk and an interior one (the backward walks the chunks in
    reverse), and the alpha scan over all of T: each held against its plain
    version on those operands, and the scans timed on them. Returns (max
    |d| per wrapper, the scans' ms)."""
    alpha_name = ("alpha_scan_banded" if beta_name == "fwdbwd_scan_banded"
                  else "alpha_scan")
    cap, = fused_joint_capture(module, n_chunks, beta_name, alpha_name)
    with cap:
        step()
    errs = compare_captured(mt, cap, what)
    pairs = plain_pairs(mt)
    _, a_args, _ = cap.calls[alpha_name][0]
    _, b_args, _ = cap.calls[beta_name][1]
    _, g_args, g_kw = cap.calls["grad_pass"][1]
    key = what.replace("-", "_").replace(" ", "_")
    scan_ms = {}
    for name, fn, args in (
            (alpha_name, pairs[alpha_name][0], a_args),
            (f"{beta_name}_chunk", pairs[beta_name][0], b_args)):
        call = lambda: fn(*args)
        scan_ms[f"{key}_{name}_ms"] = cuda_ms(call)
        scan_ms[f"{key}_{name}_queued_ms"] = queued_ms(call)
        scan_ms[f"{key}_{name}_kernel_queued_ms"] = graph_ms(call)
        for q in ("queued", "kernel_queued"):
            scan_ms[f"{key}_{name}_{q}_ns_per_step"] = (
                scan_ms[f"{key}_{name}_{q}_ms"] * 1e6 / args[0].shape[1])
        scan_ms[f"{key}_{name}_shape"] = list(args[0].shape)
    scan_ms[f"{key}_grad_pass_chunk"] = grad_chunk_timing(mt, g_args, g_kw)
    del cap, a_args, b_args, g_args
    torch.cuda.empty_cache()
    return errs, scan_ms


def grad_chunk_timing(mt, args, kw):
    """grad_pass on one chunk of a fused-joint path, as the path called it:
    one call and queued, beside torch.softmax on the same logits, with its
    bound from the chunk's live rows (read) and all its rows (written)."""
    x, occ, cb, cl = args[0], args[2], args[3], args[4]
    kern = lambda: mt.K.grad_pass(*args, **kw)
    live = int(((occ != 0) | (cb != 0) | (cl != 0)).sum())
    rows, v = occ.numel(), x.shape[3]
    out_isz = torch.empty((), dtype=kw.get("out_dtype", torch.float32)
                          ).element_size()
    bound = bound_ms(live * v * x.element_size() + rows * v * out_isz
                     + 5 * rows * 4, 6 * live * v)
    return {"shape": list(x.shape), "dtype": dtype_name(x.dtype),
            "live_rows": live, "rows": rows, "ms": cuda_ms(kern),
            "queued_ms": queued_ms(kern),
            "library_ms": cuda_ms(lambda: torch.softmax(x, dim=-1)),
            "library_queued_ms": queued_ms(lambda: torch.softmax(x, dim=-1)),
            "bound_ms": bound[0], "bound_by": bound[1]}


def phase_fused_joint(mt, weights):
    """rnnt_loss_fused_joint at memory_bench.py's case against the
    materialised route (the joint's [B, T', S+1, V] logits, then
    monotonic_rnnt_loss), with launch counts and peak memory."""
    b, t, s, v, h = FUSED_CASE
    case = fused_case(mt, b, t, s, v, h)
    args = (case["labels"], case["ilen"], case["slen"])
    n_chunks = -(-t // FUSED_CHUNK)
    logits_bytes = b * t * (s + 1) * v * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fused = lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, *args, joint_full, pr, chunk_t=FUSED_CHUNK)
    costs, grads, fwd, step = joint_step(mt, fused, case, weights)
    peak = torch.cuda.max_memory_allocated() - base
    check(fwd == {"softmax_stats": n_chunks, "alpha_scan": 1},
          f"fused-joint forward launches {fwd}")
    check(step == {"softmax_stats": 2 * n_chunks, "alpha_scan": 1,
                   "beta_scan": n_chunks, "grad_pass": n_chunks},
          f"fused-joint step launches {step}")
    check(tuple(costs.shape) == (b,) and bool(torch.isfinite(costs).all()),
          "fused-joint costs finite, [B]")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "fused-joint grads finite")
    check(peak < logits_bytes / 4, f"fused-joint peak {peak} bytes is not "
          f"well under the {logits_bytes}-byte logits tensor")
    torch.cuda.reset_peak_memory_stats()
    base_m = torch.cuda.memory_allocated()
    mono = lambda e, p, pr: mt.monotonic_rnnt_loss(joint_full(pr, e, p),
                                                   *args)
    ref_costs, ref_grads, _, ref_step = joint_step(mt, mono, case, weights)
    peak_m = torch.cuda.max_memory_allocated() - base_m
    check(ref_step == LOSS_STEP,
          f"materialised route launches {ref_step}")
    e_c = assert_close(costs, ref_costs, 1e-4, 1e-5,
                       "fused-joint vs materialised costs")
    errs = compare_joint_grads(grads, ref_grads, "fused-joint vs materialised")
    truth_costs, truth = f64_truth(case, weights)
    e_t = assert_close(costs, truth_costs, 1e-4, 1e-5,
                       "fused-joint costs vs the float64 truth")
    to_truth = {"fused": compare_joint_grads(
        grads, truth, "fused-joint vs the float64 truth", rel=5e-3),
        "materialised": {n: rel_l2(g, r)
                         for n, g, r in zip(JOINT_GRADS, ref_grads, truth)}}
    del truth
    path_errs, scan_ms = fused_path_kernels(
        mt, mt.chunked, "beta_scan", n_chunks,
        lambda: joint_step(mt, fused, case, weights), "fused-joint")
    log(f"fused-joint B={b},T'={t},S={s},V={v},H={h}, chunk_t={FUSED_CHUNK}: "
        f"launches fwd {fwd}, step {step}; peak memory of the step "
        f"{peak / 2**30:.3f} GiB above its inputs (materialised route "
        f"{peak_m / 2**30:.3f} GiB; logits tensor {logits_bytes / 2**30:.3f} "
        f"GiB); vs materialised costs max|d| {e_c:.3g}, grads relative L2 "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + f"; vs the float64 truth costs max|d| {e_t:.3g}, grads relative L2 "
        + "; ".join(f"{route} " + ", ".join(f"{k} {e:.3g}"
                                            for k, e in r.items())
                    for route, r in to_truth.items())
        + f"; mean cost {float(costs.mean()):.4f}")
    del grads, ref_grads
    torch.cuda.empty_cache()
    return case, step, path_errs, {"fused_peak_bytes": peak,
                                   "materialised_peak_bytes": peak_m,
                                   "logits_bytes": logits_bytes, **scan_ms}


def phase_fused_joint_banded(mt):
    """rnnt_loss_fused_joint_banded at fused_banded_bench.py's case against
    the materialised banded route and the full-lattice fused-joint loss with
    the same bands."""
    b, t, s, v, h = FUSED_BANDED_CASE
    case = fused_banded_case(mt, b, t, s, v, h, BAND_SHIFT)
    args = (case["labels"], case["ilen"], case["slen"])
    w = case["w"]
    layout = mt.bands.compute_band_layout(case["ilen"], case["slen"],
                                          case["bands"], t, s + 1, w)
    idx = layout.offset.long()[:, :, None] + torch.arange(w, device=DEVICE)
    b_idx = torch.arange(b, device=DEVICE)[:, None, None]
    weights = torch.tensor([-0.5, 2.0], device=DEVICE)
    n_chunks = -(-t // FUSED_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    banded = lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, *args, joint_banded, pr, bands=case["bands"], band_width=w,
        chunk_t=FUSED_CHUNK)
    costs, grads, fwd, step = joint_step(mt, banded, case, weights)
    peak = torch.cuda.max_memory_allocated() - base
    check(fwd == {"softmax_stats": n_chunks, "alpha_scan_banded": 1},
          f"banded fused-joint forward launches {fwd}")
    check(step == {"softmax_stats": 2 * n_chunks, "alpha_scan_banded": 1,
                   "fwdbwd_scan_banded": n_chunks, "grad_pass": n_chunks},
          f"banded fused-joint step launches {step}")
    check(bool(torch.isfinite(costs).all()), "banded fused-joint costs finite")
    mono = lambda e, p, pr: mt.monotonic_rnnt_loss_banded(
        joint_banded(pr, e, p[b_idx, idx]), *args, bands=case["bands"])
    ref_costs, ref_grads, _, ref_step = joint_step(mt, mono, case, weights)
    check(ref_step == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1,
                       "grad_pass": 1},
          f"materialised banded route launches {ref_step}")
    e_c = assert_close(costs, ref_costs, 1e-4, 1e-5,
                       "banded fused-joint vs materialised costs")
    errs = compare_joint_grads(grads, ref_grads,
                               "banded fused-joint vs materialised")
    full = lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, *args, joint_full, pr, chunk_t=FUSED_CHUNK, bands=case["bands"])
    full_costs, full_grads, _, _ = joint_step(mt, full, case, weights)
    e_fc = assert_close(costs, full_costs, 1e-4, 1e-5,
                        "banded vs full-lattice fused-joint costs")
    e_fg = compare_joint_grads(grads, full_grads,
                               "banded vs full-lattice fused-joint")
    del grads, ref_grads, full_grads
    path_errs, scan_ms = fused_path_kernels(
        mt, mt.chunked_banded, "fwdbwd_scan_banded", n_chunks,
        lambda: joint_step(mt, banded, case, weights), "banded fused-joint")
    log(f"banded fused-joint B={b},T={t},S={s},V={v},H={h}, shift "
        f"{BAND_SHIFT}: W={w} (layout exact: {case['exact']}), chunk_t="
        f"{FUSED_CHUNK}; launches fwd {fwd}, step {step}; peak memory "
        f"{peak / 2**30:.3f} GiB above its inputs; vs materialised banded "
        f"costs max|d| {e_c:.3g}, grads relative L2 "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + f"; vs full-lattice fused-joint costs max|d| {e_fc:.3g}, grads "
        "relative L2 " + ", ".join(f"{k} {e:.3g}" for k, e in e_fg.items())
        + f"; costs {costs.tolist()}")
    torch.cuda.empty_cache()
    return case, step, path_errs, {"banded_fused_peak_bytes": peak,
                                   "band_width": w, **scan_ms}


def run_fused_joint(mt):
    """Both fused-joint phases and their timing; returns the launch counts
    of each path's training step, each path's kernel errors and the
    end-to-end numbers."""
    weights = torch.linspace(-0.5, 2.0, FUSED_CASE[0], device=DEVICE)
    case, step, errs, mem = phase_fused_joint(mt, weights)
    args = (case["labels"], case["ilen"], case["slen"])

    def fused_step():
        e = case["enc"].clone().requires_grad_(True)
        pr = {k: v.clone().requires_grad_(True)
              for k, v in case["params"].items()}
        costs = mt.rnnt_loss_fused_joint(e, case["pred"], *args, joint_full,
                                         pr, chunk_t=FUSED_CHUNK)
        (costs * weights).sum().backward()

    with torch.no_grad():
        chunk = joint_full(case["params"], case["enc"][:, :FUSED_CHUNK],
                           case["pred"])
    lab = mt.helpers.extend_labels(case["labels"], case["slen"],
                                   FUSED_CASE[2] + 1)
    e2e = {"fused_chunk_softmax_stats_ms": cuda_ms(
               lambda: mt.SK.softmax_stats(chunk, lab, 0)),
           "fused_chunk_bound_ms": bound_ms(
               chunk.numel() * 4 + lab.numel() * 4 + 3 * chunk[..., 0].numel()
               * 4, 4 * chunk.numel())[0],
           "fused_joint_step_ms": cuda_ms(fused_step, reps=3, warmup=1),
           **mem}
    del case, chunk
    torch.cuda.empty_cache()
    bcase, bstep, berrs, bnums = phase_fused_joint_banded(mt)
    bargs = (bcase["labels"], bcase["ilen"], bcase["slen"])
    bweights = torch.tensor([-0.5, 2.0], device=DEVICE)

    def banded_step():
        e = bcase["enc"].clone().requires_grad_(True)
        pr = {k: v.clone().requires_grad_(True)
              for k, v in bcase["params"].items()}
        costs = mt.rnnt_loss_fused_joint_banded(
            e, bcase["pred"], *bargs, joint_banded, pr, bands=bcase["bands"],
            band_width=bcase["w"], chunk_t=FUSED_CHUNK)
        (costs * bweights).sum().backward()

    e2e.update({
        "banded_fused_joint_step_ms": cuda_ms(banded_step, reps=3, warmup=1),
        **bnums})
    log("fused-joint timing: " + json.dumps(e2e))
    return ({"fused_joint": step, "fused_joint_banded": bstep},
            {"fused_joint": errs, "fused_joint_banded": berrs}, e2e)


# --- the Conformer transducer (Models A) ---------------------------------------

# benchmarks/train_bench.py's defaults: B, input frames, labels, features; a
# 4x256 Conformer with max(2, 256 // 64) heads, embed_dim 128, joint_dim 256,
# V = 1024 and the LSTM predictor, dropout 0. Its lattice is [16, 100, 26,
# 1024]: 170 MB of f32 logits.
MODEL_BATCH = (16, 400, 25, 80)
MODEL_LAYERS, MODEL_DIM, MODEL_VOCAB = 4, 256, 1024
MODEL_MAX_LABELS = 50         # benchmarks/decode_bench.py's default
MODEL_REPS = 10


def model_config(mt, dtype, layers=MODEL_LAYERS):
    m = mt.models
    return m.TransducerConfig(
        encoder=m.ConformerConfig(num_layers=layers, dim=MODEL_DIM,
                                  num_heads=max(2, MODEL_DIM // 64),
                                  dropout=0.0, dtype=dtype),
        predictor=m.PredictorConfig(vocab_size=MODEL_VOCAB, dim=MODEL_DIM,
                                    embed_dim=MODEL_DIM // 2, dtype=dtype),
        joint_dim=MODEL_DIM, vocab_size=MODEL_VOCAB, dtype=dtype)


def model_batch(device):
    """train_bench.py's batch, drawn as it draws it: full lengths."""
    b, t, s, f = MODEL_BATCH
    rng = np.random.RandomState(SEED)
    feats = rng.randn(b, t, f).astype(np.float32)
    labels = rng.randint(1, MODEL_VOCAB, (b, s)).astype(np.int32)
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device=device)
    return (torch.from_numpy(feats).to(device), full(t),
            torch.from_numpy(labels).to(device), full(s))


def make_model(mt, dtype, device):
    """The model from a seeded generator: its weights are drawn on the CPU,
    so the card's model and the CPU's are the same."""
    return mt.models.MonotonicTransducer(
        model_config(mt, dtype), MODEL_BATCH[3],
        generator=torch.Generator().manual_seed(SEED), device=device)


def model_step(model, batch):
    """The model's loss step: costs, their mean, backward(); no optimiser.
    Returns (costs, {name: grad})."""
    model.zero_grad(set_to_none=True)
    costs = model(*batch)
    costs.mean().backward()
    return costs.detach(), {n: p.grad for n, p in model.named_parameters()}


def plain_model_step(mt, model, batch):
    """model_step on the CPU through rows 1-2's plain versions: the model's
    logits into ops/loss._LossCore on the cuda backend's deferred route,
    which CPU tensors run through stats_alpha_fused_plain and
    beta_grad_fused_plain."""
    feats, flen, labels, slen = batch
    model.zero_grad(set_to_none=True)
    logits, enc_len = model.logits(feats, flen, labels)
    bands = mt.bands.default_bands(enc_len, slen, logits.shape[1])
    costs = mt.loss._LossCore.apply(logits, labels, enc_len, slen,
                                    bands.min_s, bands.max_s,
                                    model.cfg.blank_id, "cuda")
    costs.mean().backward()
    return costs.detach(), {n: p.grad for n, p in model.named_parameters()}


def compare_model_grads(got, ref, what, rel):
    """Every parameter's gradient by its relative L2 error. The attention's
    key bias has an exact gradient of 0 (it adds q.b to a whole softmax row),
    so each side holds rounding noise there: it is held to rel times its
    key weight's gradient norm instead."""
    errs = {}
    for name, g in got.items():
        r = ref[name].to(g.device)
        check(bool(torch.isfinite(g).all()), f"{what} {name} finite")
        if name.endswith("mhsa.key.bias"):
            scale = float(ref[name[:-4] + "weight"].norm())
            errs[name] = float((g - r).norm()) / scale
        else:
            errs[name] = rel_l2(g, r)
        check(errs[name] <= rel, f"{what} {name}: relative L2 error "
              f"{errs[name]:.3g} > {rel}")
    return errs


# A decode that parts from its reference must part at a frame whose
# reference margin (greedy: top-2 logits; beam: the smallest gap between
# adjacent candidates among the K+1 best) is below this: there two sides'
# matmuls, which round apart by ~1e-6 in a logit, may choose apart.
DECODE_MARGIN = 1e-4
# Scores of equal hypotheses: two sides' joints round apart, and the
# per-frame log-probs (~-7 each) sum over 100 frames.
DECODE_SCORE_RTOL = 1e-5


def full_frames(model, feats, flen):
    """The encodings a full-utterance decode reads, and each frame's
    active flags [B, T']."""
    with torch.no_grad():
        enc, enc_len = model.encode(feats, flen)
    t_idx = torch.arange(enc.shape[1], device=enc.device)
    return enc, t_idx[None, :] < enc_len[:, None]


def greedy_replay(model, frames):
    """greedy_decode's loop replayed on `frames` (model._greedy_frame_step,
    the same calls in the same order): ((hyp, n_hyp), the hypothesis and
    its length after each frame [B, cap+1], each frame's top-2 logit margin
    [B, T'])."""
    enc, active = frames
    b, dev = enc.shape[0], enc.device
    with torch.no_grad():
        carry = (torch.zeros((b, MODEL_MAX_LABELS), dtype=torch.int32,
                             device=dev),
                 torch.zeros(b, dtype=torch.int32, device=dev),
                 *model._bos_context(b))
        slots = torch.arange(MODEL_MAX_LABELS, device=dev)[None, :]
        steps, margins = [], []
        for t in range(enc.shape[1]):
            logit = model.joint(enc[:, t:t + 1], carry[3][:, None, :])
            top2 = logit[:, 0, 0].topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            carry, _, _ = model._greedy_frame_step(carry, enc[:, t:t + 1],
                                                   active[:, t], slots)
            steps.append(torch.cat([carry[0], carry[1][:, None]], 1))
    return carry[:2], steps, torch.stack(margins, 1)


def hold_decode(got, ref, replays, what, failures):
    """A decode `got` ((hyp, n) or (tokens, n, scores)) against its
    reference `ref`: samples with equal hypotheses pass, their scores within
    DECODE_SCORE_RTOL; a sample that differs must part first at a frame
    where ref's replay margin is below DECODE_MARGIN. replays() ->
    ((result, steps, _) of got's side, (result, steps, margins) of ref's),
    run only where a sample differs, and their results must equal the
    decodes'. Failures go to `failures`; returns a note."""
    got = [x.cpu() for x in got]
    ref = [x.cpu() for x in ref]
    differ = (got[0] != ref[0]).flatten(1).any(1) | (got[1] != ref[1]).view(
        len(got[1]), -1).any(1)
    same = ~differ
    note = f"{int(same.sum())} of {len(same)} samples equal"
    if len(got) == 3 and bool(same.any()):
        err = float(torch.where(got[2][same] == ref[2][same], 0.0,
                                (got[2][same] - ref[2][same]).abs()).max())
        share = worst_share(got[2][same], ref[2][same], 1e-6,
                            DECODE_SCORE_RTOL)
        note += f", their scores max|d| {err:.3g} ({share:.3f} of rtol)"
        if not share <= 1.0:
            failures.append(f"{what}: scores max|d| {err:.3g} beyond 1e-6 "
                            f"+ {DECODE_SCORE_RTOL}|ref|")
    if not bool(differ.any()):
        return note
    (g_res, g_steps, _), (r_res, r_steps, margins) = replays()
    for side, res, dec in (("got", g_res, got), ("ref", r_res, ref)):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(res, dec)):
            failures.append(f"{what}: the {side} side's replay does not "
                            "give its decode")
    margins = margins.cpu()
    parts = []
    for b in torch.nonzero(differ)[:, 0].tolist():
        frames = [t for t in range(min(len(g_steps), len(r_steps)))
                  if not torch.equal(g_steps[t][b].cpu(), r_steps[t][b].cpu())]
        if frames:
            f0, margin = frames[0], float(margins[b, frames[0]])
        elif len(ref) == 3:   # apart only in the final best-first order
            s = ref[2][b][torch.isfinite(ref[2][b])]
            f0, margin = "final", float((s[:-1] - s[1:]).abs().min())
        else:                 # no frame parts: the replays missed it
            f0, margin = "none", math.inf
        parts.append(f"sample {b} parts at frame {f0}, margin {margin:.3g}")
        if not margin < DECODE_MARGIN:
            failures.append(f"{what}: sample {b} parts from the reference at "
                            f"frame {f0}, where its margin is {margin:.3g} >= "
                            f"{DECODE_MARGIN}")
    return note + " (" + "; ".join(parts) + ")"


def phase_model_decode(mt, model, cpu_model, batch, cpu_batch):
    """Greedy decode on the card (no kernel launch) against the CPU: the
    same hypotheses token for token, or, where a sample's differ, the first
    frame where the two parts has a CPU top-2 margin below 1e-4."""
    K = mt.K
    feats, flen = batch[:2]
    K.reset_launch_counts()
    hyp, n_hyp = model.greedy_decode(feats, flen, MODEL_MAX_LABELS)
    torch.cuda.synchronize()
    check(launched(K) == {}, f"greedy decode launches {launched(K)}")
    c_frames = full_frames(cpu_model, *cpu_batch[:2])
    c_replay = greedy_replay(cpu_model, c_frames)
    ref_hyp, ref_n = cpu_model.greedy_decode(*cpu_batch[:2],
                                             MODEL_MAX_LABELS)
    check(all(torch.equal(a, b) for a, b in zip(c_replay[0],
                                                (ref_hyp, ref_n))),
          "the frame-by-frame replay gives greedy_decode's hypotheses")
    failures = []
    note = hold_decode(
        (hyp, n_hyp), (ref_hyp, ref_n),
        lambda: (greedy_replay(model, full_frames(model, feats, flen)),
                 c_replay), "greedy decode card vs CPU", failures)
    check(not failures, "; ".join(failures))
    log(f"model greedy decode (max_labels {MODEL_MAX_LABELS}): launches "
        f"none; card vs CPU hypotheses: {note}; lengths {n_hyp.tolist()}; "
        f"smallest CPU top-2 margin on a valid frame "
        f"{float(c_replay[2][c_frames[1]].min()):.3g}")
    return hyp, n_hyp


def joint_case(model, batch):
    """The model's encoder and predictor outputs and its joint's parameters,
    as joint_step takes them."""
    feats, flen, labels, slen = batch
    with torch.no_grad():
        enc, enc_len = model.encode(feats, flen)
        pred = model.predictor(labels)
    return {"enc": enc, "pred": pred, "labels": labels, "ilen": enc_len,
            "slen": slen, "params": {k: v.detach() for k, v in
                                     model.joint.joint_params().items()}}


def phase_model_fused_joint(mt, model, batch):
    """The model's Joint as the joint_fn of both fused-joint losses (the
    banded one under default_bands, the whole lattice), and its banded form
    under monotonic_rnnt_loss_banded: each against the materialised model
    loss, every kernel call of each path held against its plain version.
    Returns (launches by path, max |d| by path)."""
    joint = model.joint
    case = joint_case(model, batch)
    args = (case["labels"], case["ilen"], case["slen"])
    b, t_enc = case["enc"].shape[:2]
    s1 = case["pred"].shape[1]
    names = ["d_enc", "d_pred"] + [f"d_{k}" for k in case["params"]]
    weights = torch.linspace(-0.5, 2.0, b, device=DEVICE)
    chunk = 32                      # rnnt_loss_fused_joint's default
    n_chunks = -(-t_enc // chunk)
    mono = lambda e, p, pr: mt.monotonic_rnnt_loss(joint.joint_fn(pr, e, p),
                                                   *args)
    ref_costs, ref_grads, _, ref_step = joint_step(mt, mono, case, weights)
    check(ref_step == LOSS_STEP,
          f"materialised model joint launches {ref_step}")
    bands = mt.bands.default_bands(case["ilen"], case["slen"], t_enc)
    w = mt.bands.suggested_band_width(case["ilen"], case["slen"], bands,
                                      t_enc, s1)
    keep = lambda scan: {"softmax_stats": {n_chunks, n_chunks + n_chunks // 2},
                         scan: {0, n_chunks // 2}, "grad_pass": {0,
                                                                 n_chunks // 2}}
    routes = {
        "fused_joint": (mt.chunked, {**keep("beta_scan"), "alpha_scan": {0}},
                        lambda e, p, pr: mt.rnnt_loss_fused_joint(
                            e, p, *args, joint.joint_fn, pr, chunk_t=chunk),
                        {"softmax_stats": 2 * n_chunks, "alpha_scan": 1,
                         "beta_scan": n_chunks, "grad_pass": n_chunks}),
        "fused_joint_banded": (
            mt.chunked_banded, {**keep("fwdbwd_scan_banded"),
                                "alpha_scan_banded": {0}},
            lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
                e, p, *args, joint.banded_fn, pr, bands=bands, band_width=w,
                chunk_t=chunk),
            {"softmax_stats": 2 * n_chunks, "alpha_scan_banded": 1,
             "fwdbwd_scan_banded": n_chunks, "grad_pass": n_chunks})}
    launches = {"model_fused_joint": {}, "model_banded": {}}
    errs = {"model_fused_joint": {}}
    parts = []
    for route, (module, kept, loss_fn, want) in routes.items():
        with Capture(module, kept) as cap:
            costs, grads, _, step = joint_step(mt, loss_fn, case, weights)
        check(step == want, f"model {route} step launches {step}")
        e_c = assert_close(costs, ref_costs, 1e-4, 1e-5,
                           f"model {route} vs materialised costs")
        e_g = compare_joint_grads(grads, ref_grads,
                                  f"model {route} vs materialised",
                                  names=names)
        for name, e in compare_captured(mt, cap, f"model {route}").items():
            errs["model_fused_joint"][name] = max(
                e, errs["model_fused_joint"].get(name, 0.0))
        for name, n in step.items():
            launches["model_fused_joint"][name] = (
                launches["model_fused_joint"].get(name, 0) + n)
        parts.append(f"{route}: launches {step}, costs max|d| {e_c:.3g}, "
                     "grads relative L2 max "
                     f"{max(e_g.values()):.3g} ({max(e_g, key=e_g.get)})")
        del grads
    layout = mt.bands.compute_band_layout(case["ilen"], case["slen"], bands,
                                          t_enc, s1, w)
    idx = layout.offset.long()[:, :, None] + torch.arange(w, device=DEVICE)
    b_idx = torch.arange(b, device=DEVICE)[:, None, None]
    banded = lambda e, p, pr: mt.monotonic_rnnt_loss_banded(
        joint.banded_fn(pr, e, p[b_idx, idx]), *args, bands=bands)
    with Capture(mt.cuda_banded, {"softmax_stats_banded": {0},
                                  "fwdbwd_scan_banded": {0},
                                  "grad_pass": {0}}) as cap:
        costs, grads, _, step = joint_step(mt, banded, case, weights)
    check(step == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1,
                   "grad_pass": 1}, f"model banded joint launches {step}")
    e_c = assert_close(costs, ref_costs, 1e-4, 1e-5,
                       "model banded joint vs materialised costs")
    e_g = compare_joint_grads(grads, ref_grads, "model banded joint vs "
                              "materialised", names=names)
    errs["model_banded"] = compare_captured(mt, cap, "model banded joint")
    launches["model_banded"] = step
    parts.append(f"Joint.banded under monotonic_rnnt_loss_banded: launches "
                 f"{step}, costs max|d| {e_c:.3g}, grads relative L2 max "
                 f"{max(e_g.values()):.3g}")
    log(f"model joint as joint_fn at [{b},{t_enc},{s1},{MODEL_VOCAB}], "
        f"chunk_t={chunk}, W={w}: " + "; ".join(parts))
    del case, grads
    torch.cuda.empty_cache()
    return launches, errs


def run_model(mt):
    """The Conformer transducer at train_bench.py's defaults on the card:
    the f32 model against the same model on the CPU (costs, every gradient,
    greedy hypotheses), rows 1 and 2 against their plain versions on its
    logits, launch counts of the loss step, a cost-only forward and greedy
    decode, the Joint as joint_fn, and the bf16 model. Returns (launches by
    path, max |d| by path)."""
    K = mt.K
    b, t, s, f = MODEL_BATCH
    batch, cpu_batch = model_batch(DEVICE), model_batch("cpu")
    costs_by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        model = make_model(mt, dtype, DEVICE)
        K.reset_launch_counts()
        costs, grads = model_step(model, batch)
        torch.cuda.synchronize()
        step_launches = launched(K)
        check(step_launches == LOSS_STEP,
              f"model {name} loss step launches {step_launches}")
        check(tuple(costs.shape) == (b,) and bool(torch.isfinite(costs).all()),
              f"model {name} costs [B] and finite")
        K.reset_launch_counts()
        with torch.no_grad():
            fwd_costs = model(*batch)
        torch.cuda.synchronize()
        check(launched(K) == COST_ONLY,
              f"model {name} no_grad forward launches {launched(K)}")
        check(torch.equal(fwd_costs, costs), f"model {name} cost-only costs "
              "differ from the loss step's")
        costs_by_dtype[dtype] = costs
        if dtype == torch.float32:
            main_launches = step_launches
            cpu_model = make_model(mt, dtype, "cpu")
            for (n, p), q in zip(model.state_dict().items(),
                                 cpu_model.state_dict().values()):
                check(torch.equal(p.cpu(), q), f"model weights {n} differ "
                      "between the card and the CPU")
            cpu_costs, cpu_grads = plain_model_step(mt, cpu_model, cpu_batch)
            e_c = assert_close(costs.cpu(), cpu_costs, 0.0, 1e-4,
                               "model f32 card vs CPU costs")
            e_g = compare_model_grads(grads, cpu_grads,
                                      "model f32 card vs CPU", 1e-3)
            worst = max(e_g, key=e_g.get)
            # A joint that gave every token 1/V: T' log V - log C(T', S).
            t_enc = int(mt.models.conformer.subsampled_length(
                model.cfg.encoder, t))
            uniform = (t_enc * math.log(MODEL_VOCAB) - math.lgamma(t_enc + 1)
                       + math.lgamma(s + 1) + math.lgamma(t_enc - s + 1))
            log(f"model f32 card vs CPU (plain versions): costs max|d| "
                f"{e_c:.3g}, every gradient's relative L2 <= "
                f"{e_g[worst]:.3g} ({worst}, {len(e_g)} parameters); mean "
                f"cost {float(costs.mean()):.4f} (a uniform joint's "
                f"{uniform:.1f})")
            with torch.no_grad():
                logits, enc_len = model.logits(*batch[:3])
            err_12 = compare_kernels(mt, *kernel_operands(
                mt, logits, batch[2], enc_len, batch[3], 0), "model logits "
                f"[{b},{logits.shape[1]},{s + 1},{MODEL_VOCAB}]")
            del logits
            phase_model_decode(mt, model, cpu_model, batch, cpu_batch)
            del cpu_model, cpu_grads
            model_launches, model_errs = phase_model_fused_joint(mt, model,
                                                                 batch)
        else:
            K.reset_launch_counts()
            model.greedy_decode(*batch[:2], MODEL_MAX_LABELS)
            torch.cuda.synchronize()
            check(launched(K) == {}, f"model bf16 greedy decode launches "
                  f"{launched(K)}")
            e_b = assert_close(costs, costs_by_dtype[torch.float32], 0.0,
                               2e-2, "model bf16 vs f32 costs")
            log(f"model bf16: costs vs the f32 model's (same weights) max|d| "
                f"{e_b:.3g}; mean cost {float(costs.mean()):.4f}")
        del grads, model
        torch.cuda.empty_cache()
    model_launches["model"] = main_launches
    model_errs["model"] = {"stats_alpha_fused": err_12[0],
                           "beta_grad_fused": err_12[1]}
    return model_launches, model_errs


# --- the training step (Models B) -----------------------------------------------

# create_train_state at train_bench.py's defaults (the model cell above), lr
# 3e-3 and one warmup update, as tests/test_models.py's train tests: the
# first update has lr 0, so the steps after it move the weights.
TRAIN_LR, TRAIN_WARMUP = 3e-3, 1
TRAIN_STEPS = 3                # card vs CPU
TRAIN_DESCEND_STEPS = 5        # test_train_step_descends
TRAIN_CHUNK = 32               # make_memory_efficient_loss's default chunk_t
TRAIN_MICRO = 4                # make_grad_accum_train_step's microbatches
# Tolerances of the parameters after the steps, by each leaf's relative L2
# error ||p - p_ref|| / ||p_ref||. Adam's update does not see a gradient's
# scale, so a relative gradient error e moves an element's step by ~e of it
# wherever the element's gradient is well above rounding noise; a leaf's
# update is at most its norm (zero-initialised biases) and ~0.1 of it
# (weights, 3e-3 a step against entries ~1/sqrt(256)), so the leaf's error
# stays at ~e. Elements at the noise floor take +-lr steps that noise
# decides (on the CPU, port against JAX: <= 5.1e-5 on every other leaf).
# Card vs CPU: run_model's gradients agree within 8.61e-5 relative L2, so 1e-3
# (a tenth of that noise floor's room left to the elements Adam amplifies);
# the fused-joint route against the materialised one: its gradient bound,
# 2e-3.
TRAIN_PARAM_REL = 1e-3
TRAIN_FUSED_PARAM_REL = 2e-3


def train_state(mt, dtype, device, seed=SEED, layers=MODEL_LAYERS):
    """create_train_state at the model cell, its weights drawn on the CPU
    from `seed` (run_model's weights at seed 0), the model on `device`."""
    return mt.train.create_train_state(
        model_config(mt, dtype, layers), seed, model_batch("cpu"),
        learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, device=device)


def snapshot(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def train_steps(mt, state, batch, n, step=None, launches=None):
    """n steps (train_step unless `step`); returns [(loss, grad_norm)] as
    floats, read after the steps. With `launches`, each step's launch
    counts must equal it."""
    K = mt.K
    step = step or mt.train.train_step
    out = []
    for _ in range(n):
        K.reset_launch_counts()
        state, m = step(state, batch)
        if launches is not None:
            torch.cuda.synchronize()
            check(launched(K) == launches,
                  f"train step launches {launched(K)}, not {launches}")
        out.append((m["loss"], m["grad_norm"]))
    return [(float(a), float(b)) for a, b in out]


def key_bias_bound(mt, lrs):
    """Adam's drift bound over updates at lrs (models/train.py): the most
    the attention's key bias, whose true gradient is exactly 0, can move
    from its initial 0 on rounding noise."""
    return mt.train.adam_drift_bound(lrs) * (1 + 1e-6) + 1e-7


def compare_params(mt, got, ref, what, rel, lrs):
    """Each leaf's relative L2 error against `ref`; the key bias finite and
    within key_bias_bound on both sides. Returns {name: error}."""
    errs = {}
    bound = key_bias_bound(mt, lrs)
    for name, g in got.items():
        r = ref[name].to(g.device)
        check(bool(torch.isfinite(g).all()), f"{what} {name} finite")
        if name.endswith("mhsa.key.bias"):
            drift = max(float(g.abs().max()), float(r.abs().max()))
            check(drift <= bound, f"{what} {name}: drift {drift:.3g} > Adam's "
                  f"bound {bound:.3g}")
            errs[name] = drift / bound
            continue
        errs[name] = rel_l2(g, r)
        check(errs[name] <= rel, f"{what} {name}: relative L2 error "
              f"{errs[name]:.3g} > {rel}")
    return errs


def share_line(errs, rel):
    """The worst leaf's share of its tolerance, the key bias apart."""
    plain = {k: v for k, v in errs.items() if not k.endswith("key.bias")}
    worst = max(plain, key=plain.get)
    keyb = [v for k, v in errs.items() if k.endswith("key.bias")]
    return (f"params relative L2 <= {plain[worst]:.3g} ({worst}; "
            f"{plain[worst] / rel:.3f} of {rel}), key bias "
            f"{max(keyb):.3f} of Adam's drift bound")


def train_lrs(mt, n):
    """The lrs of the first n updates (create_train_state's schedule)."""
    return [TRAIN_LR * mt.train.warmup_cosine_factor(c, TRAIN_WARMUP, 10_000)
            for c in range(n)]


def phase_train_vs_cpu(mt, batch, cpu_batch):
    """TRAIN_STEPS f32 train_steps on the card (one stats_alpha_fused and
    one beta_grad_fused each) and on the CPU (the loss's oracle) from the
    same weights: losses at 1e-4 relative, grad_norm at 1e-3, every
    parameter after the steps at TRAIN_PARAM_REL; then two more card steps:
    the loss descends over TRAIN_DESCEND_STEPS. The second step's calls of
    rows 1-2 are kept and held against their plain versions. Returns the
    card state, its snapshots after steps 2 and 3, their metrics and the
    kept calls' max |d| per wrapper."""
    step_launches = LOSS_STEP
    card = train_state(mt, torch.float32, DEVICE)
    cpu = train_state(mt, torch.float32, "cpu")
    for (n, p), q in zip(card.model.named_parameters(),
                         cpu.model.parameters()):
        check(torch.equal(p.cpu(), q), f"train weights {n} differ")
    with rows12_capture(mt, 1) as cap:
        got = train_steps(mt, card, batch, 2, launches=step_launches)
    after2 = snapshot(card)
    got += train_steps(mt, card, batch, TRAIN_STEPS - 2,
                       launches=step_launches)
    after3 = snapshot(card)
    t0 = time.perf_counter()
    want = train_steps(mt, cpu, cpu_batch, TRAIN_STEPS)
    cpu_s = time.perf_counter() - t0
    loss_share = max(abs(g[0] - w[0]) / (1e-4 * abs(w[0]))
                     for g, w in zip(got, want))
    norm_share = max(abs(g[1] - w[1]) / (1e-3 * abs(w[1]))
                     for g, w in zip(got, want))
    check(loss_share <= 1 and norm_share <= 1, f"train f32 card vs CPU: "
          f"losses {got} vs {want}")
    errs = compare_params(mt, after3, snapshot(cpu), "train f32 card vs CPU",
                          TRAIN_PARAM_REL, train_lrs(mt, TRAIN_STEPS))
    log(f"train f32 card vs CPU ({TRAIN_STEPS} train_steps, lr {TRAIN_LR}, "
        f"warmup {TRAIN_WARMUP}; the CPU's {cpu_s:.1f} s): losses "
        f"{[round(g[0], 4) for g in got]} vs {[round(w[0], 4) for w in want]}"
        f", {loss_share:.3f} of 1e-4 relative; grad_norm "
        f"{[round(g[1], 3) for g in got]}, {norm_share:.3f} of 1e-3; "
        + share_line(errs, TRAIN_PARAM_REL) + f"; launches a step "
        f"{step_launches}")
    more = train_steps(mt, card, batch,
                       TRAIN_DESCEND_STEPS - TRAIN_STEPS)
    losses = [g[0] for g in got + more]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train loss did not descend over {len(losses)} steps: {losses}")
    log(f"train f32 loss over {len(losses)} steps: {losses}")
    errs = compare_captured_rows12(mt, cap, "train f32 step 2")
    return card, after2, after3, got, errs


def phase_train_fused(mt, batch, after3, padded_metrics):
    """make_memory_efficient_loss (chunk TRAIN_CHUNK) stepped TRAIN_STEPS
    times from the same weights as the padded card steps: the same losses
    (|d| <= 1e-4 + 1e-5|ref|) and parameters at TRAIN_FUSED_PARAM_REL; the
    launches of each step are the fused-joint path's rows in the counts
    the chunking gives. The first step's chunk kernels (fused_joint_capture)
    are held against their plain versions. Returns (launches, max |d| per
    wrapper)."""
    state = train_state(mt, torch.float32, DEVICE)
    loss_fn = mt.train.make_memory_efficient_loss(state.model,
                                                  chunk_t=TRAIN_CHUNK)
    t_enc = int(mt.models.conformer.subsampled_length(
        state.model.cfg.encoder, MODEL_BATCH[1]))
    n_chunks = -(-t_enc // TRAIN_CHUNK)
    launches = {"softmax_stats": 2 * n_chunks, "alpha_scan": 1,
                "beta_scan": n_chunks, "grad_pass": n_chunks}
    step = lambda s, b: mt.train.train_step_with_loss(s, loss_fn, b)  # noqa
    cap, = fused_joint_capture(mt.chunked, n_chunks)
    with cap:
        got = train_steps(mt, state, batch, 1, step=step, launches=launches)
    got += train_steps(mt, state, batch, TRAIN_STEPS - 1, step=step,
                       launches=launches)
    share = max(abs(g[0] - w[0]) / (1e-4 + 1e-5 * abs(w[0]))
                for g, w in zip(got, padded_metrics))
    check(share <= 1, f"train fused-joint losses {got} vs padded "
          f"{padded_metrics}")
    errs = compare_params(mt, snapshot(state), after3,
                          "train fused-joint vs padded",
                          TRAIN_FUSED_PARAM_REL, train_lrs(mt, TRAIN_STEPS))
    log(f"train fused-joint step (chunk_t {TRAIN_CHUNK}) vs train_step: "
        f"losses {share:.3f} of 1e-4 + 1e-5|ref|; "
        + share_line(errs, TRAIN_FUSED_PARAM_REL) + f"; launches a step "
        f"{launches}")
    return launches, compare_captured(mt, cap, "train fused-joint step 1")


def phase_train_accum_and_checkpoint(mt, batch, after2, padded_metrics,
                                     card):
    """make_grad_accum_train_step(TRAIN_MICRO) over two steps against the
    padded card run's first two (losses 1e-5 relative, parameters at
    TRAIN_PARAM_REL); then a checkpoint round trip on the card: the card
    run's state saved, restored into a state from seed 7, one more step on
    each: the losses within 1e-6 relative (CUDA atomics in the backward
    make bits vary) and the restored state equal to the saved one."""
    state = train_state(mt, torch.float32, DEVICE)
    n = TRAIN_MICRO
    got = train_steps(mt, state, batch, 2,
                      step=mt.train.make_grad_accum_train_step(n),
                      launches=times(LOSS_STEP, n))
    share = max(abs(g[0] - w[0]) / (1e-5 * abs(w[0]))
                for g, w in zip(got, padded_metrics))
    check(share <= 1, f"grad accum losses {got} vs {padded_metrics[:2]}")
    errs = compare_params(mt, snapshot(state), after2,
                          "grad accum vs one step", TRAIN_PARAM_REL,
                          train_lrs(mt, 2))
    log(f"train grad accumulation ({n} microbatches) vs train_step over 2 "
        f"steps: losses {share:.3f} of 1e-5 relative; "
        + share_line(errs, TRAIN_PARAM_REL))
    del state
    at = card.step
    with tempfile.TemporaryDirectory(prefix="mrnnt_ckpt_") as tmp:
        path = Path(tmp) / "state.pt"
        mt.train.save_checkpoint(path, card)
        size = path.stat().st_size
        restored = mt.train.restore_checkpoint(
            path, train_state(mt, torch.float32, DEVICE, seed=SEED + 7))
    check(restored.step == card.step, "restored step")
    for (n_, p), q in zip(card.model.named_parameters(),
                          restored.model.parameters()):
        check(torch.equal(p, q), f"restored {n_} differs")
    (a,), (b,) = (train_steps(mt, s, batch, 1) for s in (card, restored))
    rel = abs(a[0] - b[0]) / abs(a[0])
    check(rel <= 1e-6, f"resumed loss {b[0]!r} vs {a[0]!r}")
    log(f"train checkpoint ({size / 2**20:.1f} MiB) round trip at step "
        f"{at}: restored state equal; the next losses "
        f"{a[0]!r} and {b[0]!r}, relative {rel:.3g} (<= 1e-6)")


def run_train(mt):
    """The training step at the model cell on the card: f32 against the
    CPU, the loss's descent, the memory-efficient step, gradient
    accumulation and a checkpoint round trip. Returns (launches by path,
    max |d| by path)."""
    batch, cpu_batch = model_batch(DEVICE), model_batch("cpu")
    card, after2, after3, padded, errs = phase_train_vs_cpu(mt, batch,
                                                            cpu_batch)
    fused_launches, fused_errs = phase_train_fused(mt, batch, after3,
                                                   padded)
    phase_train_accum_and_checkpoint(mt, batch, after2, padded, card)
    del card, after2, after3
    torch.cuda.empty_cache()
    return ({"train": LOSS_STEP, "train_fused_joint": fused_launches},
            {"train": errs, "train_fused_joint": fused_errs})


# --- the serving decoders (Models C) --------------------------------------------

# benchmarks/decode_bench.py's defaults on the model cell: beam 4; its
# streaming model the same width with causal=True and a 16-frame attention
# window, fed 32-frame chunks with streaming_lookback(cfg) = 488 frames of
# history (so a window of 520 frames). The LMs: a seeded log-softmax
# [V, V] bigram table, and an LstmLm of LstmLmConfig's widths in the
# model's dtype, each fused at weight 0.3.
DECODE_BEAM = 4
DECODE_LM_WEIGHT = 0.3
STREAM_CHUNK = 32
STREAM_LEFT = 16
# Merged mass is a sum over a subset of the sequence's paths: at most its
# marginal, up to the rounding of the two routes (the loss tests' 1e-4).
MARGINAL_ATOL = 1e-4


def stream_model(mt, dtype, device):
    """The model cell made causal with a bounded window, same seed."""
    cfg = model_config(mt, dtype)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, causal=True, attn_left_context=STREAM_LEFT))
    return mt.models.MonotonicTransducer(
        cfg, MODEL_BATCH[3], generator=torch.Generator().manual_seed(SEED),
        device=device)


def decode_lms(mt, dtype, device):
    """The two LMs, drawn on the CPU from seeded generators (the card's and
    the CPU's are the same)."""
    lm = mt.lm
    table = torch.log_softmax(torch.randn(
        MODEL_VOCAB, MODEL_VOCAB,
        generator=torch.Generator().manual_seed(SEED + 1)), dim=-1)
    lstm = lm.LstmLm(lm.LstmLmConfig(vocab_size=MODEL_VOCAB, dtype=dtype),
                     generator=torch.Generator().manual_seed(SEED + 2),
                     device=device)
    return {"bigram": lm.BigramLm(table, device=device),
            "lstm_lm": lm.ModuleLmAdapter(lstm)}


def decode_forms(lms):
    """beam_search_decode's keywords of each beam form, by name (paths
    decode: the first two, decode_lm: the LM-fused two)."""
    w = DECODE_LM_WEIGHT
    return {"beam": {}, "beam_merge": {"merge_paths": True},
            "beam_bigram": {"lm": lms["bigram"], "lm_weight": w},
            "beam_lstm_lm": {"lm": lms["lstm_lm"], "lm_weight": w}}


def no_launch(mt, what, fn):
    """fn() with the launch counts reset before it; fails if it launched a
    kernel."""
    mt.K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    check(launched(mt.K) == {}, f"{what} launches {launched(mt.K)}")
    return out


def stream_chunks(feats, flen):
    """feats cut into STREAM_CHUNK-frame chunks with their valid counts;
    the last is zero-padded, and a stream that ended gets zero-valid
    chunks."""
    t = feats.shape[1]
    padded = torch.nn.functional.pad(
        feats, (0, 0, 0, -(-t // STREAM_CHUNK) * STREAM_CHUNK - t))
    return [(padded[:, i:i + STREAM_CHUNK],
             torch.clamp(flen - i, 0, STREAM_CHUNK).to(torch.int32))
            for i in range(0, padded.shape[1], STREAM_CHUNK)]


def stream_frames(model, chunks, lookback):
    """The encodings the streaming steps decode, from model._stream_window
    chunk by chunk as they call it, and each frame's active flags."""
    b, _, f = chunks[0][0].shape
    state = model._stream_state_base(b, f, lookback)
    encs, acts = [], []
    with torch.no_grad():
        for chunk, cv in chunks:
            enc, abs0, out_total, updates = model._stream_window(state,
                                                                 chunk, cv)
            state = {**state, **updates}
            k = torch.arange(enc.shape[1], device=enc.device)
            encs.append(enc)
            acts.append(abs0 + k[None, :] < out_total[:, None])
    return torch.cat(encs, 1), torch.cat(acts, 1)


def beam_replay(model, frames, beam, merge_paths=False, lm=None,
                lm_weight=0.0):
    """beam_search_decode's loop replayed on `frames` (model's
    _beam_frame_step, the same calls in the same order): (its result, the
    tokens and lengths after each frame [B, K*(cap+1)], each frame's
    smallest gap between adjacent candidates among a sample's K+1 best
    [B, T'] (inf between non-finite ones))."""
    enc, active = frames
    with torch.no_grad():
        carry = model._beam_init_carry(enc.shape[0], beam, MODEL_MAX_LABELS,
                                       lm)
        steps, gaps = [], []
        for t in range(enc.shape[1]):
            cand = model._beam_candidates(carry, enc[:, t], active[:, t],
                                          lm=lm, lm_weight=lm_weight)
            top = cand.flatten(1).sort(dim=1, descending=True).values
            gap = top[:, :beam] - top[:, 1:beam + 1]
            gaps.append(torch.where(torch.isfinite(gap), gap,
                                    math.inf).min(1).values)
            carry = model._beam_frame_step(
                carry, enc[:, t], active[:, t], merge_paths=merge_paths,
                lm=lm, lm_weight=lm_weight)
            steps.append(torch.cat([carry[0].flatten(1), carry[1]], 1))
    return (model._beam_result(carry, merge_paths), steps,
            torch.stack(gaps, 1))


def compare_stats_alpha(mt, cap, what):
    """A Capture's stats_alpha_fused calls against the plain version on the
    same operands; returns the max |d|."""
    K = mt.K
    calls = cap.calls["stats_alpha_fused"]
    check(len(calls) == len(cap.keep["stats_alpha_fused"]),
          f"{what}: stats_alpha_fused made {len(calls)} of the calls")
    errs = []
    with torch.no_grad():
        for _, args, kwargs in calls:
            got = K.stats_alpha_fused(*args, **kwargs)
            ref = K.stats_alpha_fused_plain(*args, **kwargs)
            errs += [assert_close(g, r, 1e-5, 1e-6, f"{what} stats {n}")
                     for n, g, r in zip(("denom", "lp_blank", "lp_label"),
                                        got, ref)]
            errs.append(assert_close(got[3], ref[3], 1e-4, 1e-5,
                                     f"{what} alphas"))
    torch.cuda.synchronize()
    return max(errs)


def phase_decode_marginal(mt, model, batch, merged, what, failures):
    """Each sample's merged top score against the marginal of its sequence:
    the model's logits on that sequence through monotonic_rnnt_loss,
    cost-only on the card (one stats_alpha_fused, kept and held against its
    plain version). Returns (max |d| of row 1, the smallest slack)."""
    feats, flen = batch[:2]
    tok, n, score = merged
    seq, nb = tok[:, 0], n[:, 0]
    slots = torch.arange(seq.shape[1], device=seq.device)[None, :]
    labels = torch.where(slots < nb[:, None], seq, 1)   # any label pads
    with torch.no_grad():
        logits, enc_len = model.logits(feats, flen, labels)
    with Capture(mt.fused, {"stats_alpha_fused": {0}}) as cap:
        mt.K.reset_launch_counts()
        with torch.no_grad():
            cost = mt.monotonic_rnnt_loss(logits, labels, enc_len, nb)
        torch.cuda.synchronize()
        runs = launched(mt.K)
    check(runs == COST_ONLY,
          f"{what} marginal cost-only loss launches {runs}")
    err = compare_stats_alpha(mt, cap, f"{what} decode_marginal")
    slack = (-cost) + MARGINAL_ATOL - score[:, 0]
    if not bool((slack >= 0).all()):
        b = int(slack.argmin())
        failures.append(f"{what}: sample {b}'s merged score "
                        f"{float(score[b, 0]):.6g} exceeds its marginal "
                        f"{-float(cost[b]):.6g} + {MARGINAL_ATOL}")
    del logits
    return err, float(slack.min())


def phase_stream(mt, model, batch, lms, failures):
    """Streaming greedy and streaming beam (LstmLm fused) over every chunk
    of the batch, against the full-utterance decodes on the card."""
    feats, flen = batch[:2]
    name = dtype_name(model.cfg.dtype)
    lookback = mt.models.conformer.streaming_lookback(model.cfg.encoder)
    chunks = stream_chunks(feats, flen)
    b, _, f = feats.shape
    lm, w = lms["lstm_lm"], DECODE_LM_WEIGHT

    def greedy_stream():
        state = model.streaming_init(b, f, lookback, MODEL_MAX_LABELS)
        emitted = []
        for chunk, cv in chunks:
            state, out = model.streaming_step(state, chunk, cv)
            emitted.append(out)
        return state, torch.cat(emitted, 1)

    def beam_stream():
        state = model.streaming_beam_init(b, f, lookback, MODEL_MAX_LABELS,
                                          DECODE_BEAM, lm)
        for chunk, cv in chunks:
            state, beam = model.streaming_beam_step(state, chunk, cv, lm=lm,
                                                    lm_weight=w)
        return state, beam

    full = no_launch(mt, f"stream model {name} greedy decode",
                     lambda: model.greedy_decode(feats, flen,
                                                 MODEL_MAX_LABELS))
    full_beam = no_launch(mt, f"stream model {name} beam decode",
                          lambda: model.beam_search_decode(
                              feats, flen, MODEL_MAX_LABELS, DECODE_BEAM,
                              lm=lm, lm_weight=w))
    g_state, emitted = no_launch(mt, f"streaming greedy {name}",
                                 greedy_stream)
    b_state, beam = no_launch(mt, f"streaming beam {name}", beam_stream)
    check(g_state["n_seen"] == len(chunks) * STREAM_CHUNK,
          f"streaming greedy {name} n_seen {g_state['n_seen']}")
    hyp, n_hyp = g_state["hyp"], g_state["n_hyp"]
    for i in range(b):
        toks = emitted[i][emitted[i] != model.cfg.blank_id]
        check(torch.equal(toks, hyp[i, :int(n_hyp[i])]),
              f"streaming greedy {name} sample {i}: the chunks' emitted ids "
              "are not its hypothesis")
    s_frames = lambda: stream_frames(model, chunks, lookback)
    f_frames = lambda: full_frames(model, feats, flen)
    notes = [
        "greedy " + hold_decode(
            (hyp, n_hyp), full,
            lambda: (greedy_replay(model, s_frames()),
                     greedy_replay(model, f_frames())),
            f"streaming greedy {name} vs full", failures),
        "beam " + hold_decode(
            beam, full_beam,
            lambda: (beam_replay(model, s_frames(), DECODE_BEAM, lm=lm,
                                 lm_weight=w),
                     beam_replay(model, f_frames(), DECODE_BEAM, lm=lm,
                                 lm_weight=w)),
            f"streaming beam {name} vs full", failures)]
    log(f"stream {name} ({len(chunks)} chunks of {STREAM_CHUNK} frames, "
        f"lookback {lookback}): launches none; vs the full-utterance "
        f"decodes on the card: " + "; ".join(notes) + f"; greedy lengths "
        f"{n_hyp.tolist()}")

    mid = len(chunks) // 2
    g_mid = stream_state_after(chunks, mid, lambda: model.streaming_init(
        b, f, lookback, MODEL_MAX_LABELS), model.streaming_step)
    b_mid = stream_state_after(chunks, mid, lambda: model.streaming_beam_init(
        b, f, lookback, MODEL_MAX_LABELS, DECODE_BEAM, lm),
        lambda st, ch, cv: model.streaming_beam_step(st, ch, cv, lm=lm,
                                                     lm_weight=w))
    chunk, cv = chunks[mid]
    return {"stream_ms_per_chunk": cuda_ms(
                lambda: model.streaming_step(g_mid, chunk, cv),
                reps=MODEL_REPS, warmup=2),
            "stream_beam_ms_per_chunk": cuda_ms(
                lambda: model.streaming_beam_step(b_mid, chunk, cv, lm=lm,
                                                  lm_weight=w),
                reps=MODEL_REPS, warmup=2)}


def stream_state_after(chunks, k, init, step):
    """The streaming state after the first k chunks."""
    state = init()
    for chunk, cv in chunks[:k]:
        state, _ = step(state, chunk, cv)
    return state


def run_decode(mt, gpu):
    """The serving decoders at the model cell on the card, f32 and bf16:
    beam search (K=4) plain, with merge_paths, and fused with a BigramLm and
    an LstmLm; K=1 against greedy_decode; in f32 each beam form against the
    CPU port on the same weights; the merged scores against the loss's
    marginal (row 1, held against its plain version); streaming greedy and
    streaming beam against the full decodes of the causal model; no decoder
    launches a kernel. Then each form timed. Returns (launches by path,
    max |d| by path, figures by dtype)."""
    batch = model_batch(DEVICE)
    feats, flen = batch[:2]
    b, t = feats.shape[:2]
    audio_s = b * t * 0.01                  # 10 ms a frame
    chunk_audio_s = b * STREAM_CHUNK * 0.01
    failures, figures, marginal_errs = [], {}, []
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        model = make_model(mt, dtype, DEVICE)
        lms = decode_lms(mt, dtype, DEVICE)
        forms = decode_forms(lms)
        results = {form: no_launch(
            mt, f"{form} {name}", lambda kw=kw: model.beam_search_decode(
                feats, flen, MODEL_MAX_LABELS, DECODE_BEAM, **kw))
            for form, kw in forms.items()}
        for form, (tok, n, score) in results.items():
            check(tuple(tok.shape) == (b, DECODE_BEAM, MODEL_MAX_LABELS)
                  and bool(torch.isfinite(score[:, 0]).all())
                  and bool((score[:, :-1] >= score[:, 1:]).all()),
                  f"{form} {name}: shapes, finite best scores, best-first")
        greedy = no_launch(mt, f"greedy {name}", lambda: model.greedy_decode(
            feats, flen, MODEL_MAX_LABELS))
        beam1 = no_launch(mt, f"beam K=1 {name}",
                          lambda: model.beam_search_decode(
                              feats, flen, MODEL_MAX_LABELS, 1))
        frames = lambda: full_frames(model, feats, flen)

        def k1_replays():
            (tok, n, _), steps, gaps = beam_replay(model, frames(), 1)
            return (((tok[:, 0], n[:, 0]), steps, gaps),
                    greedy_replay(model, frames()))

        notes = ["K=1 vs greedy: " + hold_decode(
            (beam1[0][:, 0], beam1[1][:, 0]), greedy, k1_replays,
            f"beam K=1 {name} vs greedy", failures)]
        check(bool((results["beam_merge"][2][:, 0]
                    >= results["beam"][2][:, 0] - 1e-5).all()),
              f"beam {name}: a merged score below its best path's")
        if dtype == torch.float32:
            cpu_batch = model_batch("cpu")
            cpu_model = make_model(mt, dtype, "cpu")
            cpu_forms = decode_forms(decode_lms(mt, dtype, "cpu"))
            cpu_frames = lambda: full_frames(cpu_model, *cpu_batch[:2])
            for form, kw in forms.items():
                cpu_kw = cpu_forms[form]
                ref = cpu_model.beam_search_decode(
                    *cpu_batch[:2], MODEL_MAX_LABELS, DECODE_BEAM, **cpu_kw)
                notes.append(f"{form} card vs CPU: " + hold_decode(
                    results[form], ref,
                    lambda kw=kw, cpu_kw=cpu_kw: (
                        beam_replay(model, frames(), DECODE_BEAM, **kw),
                        beam_replay(cpu_model, cpu_frames(), DECODE_BEAM,
                                    **cpu_kw)),
                    f"{form} f32 card vs CPU", failures))
            del cpu_model
        err, slack = phase_decode_marginal(mt, model, batch,
                                           results["beam_merge"], name,
                                           failures)
        marginal_errs.append(err)
        notes.append(f"merged top scores <= the marginal + {MARGINAL_ATOL} "
                     f"(smallest slack {slack:.4g}; row 1 vs plain max|d| "
                     f"{err:.3g})")
        lengths = {form: r[1][:, 0].tolist() for form, r in results.items()}
        log(f"decode {name} at B={b}, {t} frames, K={DECODE_BEAM}, "
            f"max_labels {MODEL_MAX_LABELS}: launches none; "
            + "; ".join(notes) + f"; best lengths {json.dumps(lengths)}")
        figs = {}
        for form, kw in forms.items():
            ms = cuda_ms(lambda kw=kw: model.beam_search_decode(
                feats, flen, MODEL_MAX_LABELS, DECODE_BEAM, **kw),
                reps=MODEL_REPS, warmup=1)
            figs[f"{form}_ms"] = ms
            figs[f"{form}_x_realtime"] = audio_s / (ms / 1e3)
        del model, results
        torch.cuda.empty_cache()
        s_model = stream_model(mt, dtype, DEVICE)
        s_figs = phase_stream(mt, s_model, batch,
                              decode_lms(mt, dtype, DEVICE), failures)
        for key in ("stream", "stream_beam"):
            s_figs[f"{key}_x_realtime"] = chunk_audio_s / (
                s_figs[f"{key}_ms_per_chunk"] / 1e3)
        figs.update(s_figs)
        figures[name] = figs
        log(f"decode {name} timing ({gpu}): " + json.dumps(figs))
        del s_model
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    log(f"decode phase {time.perf_counter() - t0:.1f} s")
    launches = {p: {} for p in ("decode", "decode_lm", "stream",
                                "stream_beam")}
    launches["decode_marginal"] = times(COST_ONLY, len(marginal_errs))
    return (launches, {"decode_marginal": {
        "stats_alpha_fused": max(marginal_errs)}}, figures)


# --- export and the debug flags -------------------------------------------------

SERVING_REF_CASE = (3, 12, 5, 11)   # tests/test_serving.py's loss batch
SERVING_STREAM_EXTRA = 4            # chunks streamed past the lookback's
# The operators' CUDA implementations, where an exported graph's row 1-2
# calls arrive (the artifact calls torch.ops.mrnnt, not the wrappers).
SERVING_OPS = ("stats_alpha_cuda", "beta_grad_cuda")


def turns_ms(fns, reps: int = TIMING_REPS, warmup: int = 3) -> list:
    """Each fn's median CUDA-event ms over `reps` rounds, the fns timed in
    turns within a round (fn 0, fn 1, ..., then again), each call from an
    idle card."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, times):
            out += cuda_times(fn, 1, warmup=0)
    return [statistics.median(t) for t in times]


def ops_capture(mt, call):
    """A Capture of rows 1-2's operator call `call` at its CUDA
    implementation (every route: a live wrapper or an exported graph)."""
    return Capture(mt.K, {name: {call} for name in SERVING_OPS})


def serving_loss(mt, main_inputs, dtype, e2e):
    """export_loss(backend='cuda') at the padded lattice in `dtype`: the
    imported call against a live rnnt_loss_cuda bit for bit, its row 1-2
    calls against their plain versions, and the times. Returns (max |d|
    by row, figures)."""
    logits, labels, ilen, slen = main_inputs
    name = dtype_name(dtype)
    args = (logits.to(dtype), labels, ilen, slen)
    t0 = time.perf_counter()
    blob = mt.serving.export_loss(*args, backend="cuda", device=DEVICE)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_fn = mt.serving.import_fn(blob)
    import_s = time.perf_counter() - t0
    live = lambda: mt.fused.rnnt_loss_cuda(*args)
    want_c, want_g = live()
    mt.K.reset_launch_counts()
    with ops_capture(mt, 0) as cap:
        got_c, got_g = loss_fn(*args)
        torch.cuda.synchronize()
    check(launched(mt.K) == LOSS_STEP,
          f"export {name}: the imported call launched {launched(mt.K)}")
    check(got_g.dtype == dtype, f"export {name}: grads {got_g.dtype}")
    check(torch.equal(got_c, want_c) and torch.equal(got_g, want_g),
          f"export {name}: the artifact's costs and gradients differ from "
          "the live rnnt_loss_cuda (max |d| "
          f"{float((got_c - want_c).abs().max()):.3g}, "
          f"{float((got_g.float() - want_g.float()).abs().max()):.3g})")
    errs = compare_captured_rows12(mt, cap, f"export {name}",
                                   names=SERVING_OPS)
    imported_ms, live_ms = turns_ms([lambda: loss_fn(*args), live])
    figs = {"export_s": export_s, "import_s": import_s, "blob_bytes":
            len(blob), "imported_ms": imported_ms, "live_ms": live_ms,
            "padded_fwd_bwd_ms": e2e[name]["fwd_bwd_ms"]}
    log(f"export {name} loss at B={B},T={T},S={S},V={V}: the imported call "
        f"equals the live rnnt_loss_cuda bit for bit; launches one of each "
        f"row; {json.dumps(figs)}")
    return errs, figs


def serving_reference(mt):
    """export_loss(backend='reference') at tests/test_serving.py's batch on
    the card against the oracle (rtol 1e-6, grads 1e-6 + 1e-7, the JAX
    test's bounds); no kernel launches."""
    b, t, s, v = SERVING_REF_CASE
    rng = np.random.RandomState(SEED)
    as_t = lambda a: torch.from_numpy(a).to(DEVICE)
    args = (as_t(rng.randn(b, t, s + 1, v).astype(np.float32)),
            as_t(rng.randint(1, v, (b, s)).astype(np.int32)),
            as_t(rng.randint(s + 1, t + 1, (b,)).astype(np.int32)),
            as_t(rng.randint(1, s + 1, (b,)).astype(np.int32)))
    t0 = time.perf_counter()
    loss_fn = mt.serving.import_fn(mt.serving.export_loss(*args,
                                                          device=DEVICE))
    export_s = time.perf_counter() - t0
    got_c, got_g = no_launch(mt, "reference artifact",
                             lambda: loss_fn(*args))
    want_c, want_g = mt.rnnt_loss_reference(*args)
    e_c = assert_close(got_c, want_c, 0.0, 1e-6, "reference artifact costs")
    e_g = assert_close(got_g, want_g, 1e-7, 1e-6, "reference artifact grads")
    log(f"export reference loss at B,T,S,V={SERVING_REF_CASE} on the card: "
        f"vs the oracle costs max|d| {e_c:.3g}, grads {e_g:.3g}; launches "
        f"none; export+import {export_s:.2f} s")


def serving_greedy(mt):
    """export_greedy_decoder at the model cell (f32), its weights an
    argument: the imported decoder's tokens against the live greedy_decode."""
    model = make_model(mt, torch.float32, DEVICE)
    feats, flen = model_batch(DEVICE)[:2]
    params = dict(model.named_parameters())
    t0 = time.perf_counter()
    blob = mt.serving.export_greedy_decoder(model, params, feats, flen,
                                            MODEL_MAX_LABELS, device=DEVICE)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder = mt.serving.import_fn(blob)
    import_s = time.perf_counter() - t0
    hyp, n_hyp = no_launch(mt, "greedy artifact",
                           lambda: decoder(params, feats, flen))
    want, want_n = model.greedy_decode(feats, flen, MODEL_MAX_LABELS)
    check(torch.equal(hyp, want) and torch.equal(n_hyp, want_n),
          "greedy artifact: tokens differ from the live greedy_decode")
    imported_ms, live_ms = turns_ms(
        [lambda: decoder(params, feats, flen),
         lambda: model.greedy_decode(feats, flen, MODEL_MAX_LABELS)],
        reps=MODEL_REPS, warmup=1)
    figs = {"export_s": export_s, "import_s": import_s,
            "blob_bytes": len(blob), "imported_ms": imported_ms,
            "live_ms": live_ms}
    log(f"export greedy decoder at the model cell (B={feats.shape[0]}, "
        f"{feats.shape[1]} frames, f32): tokens equal the live decode in "
        f"every sample (lengths {n_hyp.tolist()}); launches none; "
        + json.dumps(figs))
    return figs


def serving_stream(mt):
    """export_streaming_decoder at the streaming cell: the lookback's
    chunks and SERVING_STREAM_EXTRA more (seeded frames, the last chunks
    partly valid) through the imported step and the live streaming_step,
    each chunk's emitted ids equal; then the ms a chunk once the lookback
    is full."""
    model = stream_model(mt, torch.float32, DEVICE)
    b, f = MODEL_BATCH[0], MODEL_BATCH[3]
    lookback = mt.models.conformer.streaming_lookback(model.cfg.encoder)
    frames = (-(-lookback // STREAM_CHUNK) + SERVING_STREAM_EXTRA) * (
        STREAM_CHUNK)
    rng = np.random.RandomState(SEED + 3)
    feats = torch.from_numpy(rng.randn(b, frames, f).astype(
        np.float32)).to(DEVICE)
    flen = torch.from_numpy(rng.randint(frames - 3 * STREAM_CHUNK,
                                        frames + 1, b).astype(np.int32))
    chunks = stream_chunks(feats, flen.to(DEVICE))
    params = dict(model.named_parameters())
    t0 = time.perf_counter()
    blob, state = mt.serving.export_streaming_decoder(
        model, params, b, f, STREAM_CHUNK, MODEL_MAX_LABELS, device=DEVICE)
    step = mt.serving.import_fn(blob)
    export_s = time.perf_counter() - t0
    live = model.streaming_init(b, f, lookback, MODEL_MAX_LABELS)
    states = []
    mt.K.reset_launch_counts()
    for i, (chunk, cv) in enumerate(chunks):
        states.append((state, live))
        state, got = step(params, state, chunk, cv)
        live, want = model.streaming_step(live, chunk, cv)
        check(torch.equal(got, want), f"streaming artifact: chunk {i}'s "
              "emitted ids differ from the live streaming_step")
    torch.cuda.synchronize()
    check(launched(mt.K) == {}, f"streaming launches {launched(mt.K)}")
    check(torch.equal(state["hyp"], live["hyp"])
          and int(state["n_seen"]) == len(chunks) * STREAM_CHUNK,
          "streaming artifact: final state differs")
    k = len(chunks) - 2                       # the lookback is full here
    (s_k, l_k), (chunk, cv) = states[k], chunks[k]
    imported_ms, live_ms = turns_ms(
        [lambda: step(params, s_k, chunk, cv),
         lambda: model.streaming_step(l_k, chunk, cv)],
        reps=MODEL_REPS, warmup=2)
    figs = {"export_import_s": export_s, "blob_bytes": len(blob),
            "imported_ms_per_chunk": imported_ms,
            "live_ms_per_chunk": live_ms}
    log(f"export streaming decoder ({len(chunks)} chunks of {STREAM_CHUNK} "
        f"frames, lookback {lookback}, f32): every chunk's emitted ids "
        f"equal the live step's; launches none; {json.dumps(figs)}")
    return figs


def serving_debug(mt, main_inputs, weights):
    """One training step of the padded loss at the benchmark lattice with
    debug_space, debug_fwdbwd, check_fwd_bwd, debug_grads and debug_time
    on: each prints its line; row 2's betas reach emit_loss_debug and
    agree with ll_fwd (no mismatch). Returns the step's launches and its
    rows 1-2 calls' max |d| against the plain versions."""
    logits, labels, ilen, slen = main_inputs
    seen = []
    real = mt.fused.emit_loss_debug

    def keep(*a):
        seen.append(a)
        real(*a)

    flags = dict(debug_space=True, debug_fwdbwd=True, check_fwd_bwd=True,
                 debug_grads=True, debug_time=True)
    out = io.StringIO()
    x = logits.detach().clone().requires_grad_(True)
    mt.K.reset_launch_counts()
    mt.fused.emit_loss_debug = keep
    try:
        with mt.config_override(**flags), rows12_capture(mt, 0) as cap, \
                contextlib.redirect_stdout(out):
            costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen)
            (costs * weights).sum().backward()
            torch.cuda.synchronize()
    finally:
        mt.fused.emit_loss_debug = real
    launches = launched(mt.K)
    check(launches == LOSS_STEP,
          f"debug step launches {launches}")
    text = out.getvalue()
    for must in ("mrnnt space: pipeline=dp-fused-deferred-fwd",
                 "mrnnt space: pipeline=dp-fused-deferred-bwd",
                 "mrnnt fwdbwd: ll_fwd=", "mrnnt grads: min=",
                 "[mrnnt] monotonic_rnnt_loss[cuda]: "):
        check(must in text, f"debug flags: no line '{must}' in {text!r}")
    check("mismatch" not in text, f"debug flags: {text!r}")
    (ll_fwd, ll_bwd, _), = seen
    gap = float((ll_fwd - ll_bwd).abs().max())
    errs = compare_captured_rows12(mt, cap, "debug step")
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("mrnnt space", "[mrnnt]"))]
    log(f"debug flags on the card: {' | '.join(lines)}; fwdbwd and grads "
        f"lines printed, no mismatch; max |ll_fwd - ll_bwd| (row 2's "
        f"betas[:, 0, 0]) {gap:.3g}")
    return launches, errs


def run_serving(mt, gpu, main_inputs, weights, e2e):
    """The export path and the debug flags on the card: the provenance
    stamp; the cuda loss artifact at the padded lattice in f32 and bf16
    (bit for bit against the live loss, its row 1-2 calls held against the
    plain versions, timed against the live call in turns); the reference
    artifact; the greedy artifact at the model cell and the streaming
    artifact at the streaming cell against the live decoders; the debug
    flags on one training step. Returns (launches by path, max |d| by
    path, figures)."""
    t0 = time.perf_counter()
    log("provenance: " + json.dumps(mt.provenance.provenance_stamp(
        seed=SEED, device=DEVICE)))
    errs, figures = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        e, figures[dtype_name(dtype)] = serving_loss(mt, main_inputs, dtype,
                                                     e2e)
        errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
    serving_reference(mt)
    figures["greedy"] = serving_greedy(mt)
    torch.cuda.empty_cache()
    figures["stream"] = serving_stream(mt)
    torch.cuda.empty_cache()
    debug_launches, debug_errs = serving_debug(mt, main_inputs, weights)
    log(f"serving timing ({gpu}): " + json.dumps(figures))
    log(f"serving phase {time.perf_counter() - t0:.1f} s")
    launches = {"export": times(LOSS_STEP, 2),
                "export_debug": debug_launches}
    return (launches, {"export": errs, "export_debug": debug_errs},
            figures)


# --- traced routes: exported artifacts and compiled losses -----------------------

# Viterbi and the occupancies export with their torch loops over T unrolled
# into the graph, so their artifact is traced at a small T.
TRACED_ALIGN_CASE = (4, 64, 20, 256)        # B, T, S, V
# The fused-joint step's compile probe (B, T', S, V, H), chunk FUSED_CHUNK.
TRACED_PROBE_CASE = (2, 128, 16, 512, 64)


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def assert_equal(got, want, what):
    """Each output equal bit for bit (NaN cells the same cells)."""
    got, want = as_tuple(got), as_tuple(want)
    check(len(got) == len(want), f"{what}: {len(got)} outputs, not "
          f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        same = (g.shape == w.shape and g.dtype == w.dtype
                and torch.equal(torch.isnan(g), torch.isnan(w))
                and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)))
        check(same, f"{what}: output {i} differs from the live call (max "
              f"|d| {float((g.float() - w.float()).abs().max()):.3g})")


def launches_of(mt, fn):
    """fn()'s result, and the kernels it launched (the counts' change)."""
    before = dict(mt.K.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in mt.K.LAUNCHES.items()
                 if n != before[k]}


def traced_artifact(mt, what, export, live, args):
    """export() -> blob; import_fn; the artifact's call against live(*args)
    bit for bit. Neither export nor import launches a kernel, and the call
    launches what the live call does (not nothing: the route runs on the
    card's kernels). Returns (artifact, figures)."""
    want, want_launches = launches_of(mt, lambda: live(*args))
    check(bool(want_launches), f"{what}: the live call launched no kernel")
    t0 = time.perf_counter()
    blob, traced = launches_of(mt, export)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art, imported = launches_of(mt, lambda: mt.serving.import_fn(blob))
    import_s = time.perf_counter() - t0
    check(traced == {} and imported == {}, f"{what}: export launched "
          f"{traced}, import {imported}")
    got, got_launches = launches_of(mt, lambda: art(*args))
    check(got_launches == want_launches, f"{what}: the artifact launched "
          f"{got_launches}, the live call {want_launches}")
    assert_equal(got, want, what)
    return art, {"export_s": export_s, "import_s": import_s,
                 "blob_bytes": len(blob), "launches": want_launches}


def grad_step(fn, x, rest, weights):
    """fn(leaf, *rest): costs, and with weights the gradient of the
    weighted costs with respect to the leaf."""
    if weights is None:
        with torch.no_grad():
            return fn(x, *rest)
    leaf = x.detach().requires_grad_(True)
    costs = fn(leaf, *rest)
    grads, = torch.autograd.grad((costs * weights).sum(), leaf)
    return costs.detach(), grads


def traced_compile(mt, what, fn, x, rest, weights):
    """torch.compile(fn, fullgraph=True, backend='aot_eager'): its first
    call (the trace, then the run) launches what one eager call does, so
    tracing launched nothing; forward and backward equal eager bit for
    bit. Returns (the compiled step, figures)."""
    step = lambda f: grad_step(f, x, rest, weights)
    want, want_launches = launches_of(mt, lambda: step(fn))
    check(bool(want_launches), f"{what}: the eager call launched no kernel")
    compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
    t0 = time.perf_counter()
    got, got_launches = launches_of(mt, lambda: step(compiled))
    first_s = time.perf_counter() - t0
    check(got_launches == want_launches, f"{what}: the compiled call "
          f"(trace and run) launched {got_launches}, eager {want_launches}")
    assert_equal(got, want, what)
    return (lambda: step(compiled)), {"compile_first_call_s": first_s,
                                      "launches": want_launches}


def compile_probe(fn, args, what):
    """Whether torch.compile(fullgraph=True) of fn(*args) with a backward
    runs and equals eager bit for bit; the error's first line where it
    does not. Logged, not a check: JAX traces these routes whole, the port
    records where it does not yet (ROADMAP.md section 3)."""
    try:
        got = fn(torch.compile, *args)
        torch.cuda.synchronize()
        assert_equal(got, fn(None, *args), what)
        verdict = "compiles fullgraph, forward and backward bit for bit"
    except Exception as exc:    # noqa: BLE001 - the probe reports any error
        verdict = (f"does not compile fullgraph: {type(exc).__name__}: "
                   + str(exc).strip().splitlines()[0])
    torch._dynamo.reset()
    log(f"traced routes probe: {what} {verdict}")
    return verdict


def fused_joint_probe(mt, case, compile_fn):
    """A weighted training step of the fused-joint loss: eager, or through
    compile_fn (torch.compile with fullgraph)."""
    args = (case["labels"], case["ilen"], case["slen"])
    keys = tuple(case["params"])

    def loss(enc, *vals):
        return mt.rnnt_loss_fused_joint(enc, case["pred"], *args, joint_full,
                                        dict(zip(keys, vals)),
                                        chunk_t=FUSED_CHUNK)

    fn = loss if compile_fn is None else compile_fn(
        loss, fullgraph=True, backend="aot_eager")
    leaves = [t.detach().requires_grad_(True)
              for t in (case["enc"], *case["params"].values())]
    costs = fn(*leaves)
    return (costs.detach(), *torch.autograd.grad(costs.sum(), leaves))


def sharded_probe(mt, main_inputs, weights, compile_fn):
    """rnnt_loss_vocab_sharded on a one-rank gloo group: costs and the
    gradient of the weighted costs."""
    logits, labels, ilen, slen = main_inputs
    bands = mt.bands.default_bands(ilen, slen, logits.shape[1])
    with one_rank_group() as group:
        def loss(x):
            return mt.sharding.rnnt_loss_vocab_sharded(
                x, labels, ilen, slen, bands.min_s, bands.max_s, 0, group)
        fn = loss if compile_fn is None else compile_fn(
            loss, fullgraph=True, backend="aot_eager")
        return grad_step(fn, logits, (), weights)


def phase_traced_routes(mt, gpu, main_inputs, weights, band_case):
    """The kernel routes as one traced graph, as JAX's jax.export and
    jax.jit take them. (a) Artifacts (export, import, call; bit for bit
    with the live call): the banded kernel route's costs and grads, and its
    cost-only costs, at the banded case; the fused-joint loss's cost-only
    forward at memory_bench's cell; Viterbi and the occupancies at
    TRACED_ALIGN_CASE. (b) torch.compile(fullgraph, aot_eager) of
    monotonic_rnnt_loss and of monotonic_rnnt_loss_banded (forward and
    backward), and of the fused-joint forward, each bit for bit with
    eager. (c) No
    trace launches a kernel. (d) Every kernel call of the phase is held
    against its plain version (Hold at the operators' CUDA
    implementations). Then probes (logged): the fused-joint training step
    and the vocab-sharded loss under fullgraph compile. Last, outside the
    Hold, each artifact and compiled call timed in turns with its live
    call. Returns (launches by path, max |d| by path, figures)."""
    t0 = time.perf_counter()
    logits, labels, ilen, slen = main_inputs
    figs, timed = {}, {}
    bands = band_case["bands"]
    band_args = (band_case["logits_band"], band_case["labels"],
                 band_case["ilen"], band_case["slen"], bands.min_s,
                 bands.max_s)
    fcase = fused_case(mt, *FUSED_CASE)
    fkeys = tuple(fcase["params"])
    f_args = (fcase["enc"], fcase["pred"], fcase["labels"], fcase["ilen"],
              fcase["slen"], *fcase["params"].values())

    def banded_live(x, lab, il, sl, lo, hi):
        return mt.cuda_banded.rnnt_loss_banded_cuda(
            x, lab, il, sl, mt.bands.Bands(lo, hi))

    def banded_cost_only(x, lab, il, sl, lo, hi):
        return mt.cuda_banded.rnnt_loss_banded_cuda(
            x, lab, il, sl, mt.bands.Bands(lo, hi), with_grads=False)[0]

    def fused_forward(enc, pred, lab, il, sl, *vals):
        with torch.no_grad():
            return mt.rnnt_loss_fused_joint(enc, pred, lab, il, sl,
                                            joint_full,
                                            dict(zip(fkeys, vals)),
                                            chunk_t=FUSED_CHUNK)

    def alignment(x, lab, il, sl):
        vit = mt.viterbi_alignment(x, lab, il, sl)
        return (vit.alignment, vit.score,
                mt.occupancy_posteriors(x, lab, il, sl))

    align_args = make_inputs(*TRACED_ALIGN_CASE, seed=SEED + 5, device=DEVICE)
    K = mt.K
    K.reset_launch_counts()
    with Hold(mt, "traced") as hold:
        for name, fn, args in (("banded_export", banded_live, band_args),
                               ("banded_cost_only_export", banded_cost_only,
                                band_args),
                               ("fused_joint_forward_export", fused_forward,
                                f_args),
                               ("alignment_export", alignment, align_args)):
            art, figs[name] = traced_artifact(
                mt, name, lambda fn=fn, args=args: mt.serving.export_fn(
                    fn, args), fn, args)
            timed[name] = [lambda art=art, args=args: art(*args),
                           lambda fn=fn, args=args: fn(*args)]
        banded_public = lambda x, *a: mt.monotonic_rnnt_loss_banded(
            x, *a, bands=bands)
        for name, fn, x, rest, w in (
                ("deferred_compile", mt.monotonic_rnnt_loss, logits,
                 (labels, ilen, slen), weights),
                ("banded_compile", banded_public, band_case["logits_band"],
                 band_args[1:4], weights[:2]),
                ("fused_joint_forward_compile",
                 lambda enc, *a: fused_forward(enc, *a), fcase["enc"],
                 f_args[1:], None)):
            step, figs[name] = traced_compile(mt, name, fn, x, rest, w)
            timed[name] = [step, lambda fn=fn, x=x, rest=rest, w=w:
                           grad_step(fn, x, rest, w)]
        torch.cuda.synchronize()
    launches = launched(K)
    held_s = time.perf_counter() - t0
    for name, (traced, live) in timed.items():
        reps = 5 if name.startswith(("fused", "alignment")) else 10
        figs[name]["ms"], figs[name]["live_ms"] = turns_ms([traced, live],
                                                           reps=reps,
                                                           warmup=2)
    del timed
    torch._dynamo.reset()
    K.reset_launch_counts()
    probe_case = fused_case(mt, *TRACED_PROBE_CASE)
    probe = lambda c: fused_joint_probe(mt, probe_case, c)
    with hold:
        probes = {"fused_joint_step": compile_probe(
            probe, (), "the fused-joint training step")}
        config = getattr(torch._dynamo.config, "trace_autograd_ops", None)
        if config is not None:
            torch._dynamo.config.trace_autograd_ops = True
            try:
                probes["fused_joint_step_trace_autograd_ops"] = compile_probe(
                    probe, (), "the fused-joint training step with "
                    "torch._dynamo.config.trace_autograd_ops = True")
            finally:
                torch._dynamo.config.trace_autograd_ops = config
        probes["vocab_sharded_step"] = compile_probe(
            lambda c: sharded_probe(mt, main_inputs, weights, c), (),
            "rnnt_loss_vocab_sharded on a one-rank gloo group")
        torch.cuda.synchronize()
    for row, n in launched(K).items():
        launches[row] = launches.get(row, 0) + n
    check(hold.calls == launches, f"traced routes: held calls {hold.calls}, "
          f"launches {launches}")
    figs["probes"] = probes
    figs["phase_s"] = time.perf_counter() - t0
    figs["held_part_s"] = held_s
    log(f"traced routes ({gpu}): " + json.dumps(figs))
    log(f"traced routes: every artifact and compiled loss equals its live "
        f"call bit for bit; no trace launched a kernel; launches {launches},"
        f" each held against its plain version: max |d| "
        + json.dumps(hold.errs) + f"; phase {figs['phase_s']:.1f} s")
    return {"traced": launches}, {"traced": hold.errs}, figs


# --- the sharded losses ---------------------------------------------------------

SHARDED_WORLD = 4
SHARDED_TIMEOUT_S = 420        # the parent's wait on its ranks
SHARDED_GROUP_TIMEOUT_S = 180  # a rank's wait on the others, per collective
SHARDED_BLANK = 501            # a blank on shard 2 of (1, 4) at V = 1000
LOGITS_SPEC = ("data", None, None, "model")
# The joint's output projection sharded over 'model' (tests/test_parallel.py:195);
# enc and pred split over 'data'.
JOINT_SPECS = {"we": (), "wp": (), "wv": (None, "model"), "bv": ("model",)}
INPUT_SPECS = {"enc": ("data", None, None), "pred": ("data", None, None),
               **JOINT_SPECS}
LEAF_SPECS = {f"d_{k}": spec for k, spec in INPUT_SPECS.items()}


RANK_CHECKS = {}   # a rank's measured errors, by check, for the parent


def record(what: str, err: float) -> None:
    RANK_CHECKS[what] = max(RANK_CHECKS.get(what, 0.0), float(err))


def partial_vs_plain(mt, x, what) -> float:
    """softmax_stats_partial against its plain version: m exact, se |d| <=
    1e-5 + 1e-6|ref|; an all -inf row gives m = -inf, se = 0."""
    m, se = mt.SK.softmax_stats_partial(x)
    m_p, se_p = mt.SK.softmax_stats_partial_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(m, m_p), f"{what}: m differs from the plain version")
    return assert_close(se, se_p, 1e-5, 1e-6, f"{what} se")


def rank_partial_kernel(mt, mesh, logits):
    """This rank's shard of the padded lattice (f32, bf16), then V_local =
    1, 250, 500 and 4096 with all -inf rows; returns the max |d| of se."""
    x = mt.par.local_shard(logits, LOGITS_SPEC, mesh)
    errs = [partial_vs_plain(mt, x.to(d), f"shard {list(x.shape)} {d}")
            for d in (torch.float32, torch.bfloat16)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    for v in (1, 250, 500, 4096):
        x = torch.randn((4, 50, 51, v), generator=gen, device=DEVICE) * 2
        x[0, 7] = float("-inf")
        x[1, :, 3] = float("-inf")
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            errs.append(partial_vs_plain(mt, xd, f"V_local={v} {dtype}"))
            m, se = mt.SK.softmax_stats_partial(xd)
            check(bool((m[0, 7] == float("-inf")).all())
                  and bool((se[0, 7] == 0).all()),
                  f"V_local={v}: an all -inf row must give m -inf, se 0")
    return max(errs)


def rows_of(par, mesh, n):
    start, size = par.local_batch_slice(n, mesh)
    return slice(start, start + size)


def tp_padded(mt, mesh, inputs, dtype, blank, weights, global_costs, what,
              capture=False):
    """make_dp_tp_loss on this rank's shard: a training step of the mean
    (launch counts read after it), a cost-only call, and a weighted step
    through rnnt_loss_vocab_sharded; each against the single-process port
    route on this rank's batch slice and full V (the loss is batch-
    separable). Returns (launches of the step, summary)."""
    K, par = mt.K, mt.par
    logits, labels, ilen, slen = inputs
    lg = logits.to(dtype)
    n_b = lg.shape[0]
    rows = rows_of(par, mesh, n_b)
    lb, il, sl, w = labels[rows], ilen[rows], slen[rows], weights[rows]
    loss_fn = par.make_dp_tp_loss(mesh, blank_id=blank)
    x = leaf(par.local_shard(lg, LOGITS_SPEC, mesh), dtype)
    caps = (Capture(mt.collective, {"softmax_stats_partial": {0}}),
            Capture(mt.sharding, {"fwdbwd_scan": {0}, "grad_pass": {0}})
            ) if capture else ()
    K.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for cap in caps:
            stack.enter_context(cap)
        loss = loss_fn(x, lb, il, sl)
        loss.backward()
        torch.cuda.synchronize()
    step = launched(K)
    K.reset_launch_counts()
    with torch.no_grad():
        loss_c = loss_fn(x, lb, il, sl)
    torch.cuda.synchronize()
    cost_only = launched(K)
    check(step == {"softmax_stats_partial": 1, "fwdbwd_scan": 1,
                   "grad_pass": 1}, f"{what}: training step launches {step}")
    check(cost_only == {"softmax_stats_partial": 1, "alpha_scan": 1},
          f"{what}: cost-only launches {cost_only}")
    loss = loss.detach()
    check(float(loss_c) == float(loss), f"{what}: cost-only {float(loss_c)} "
          f"!= training {float(loss)}")
    xw = leaf(x, dtype)
    bands = mt.bands.default_bands(il, sl, lg.shape[1])
    costs = par.rnnt_loss_vocab_sharded(xw, lb, il, sl, bands.min_s,
                                        bands.max_s, blank, mesh.model_group)
    (costs * w).sum().backward()
    v0 = mesh.model_index * x.shape[3]
    cols = slice(v0, v0 + x.shape[3])
    g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-3
    errs = {}
    for name, cot, got in (("mean", 1.0 / n_b, x.grad),
                           ("weighted", w, xw.grad)):
        xr = leaf(lg[rows], dtype)
        ref = mt.monotonic_rnnt_loss(xr, lb, il, sl, blank_id=blank)
        (ref * cot).sum().backward()
        errs[f"{name}_grads"] = assert_close(
            got, xr.grad[..., cols], 1e-6, g_rtol, f"{what} {name} grads")
        del xr
    errs["costs"] = assert_close(costs, ref, 1e-4, 1e-5, f"{what} costs")
    if global_costs is None:
        check(mesh.data == 1, "the rank's slice is the global batch")
        global_costs = ref.detach()
    mean = global_costs.double().mean()
    errs["loss"] = abs(float(loss) - float(mean))
    check(errs["loss"] <= 1e-4 + 1e-5 * abs(float(mean)),
          f"{what}: loss {float(loss)!r} vs the single-process mean "
          f"{float(mean)!r}")
    path_errs = {}
    for cap in caps:
        path_errs.update(compare_captured(mt, cap, what))
    for k, v in errs.items():
        record(f"{what} {k}", v)
    log(f"{what}: launches step {step}, cost-only {cost_only}; vs the "
        "single-process route max|d| " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))
    return step, path_errs


def dp_case(mt, mesh, inputs, global_costs):
    """make_data_parallel_loss (a training step, its rows 1-2 calls kept
    and held against their plain versions) and make_per_sample_loss on the
    data axis, against the parent's single-process costs. Returns
    (launches of the step, max |d| per wrapper)."""
    K, par = mt.K, mt.par
    logits, labels, ilen, slen = inputs
    rows = rows_of(par, mesh, logits.shape[0])
    args = (labels[rows], ilen[rows], slen[rows])
    x = leaf(logits[rows], torch.float32)
    K.reset_launch_counts()
    with rows12_capture(mt, 0) as cap:
        loss = par.make_data_parallel_loss(mesh)(x, *args)
        loss.backward()
    torch.cuda.synchronize()
    step = launched(K)
    check(step == LOSS_STEP,
          f"data-parallel step launches {step}")
    with torch.no_grad():
        per = par.make_per_sample_loss(mesh)(logits[rows], *args)
    ref = global_costs[rows]
    rel = float(((per - ref).abs() / ref.abs()).max())
    mean = float(global_costs.double().mean())
    rel_mean = abs(float(loss.detach()) - mean) / abs(mean)
    record("data-parallel (4,1) per-sample costs relative", rel)
    record("data-parallel (4,1) mean relative", rel_mean)
    check(rel <= 1e-6 and rel_mean <= 1e-6,
          f"data-parallel costs relative error {rel:.3g}, mean {rel_mean:.3g}")
    log(f"data-parallel (4,1): launches {step}; per-sample costs vs the "
        f"single-process ones, relative {rel:.3g}; mean {rel_mean:.3g}")
    return step, compare_captured_rows12(mt, cap, "data-parallel (4,1)")


def tp_banded(mt, mesh, case, dtype, capture=False):
    """make_dp_tp_banded_loss on this rank's shard of the packed band
    tensor: a training step of the mean and a cost-only call, against
    monotonic_rnnt_loss_banded on this rank's batch slice. With `capture`,
    the step's kernel calls are held against their plain versions.
    Returns (launches of the step, max |d| per wrapper)."""
    K, par = mt.K, mt.par
    band = case["logits_band"].to(dtype)
    n_b = band.shape[0]
    rows = rows_of(par, mesh, n_b)
    args = (case["labels"][rows], case["ilen"][rows], case["slen"][rows])
    bmin, bmax = case["band_min"][rows], case["band_max"][rows]
    loss_fn = par.make_dp_tp_banded_loss(mesh)
    x = leaf(par.local_shard(band, LOGITS_SPEC, mesh), dtype)
    caps = (Capture(mt.collective, {"softmax_stats_partial": {0}}),
            Capture(mt.sharding, {"fwdbwd_scan_banded": {0},
                                  "grad_pass": {0}})) if capture else ()
    K.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for cap in caps:
            stack.enter_context(cap)
        loss = loss_fn(x, *args, bmin, bmax)
        loss.backward()
        torch.cuda.synchronize()
    step = launched(K)
    K.reset_launch_counts()
    with torch.no_grad():
        loss_c = loss_fn(x, *args, bmin, bmax)
    torch.cuda.synchronize()
    cost_only = launched(K)
    what = f"banded TP (2,2) {dtype}"
    check(step == {"softmax_stats_partial": 1, "fwdbwd_scan_banded": 1,
                   "grad_pass": 1}, f"{what}: step launches {step}")
    check(cost_only == {"softmax_stats_partial": 1, "alpha_scan_banded": 1},
          f"{what}: cost-only launches {cost_only}")
    loss = loss.detach()
    check(float(loss_c) == float(loss), f"{what}: cost-only differs")
    xr = leaf(band[rows], dtype)
    ref = mt.monotonic_rnnt_loss_banded(xr, *args,
                                        bands=mt.bands.Bands(bmin, bmax))
    (ref / n_b).sum().backward()
    v0 = mesh.model_index * x.shape[3]
    ref_g = xr.grad[..., v0:v0 + x.shape[3]]
    e_g = float((x.grad.float() - ref_g.float()).abs().max())
    if dtype == torch.bfloat16:
        assert_close(x.grad, ref_g, 1e-6, 1.6e-2, f"{what} grads")
        rel = None
    else:
        # At T=1600 the alphas reach ~1.1e4 (f32 ulp ~1e-3), so two f32
        # routes whose statistics round otherwise differ by up to a few
        # 1e-3 in an occupancy exponent: relative L2, as the fused-joint
        # losses (the module docstring's fused-joint tolerance).
        rel = rel_l2(x.grad, ref_g)
        check(rel <= 2e-3, f"{what} grads: relative L2 {rel:.3g} > 2e-3")
    mean = float(case["costs"][str(dtype)].double().mean())
    e_l = abs(float(loss) - mean)
    check(e_l <= 1e-4 + 1e-5 * abs(mean), f"{what}: loss {float(loss)!r} vs "
          f"the single-process mean {mean!r}")
    record(f"{what} loss", e_l)
    record(f"{what} grads max|d|", e_g)
    if rel is not None:
        record(f"{what} grads relative L2", rel)
    log(f"{what} [{list(x.shape)} a rank]: launches step {step}, cost-only "
        f"{cost_only}; loss vs single-process |d| {e_l:.3g}, grads max|d| "
        f"{e_g:.3g}" + (f", relative L2 {rel:.3g}" if rel is not None else ""))
    path_errs = {}
    for cap in caps:
        path_errs.update(compare_captured(mt, cap, what))
    return step, path_errs


def tp_fused(mt, mesh, case, banded):
    """The fused-joint TP loss on (2,2): a training step of the mean from
    fresh leaves (launches read after the forward and after the step, peak
    memory), against the parent's single-process step; then one more step
    whose kernel calls (fused_joint_capture's) are kept and held against
    their plain versions. Returns (launches, path errs, summary)."""
    K, par = mt.K, mt.par
    t = case["enc"].shape[1]
    n_chunks = -(-t // FUSED_CHUNK)
    rows = rows_of(par, mesh, case["enc"].shape[0])
    args = (case["labels"][rows], case["ilen"][rows], case["slen"][rows])
    if banded:
        loss_fn = par.make_dp_tp_fused_banded_loss(
            mesh, joint_banded, JOINT_SPECS, band_width=case["w"],
            chunk_t=FUSED_CHUNK)
        tail = (case["band_min"][rows], case["band_max"][rows])
        alpha, beta, module = "alpha_scan_banded", "fwdbwd_scan_banded", \
            mt.chunked_banded
    else:
        loss_fn = par.make_dp_tp_fused_loss(mesh, joint_full, JOINT_SPECS,
                                            chunk_t=FUSED_CHUNK)
        tail = ()
        alpha, beta, module = "alpha_scan", "beta_scan", mt.chunked
    what = f"{'banded ' if banded else ''}fused-joint TP (2,2)"

    def step():
        e, p = (leaf(par.local_shard(case[k], INPUT_SPECS[k], mesh),
                     torch.float32) for k in ("enc", "pred"))
        pr = {k: leaf(par.local_shard(v, JOINT_SPECS[k], mesh), torch.float32)
              for k, v in case["params"].items()}
        K.reset_launch_counts()
        loss = loss_fn(e, p, *args, pr, *tail)
        torch.cuda.synchronize()
        fwd = launched(K)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), [e.grad, p.grad] + [pr[k].grad for k in pr], \
            fwd, launched(K)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, grads, fwd, launches = step()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check(fwd == {"softmax_stats_partial": n_chunks, alpha: 1},
          f"{what}: forward launches {fwd}")
    check(launches == {"softmax_stats_partial": 2 * n_chunks, alpha: 1,
                       beta: n_chunks, "grad_pass": n_chunks},
          f"{what}: step launches {launches}")
    mean = float(case["ref_costs"].double().mean())
    e_l = abs(float(loss) - mean)
    check(e_l <= 1e-4 + 1e-5 * abs(mean),
          f"{what}: loss {float(loss)!r} vs the single-process {mean!r}")
    record(f"{what} loss", e_l)
    # Squared error and norm of each leaf's shard against the same shard of
    # the single-process gradient; the parent sums them over the shards.
    sq = {}
    for name, g in zip(JOINT_GRADS, grads):
        check(bool(torch.isfinite(g).all()), f"{what}: {name} finite")
        r = par.local_shard(case["ref_grads"][name], LEAF_SPECS[name], mesh)
        sq[name] = [float((g.double() - r.double()).pow(2).sum()),
                    float(r.double().pow(2).sum())]
    del grads
    caps = fused_joint_capture(module, n_chunks, beta, alpha,
                               stats=(mt.collective, "softmax_stats_partial"))
    with caps[0], caps[1]:
        step()
    path_errs = {}
    for cap in caps:
        path_errs.update(compare_captured(mt, cap, what))
    del caps
    torch.cuda.empty_cache()
    log(f"{what}: launches fwd {fwd}, step {launches}; loss vs the single-"
        f"process route |d| {e_l:.3g}; peak memory of the step "
        f"{peak / 2**30:.3f} GiB above its inputs; step {step_s * 1e3:.1f} ms"
        " (4 ranks sharing one card)")
    return launches, path_errs, {"sq": sq, "peak_bytes": peak,
                                 "step_ms_4_ranks_one_card": step_s * 1e3,
                                 "loss": float(loss)}


SHARDED_TRAIN_LAYERS = 1   # the model cell's widths, one Conformer block
SHARDED_TRAIN_STEPS = 2    # the first has lr 0


def save_train_reference(mt, tmp):
    """The single-process train_step run the ranks' train steps are held
    against: SHARDED_TRAIN_STEPS steps of the model cell at
    SHARDED_TRAIN_LAYERS layers from seed 0, its (loss, grad_norm) and the
    parameters after them."""
    state = train_state(mt, torch.float32, DEVICE,
                        layers=SHARDED_TRAIN_LAYERS)
    metrics = train_steps(mt, state, model_batch(DEVICE),
                          SHARDED_TRAIN_STEPS)
    torch.save({"metrics": metrics, "params": {
        n: p.cpu() for n, p in snapshot(state).items()}}, tmp / "train.pt")


def rank_train_steps(mt, meshes, tmp):
    """make_sharded_train_step on (4,1) and make_tp_sharded_train_step
    (chunk TRAIN_CHUNK) on (2,2), SHARDED_TRAIN_STEPS steps each from the
    reference's weights: the launches of each step, the losses (|d| <=
    1e-4 + 1e-5|ref|) and grad_norms (1e-3 relative) against the
    single-process run, and this rank's parameters (its shard of the vocab
    projection) by relative L2 (each shard within the bound keeps the
    whole leaf within it): DP at TRAIN_PARAM_REL, TP at
    TRAIN_FUSED_PARAM_REL (the fused-joint route). The first step's kernel
    calls (rows 1-2 for DP; for TP fused_joint_capture's chunks, the stats
    by softmax_stats_partial) are held against their plain versions.
    Returns (launches, max |d|) by path."""
    ref = torch.load(tmp / "train.pt", map_location=DEVICE)
    batch = model_batch(DEVICE)
    t_enc = int(mt.models.conformer.subsampled_length(
        model_config(mt, torch.float32).encoder, MODEL_BATCH[1]))
    n_chunks = -(-t_enc // TRAIN_CHUNK)
    cases = {
        "train_dp": ((4, 1), TRAIN_PARAM_REL, LOSS_STEP),
        "train_tp": ((2, 2), TRAIN_FUSED_PARAM_REL,
                     {"softmax_stats_partial": 2 * n_chunks, "alpha_scan": 1,
                      "beta_scan": n_chunks, "grad_pass": n_chunks})}
    launches, path_errs = {}, {}
    for name, (shape, rel, want) in cases.items():
        mesh = meshes[shape]
        state = train_state(mt, torch.float32, DEVICE,
                            layers=SHARDED_TRAIN_LAYERS)
        if name == "train_dp":
            step = mt.train.make_sharded_train_step(mesh)
            caps = (rows12_capture(mt, 0),)
        else:
            state = mt.train.shard_train_state(state, mesh)
            step = mt.train.make_tp_sharded_train_step(
                mesh, state.model, chunk_t=TRAIN_CHUNK)
            caps = fused_joint_capture(mt.chunked, n_chunks, stats=(
                mt.collective, "softmax_stats_partial"))
        what = f"{name} {shape}"
        with contextlib.ExitStack() as stack:
            for cap in caps:
                stack.enter_context(cap)
            got = train_steps(mt, state, batch, 1, step=step, launches=want)
        got += train_steps(mt, state, batch, SHARDED_TRAIN_STEPS - 1,
                           step=step, launches=want)
        path_errs[name] = {}
        for cap in caps:
            path_errs[name].update(
                compare_captured_rows12(mt, cap, f"{what} step 1")
                if name == "train_dp"
                else compare_captured(mt, cap, f"{what} step 1"))
        del caps
        for (loss, norm), (r_loss, r_norm) in zip(got, ref["metrics"]):
            e_l, e_n = abs(loss - r_loss), abs(norm - r_norm) / r_norm
            check(e_l <= 1e-4 + 1e-5 * abs(r_loss) and e_n <= 1e-3,
                  f"{what}: (loss, grad_norm) {got} vs {ref['metrics']}")
            record(f"{what} loss |d|", e_l)
            record(f"{what} grad_norm relative", e_n)
        specs = mt.train.transducer_tp_specs(state.model)
        refs = {n: (mt.par.local_shard(p, specs[n], mesh)
                    if name == "train_tp" else p)
                for n, p in ref["params"].items()}
        errs = compare_params(mt, snapshot(state), refs, what, rel,
                              train_lrs(mt, SHARDED_TRAIN_STEPS))
        plain = {k: v for k, v in errs.items() if not k.endswith("key.bias")}
        record(f"{what} params relative L2 (of {rel})", max(plain.values()))
        log(f"{what}: launches a step {want}; losses {got} vs the single-"
            f"process run's {ref['metrics']}; " + share_line(errs, rel))
        launches[name] = want
        del state
    return launches, path_errs


def run_rank(mt, rank, tmp):
    """Everything one rank of run_sharded runs; returns its results."""
    par = mt.par
    meshes = {shape: par.make_mesh(*shape, device=DEVICE)
              for shape in ((2, 2), (1, 4), (4, 1))}
    padded = torch.load(tmp / "padded.pt", map_location=DEVICE)
    inputs = make_inputs(B, T, S, V, seed=SEED, t_range=(3 * T // 4, T),
                         s_range=(3 * S // 5, S), device=DEVICE)
    weights = torch.linspace(-0.5, 2.0, B, device=DEVICE)
    out = {"launches": {}, "errs": {}, "fused": {}}
    out["partial_kernel_err"] = rank_partial_kernel(mt, meshes[2, 2],
                                                    inputs[0])
    path_errs = {}
    for shape in ((2, 2), (1, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            first = shape == (2, 2) and dtype == torch.float32
            launches, errs = tp_padded(
                mt, meshes[shape], inputs, dtype, 0, weights,
                padded["costs"][str(dtype)], f"padded TP {shape} {dtype}",
                capture=first)
            if first:
                out["launches"]["tp_padded"] = launches
                path_errs["tp_padded"] = errs
    blank_inputs = make_inputs(B, T, S, V, blank=SHARDED_BLANK,
                               seed=SEED, t_range=(3 * T // 4, T),
                               s_range=(3 * S // 5, S), device=DEVICE)
    tp_padded(mt, meshes[1, 4], blank_inputs, torch.float32, SHARDED_BLANK,
              weights, None, f"padded TP (1, 4) blank {SHARDED_BLANK}")
    del blank_inputs
    out["launches"]["dp"], path_errs["dp"] = dp_case(
        mt, meshes[4, 1], inputs, padded["costs"][str(torch.float32)])
    del inputs, padded
    torch.cuda.empty_cache()
    banded = torch.load(tmp / "banded.pt", map_location=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        first = dtype == torch.float32
        launches, errs = tp_banded(mt, meshes[2, 2], banded, dtype,
                                   capture=first)
        if first:
            out["launches"]["tp_banded"] = launches
            path_errs["tp_banded"] = errs
    del banded
    for name, banded in (("tp_fused", False), ("tp_fused_banded", True)):
        case = torch.load(tmp / f"{name}.pt", map_location=DEVICE)
        launches, errs, summary = tp_fused(mt, meshes[2, 2], case, banded)
        out["launches"][name] = launches
        path_errs[name] = errs
        out["fused"][name] = summary
        del case
        torch.cuda.empty_cache()
    train_launches, train_errs = rank_train_steps(mt, meshes, tmp)
    out["launches"].update(train_launches)
    out["errs"] = {**path_errs, **train_errs}
    out["checks"] = RANK_CHECKS
    out["mesh_index"] = {"data": meshes[2, 2].data_index,
                         "model": meshes[2, 2].model_index}
    return out


def sharded_rank_main(rank: int, world: int, tmp: Path) -> int:
    """One rank of run_sharded (this script run with --sharded-rank)."""
    global LOG_PREFIX
    LOG_PREFIX = f"[rank {rank}] "
    mt = _Port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import torch.distributed as dist

    mt.par.initialize_multihost(f"file://{tmp / 'rendezvous'}", world, rank,
                                backend="gloo",
                                timeout_s=SHARDED_GROUP_TIMEOUT_S)
    try:
        out = run_rank(mt, rank, tmp)
    finally:
        dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def save_sharded_inputs(mt, tmp, banded_case, costs):
    """What the ranks read: the parent's single-process costs, the packed
    band tensor of the banded case, and each fused case with the
    single-process step's costs and gradients of the mean."""
    cpu = lambda d: {k: v.cpu() if torch.is_tensor(v) else v  # noqa: E731
                     for k, v in d.items()}
    torch.save({"costs": {str(d): c.cpu() for d, c in costs.items()}},
               tmp / "padded.pt")
    torch.save(cpu(banded_case), tmp / "banded.pt")
    for name, make, joint in (("tp_fused", fused_case, joint_full),
                              ("tp_fused_banded", fused_banded_case,
                               joint_banded)):
        if name == "tp_fused":
            case = make(mt, *FUSED_CASE)
            loss = lambda e, p, pr: mt.rnnt_loss_fused_joint(  # noqa: E731
                e, p, case["labels"], case["ilen"], case["slen"], joint, pr,
                chunk_t=FUSED_CHUNK)
        else:
            case = make(mt, *FUSED_BANDED_CASE, BAND_SHIFT)
            case["band_min"], case["band_max"] = case.pop("bands")
            loss = lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(  # noqa
                e, p, case["labels"], case["ilen"], case["slen"], joint, pr,
                bands=mt.bands.Bands(case["band_min"], case["band_max"]),
                band_width=case["w"], chunk_t=FUSED_CHUNK)
        n_b = case["enc"].shape[0]
        ref_costs, ref_grads, _, _ = joint_step(
            mt, loss, case, torch.full((n_b,), 1.0 / n_b, device=DEVICE))
        case.update(ref_costs=ref_costs,
                    ref_grads=dict(zip(JOINT_GRADS, ref_grads)))
        case["params"] = cpu(case["params"])
        case["ref_grads"] = cpu(case["ref_grads"])
        torch.save(cpu(case), tmp / f"{name}.pt")
        del case, ref_grads
        torch.cuda.empty_cache()


def spawn_ranks(tmp):
    """Starts the ranks, one process each on the one card; fails as soon as
    one fails, or when they pass SHARDED_TIMEOUT_S, and stops them all."""
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(SHARDED_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
         str(r), str(SHARDED_WORLD), str(tmp)],
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(SHARDED_WORLD)]
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for line in (tmp / "rank0.log").read_text().splitlines():
        log(line)
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        for r in bad:
            log(f"--- rank {r} exited {procs[r].returncode}:\n"
                + (tmp / f"rank{r}.log").read_text()[-4000:])
        raise CheckFailed(f"sharded ranks {bad} failed or passed "
                          f"{SHARDED_TIMEOUT_S} s")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(SHARDED_WORLD)]


def phase_partial_timing(mt):
    """softmax_stats_partial at a rank's padded shard on a (2,2) mesh,
    [16, 200, 51, 500], single process: the kernel (median of 20), its
    bound, its plain version (once) and torch.logsumexp."""
    SK = mt.SK
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x32 = torch.randn((B // 2, T, S + 1, V // 2), generator=gen,
                      device=DEVICE) * 2
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        rows = x.numel() // x.shape[-1]
        out[dtype] = {
            "ms": cuda_ms(lambda: SK.softmax_stats_partial(x)),
            "plain_ms": cuda_ms(lambda: SK.softmax_stats_partial_plain(x),
                                reps=1, warmup=1),
            "queued_ms": queued_ms(lambda: SK.softmax_stats_partial(x)),
            "library_ms": cuda_ms(lambda: torch.logsumexp(x, dim=-1)),
            "bound": bound_ms(x.numel() * x.element_size() + 2 * rows * 4,
                              4 * x.numel())}
        del x
    log("softmax_stats_partial timing at [%d,%d,%d,%d]: " % tuple(x32.shape)
        + "; ".join(f"{d} {r['ms']:.4f} ms (bound {r['bound'][0]:.4f}, plain "
                    f"{r['plain_ms']:.4f}, logsumexp {r['library_ms']:.4f})"
                    for d, r in out.items()))
    del x32
    torch.cuda.empty_cache()
    return out


def run_sharded(mt, banded_case, costs):
    """The sharded losses on 4 ranks sharing the one card, a gloo group
    (NCCL takes one rank per card); returns each path's launches (rank 0's)
    and kernel errors, and softmax_stats_partial's JSON entry."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mrnnt_sharded_") as tmp:
        tmp = Path(tmp)
        save_sharded_inputs(mt, tmp, banded_case, costs)
        save_train_reference(mt, tmp)
        t_saved = time.perf_counter() - t0
        ranks = spawn_ranks(tmp)
    for name in ("tp_fused", "tp_fused_banded"):
        losses = {r["fused"][name]["loss"] for r in ranks}
        check(len(losses) == 1, f"{name}: the ranks' losses differ {losses}")
        # Each leaf's global relative L2 from the shards that hold it once:
        # enc and pred by data index, wv and bv by model index, we and wp
        # whole on every rank.
        rel = {}
        for leaf_name, spec in LEAF_SPECS.items():
            owners = [r for r in ranks
                      if all(r["mesh_index"][ax] == 0
                             for ax in ("data", "model") if ax not in spec)]
            d2, r2 = (sum(r["fused"][name]["sq"][leaf_name][i] for r in owners)
                      for i in (0, 1))
            rel[leaf_name] = (d2 / r2) ** 0.5
            check(rel[leaf_name] <= 2e-3, f"{name} {leaf_name}: relative L2 "
                  f"{rel[leaf_name]:.3g} > 2e-3 against the single-process "
                  "route")
        log(f"{name}: gradients vs the single-process route, relative L2 "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + "; peak GiB per rank " + ", ".join(
                f"{r['fused'][name]['peak_bytes'] / 2**30:.3f}"
                for r in ranks) + " (single-process fused-joint 1.278); "
            "step ms per rank (4 ranks sharing one card) " + ", ".join(
                f"{r['fused'][name]['step_ms_4_ranks_one_card']:.1f}"
                for r in ranks))
    log("sharded checks, the max over the 4 ranks: " + "; ".join(
        f"{k} {max(r['checks'][k] for r in ranks):.3g}"
        for k in ranks[0]["checks"]))
    launches = ranks[0]["launches"]
    errs = {path: {k: max(r["errs"][path][k] for r in ranks)
                   for k in ranks[0]["errs"][path]}
            for path in ranks[0]["errs"]}
    partial_err = max(r["partial_kernel_err"] for r in ranks)
    timing = phase_partial_timing(mt)
    f32, b16 = timing[torch.float32], timing[torch.bfloat16]
    entry = {
        "name": "softmax_stats_partial", "route": "cuda",
        "source": "monotonic_rnnt_tpu_torch/csrc/split.cu",
        "replaces": "monotonic_rnnt_tpu/ops/pallas/kernels.py:816",
        "launches": launches["tp_padded"].get("softmax_stats_partial", 0),
        "max_abs_err": max(partial_err,
                           errs["tp_padded"]["softmax_stats_partial"]),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
        "library_ms": f32["library_ms"], "library_call": "torch.logsumexp",
        "status": "redesigned, PR 9", "dtype": "float32",
        "shape": "B=%d,T=%d,S1=%d,V_local=%d" % (B // 2, T, S + 1, V // 2),
        "queued_ms": f32["queued_ms"],
        "bf16": {"ms": b16["ms"], "plain_ms": b16["plain_ms"],
                 "queued_ms": b16["queued_ms"], "bound_ms": b16["bound"][0],
                 "library_ms": b16["library_ms"]},
    }
    log(f"sharded phase: inputs saved in {t_saved:.1f} s, whole phase "
        f"{time.perf_counter() - t0:.1f} s; launches by path {launches}")
    return launches, {"kernel_vs_plain": {"softmax_stats_partial":
                                          partial_err}, **errs}, entry


# --- the copy ceiling -----------------------------------------------------------

# bench.py's calibration tensors: the flat [327680, 1024] array
# (bench.py:91) and the blocked lattice [B, T, S1, V rounded up to 128]
# (bench.py:171-176), with its t-major control [T, B, S1, V128].
CEIL_FLAT = (327680, 1024)
CEIL_BLOCKED = (B, T, S + 1, 1024)
CEIL_BLOCK_ROWS, CEIL_NBUF = 512, 8   # bench.py:117's vmem_512; 8 slabs
CEIL_K = 24          # copies per timed chain (bench.py:133)
CEIL_TRIALS = 5      # interleaved trials per configuration (bench.py:134)


def chain_ms(fn, x) -> float:
    """Per-copy ms of a ping-pong chain of CEIL_K copies of x, timed with
    CUDA events from the end of one untimed copy before them: the card is
    busy with that copy while the host enqueues the timed ones, so the
    host's first launch (a wrapper call, tens of µs) falls outside the
    window, as it does in bench.py's one jitted chain."""
    a = fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CEIL_K):
        a = fn(a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CEIL_K


# The redesigned copies' edge cases, as tests/test_torch_cuda.py's
# COPY_EDGES: (kernel, shape, arguments, elements the view starts past a
# fresh allocation). Register-copy tiles are 8 KB, TMA chunks and the
# blocked copy's pieces 16 KB.
CEIL_EDGES = (
    ("vmem", (8192, 1024), dict(block_rows=8), 0),   # more tiles than CTAs
    ("vmem", (64, 256), dict(block_rows=16), 0),     # fewer
    ("vmem", (3, 1000), dict(block_rows=3), 0),      # one block
    ("vmem", (2, 16385), dict(block_rows=1), 0),     # tails under 16 bytes
    ("vmem", (1000, 333), dict(block_rows=40), 1),   # views 4 and 8 bytes off
    ("vmem", (1000, 333), dict(block_rows=40), 2),
    ("dma", (8192, 1024), dict(nbuf=4), 0),          # more chunks than CTAs
    ("dma", (64, 256), dict(nbuf=2), 0),             # fewer
    ("dma", (1, 64), dict(nbuf=1), 0),               # one chunk
    ("dma", (2, 16392), dict(nbuf=2), 0),            # tails under one chunk
    ("tbsv", (6, 8, 5, 7), dict(tt=2), 0),           # fewer t-blocks than CTAs
    ("tbsv", (1200, 2, 3, 7), dict(tt=1), 0),        # more
    ("tbsv", (4, 8, 51, 1000), dict(tt=4), 0),       # one t-block
    ("tbsv", (40, 3, 5, 33), dict(tt=4), 1),         # a view off
    ("blocked", (1, 12, 51, 1024), dict(tt=2), 0),   # B = 1
    ("blocked", (3, 9, 5, 33), dict(tt=3), 0),       # rows not 16-byte units
    ("blocked", (1, 1, 1, 8), dict(tt=1), 0),        # one row
    ("blocked", (2, 4, 5, 128), dict(tt=2), 0),      # fewer pieces than CTAs
    ("blocked", (8, 200, 51, 256), dict(tt=2), 0),   # more
    ("blocked", (2, 8, 51, 1000), dict(tt=2), 1),    # a view off
)
# One f32 copy past 2^31 bytes (2.15e9) for the copies' 64-bit offsets:
# flat, as [T, B, S1, V] for the t-blocks and as [B, T, S1, V] for the
# blocked copy.
CEIL_HUGE = (524800, 1024)
CEIL_HUGE_TBSV = (200, 32, 82, 1024)
CEIL_HUGE_BLOCKED = (32, 200, 82, 1024)


def exact_copy(kern, plain, x, kw, what):
    """kern(x) against plain(x) and x, byte for byte."""
    got, ref = kern(x, **kw), plain(x, **kw)
    torch.cuda.synchronize()
    shape = "x".join(map(str, x.shape))
    check(torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
          and torch.equal(got.view(torch.uint8), x.view(torch.uint8)),
          f"{kern.__name__} {kw} [{shape}] {x.dtype} {what}: not an exact "
          "copy")


def ceiling_edges(mt, gen, dtype):
    """The redesigned copies at CEIL_EDGES, on random bytes (NaN payloads
    included)."""
    ST = mt.ST
    kernels = {"vmem": (ST.stream_copy, ST.stream_copy_plain),
               "dma": (ST.stream_copy, ST.stream_copy_plain),
               "tbsv": (ST.stream_copy_blocked_tbsv,
                        ST.stream_copy_blocked_tbsv_plain),
               "blocked": (ST.stream_copy_blocked,
                           ST.stream_copy_blocked_plain)}
    size = torch.empty((), dtype=dtype).element_size()
    for kind, shape, kw, offset in CEIL_EDGES:
        n = int(np.prod(shape))
        base = torch.randint(0, 256, ((n + offset) * size,), generator=gen,
                             dtype=torch.uint8, device=DEVICE).view(dtype)
        x = base[offset:].view(shape)
        kern, plain = kernels[kind]
        exact_copy(kern, plain, x, dict(kw, mode=kind) if kind in
                   ("vmem", "dma") else kw, f"{offset} elements off")
    return len(CEIL_EDGES)


def ceiling_huge(mt, gen):
    """Rows 12-14 on one f32 tensor past 2^31 bytes, freed after."""
    ST = mt.ST
    x = torch.randn(CEIL_HUGE, generator=gen, device=DEVICE)
    exact_copy(ST.stream_copy, ST.stream_copy_plain, x,
               dict(mode="vmem", block_rows=CEIL_BLOCK_ROWS), "past 2^31 B")
    exact_copy(ST.stream_copy, ST.stream_copy_plain, x,
               dict(mode="dma", nbuf=CEIL_NBUF), "past 2^31 B")
    exact_copy(ST.stream_copy_blocked_tbsv, ST.stream_copy_blocked_tbsv_plain,
               x.view(CEIL_HUGE_TBSV), dict(tt=1), "past 2^31 B")
    exact_copy(ST.stream_copy_blocked, ST.stream_copy_blocked_plain,
               x.view(CEIL_HUGE_BLOCKED), dict(tt=1), "past 2^31 B")
    nbytes = x.numel() * x.element_size()
    del x
    torch.cuda.empty_cache()
    return nbytes


def ceiling_exactness(mt):
    """Every copy kernel byte for byte against its plain version and its
    input: at the bench sizes in f32 and bf16, at small odd shapes (V=7
    through the blocked pair's element-wise path, 2-byte units in the
    register copy, a slab of a few chunks in the TMA copy), at every
    block_rows / nbuf / tt that divides, at the redesigned copies' edges
    (CEIL_EDGES) and past 2^31 bytes."""
    ST = mt.ST
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tt = 2 if dtype == torch.bfloat16 else 1
        flat = (torch.randn(CEIL_FLAT, generator=gen, device=DEVICE)
                * 3).to(dtype)
        blocked = (torch.randn(CEIL_BLOCKED, generator=gen, device=DEVICE)
                   * 3).to(dtype)
        b_, t_, s1_, v_ = CEIL_BLOCKED
        cases = [
            (ST.stream_copy, ST.stream_copy_plain, flat,
             dict(mode="vmem", block_rows=CEIL_BLOCK_ROWS)),
            (ST.stream_copy, ST.stream_copy_plain, flat,
             dict(mode="dma", nbuf=CEIL_NBUF)),
            (ST.stream_copy_blocked, ST.stream_copy_blocked_plain, blocked,
             dict(tt=tt)),
            (ST.stream_copy_blocked_tbsv, ST.stream_copy_blocked_tbsv_plain,
             blocked.view(t_, b_, s1_, v_), dict(tt=tt))]
        small = (torch.randn((6, 8, 5, 7), generator=gen, device=DEVICE)
                 * 3).to(dtype)
        odd = (torch.randn((96, 40), generator=gen, device=DEVICE)
               * 3).to(dtype)
        for tt_s in (1, 2, 4, 8):
            cases += [(ST.stream_copy_blocked, ST.stream_copy_blocked_plain,
                       small, dict(tt=tt_s)),
                      (ST.stream_copy_blocked_tbsv,
                       ST.stream_copy_blocked_tbsv_plain,
                       small.transpose(0, 1).contiguous(), dict(tt=tt_s))]
        for br in (1, 3, 32, 96):
            cases.append((ST.stream_copy, ST.stream_copy_plain, odd[:, :7],
                          dict(mode="vmem", block_rows=br)))
        for nb in (1, 2, 3, 4, 6, 8, 12, 24):
            cases.append((ST.stream_copy, ST.stream_copy_plain, odd,
                          dict(mode="dma", nbuf=nb)))
        for kern, plain, x, kw in cases:
            exact_copy(kern, plain, x.contiguous(), kw, "")
            n += 1
        del flat, blocked, cases
        torch.cuda.empty_cache()
        n += ceiling_edges(mt, gen, dtype)
    huge = ceiling_huge(mt, gen)
    log(f"copy kernels: {n + 4} calls byte for byte equal to their plain "
        "versions and their inputs (bench sizes, V=7, odd blocks, every "
        f"divisor, {len(CEIL_EDGES)} edge cases a dtype, rows 12-14 on "
        f"{huge} bytes)")


def ceiling_configs(mt, dtype, flat, blocked):
    """The timed chains: name -> (one copy of its input, the input)."""
    ST = mt.ST
    tt = 2 if dtype == torch.bfloat16 else 1
    b_, t_, s1_, v_ = CEIL_BLOCKED
    tbsv = blocked.view(t_, b_, s1_, v_)
    bufs = [torch.empty_like(flat), torch.empty_like(flat)]
    flip = [0]

    def copy_(x):                 # the yardstick: two preallocated buffers
        out = bufs[flip[0]]
        flip[0] ^= 1
        return out.copy_(x)

    return {
        "vmem": (lambda x: ST.stream_copy(x, "vmem", CEIL_BLOCK_ROWS), flat),
        "dma": (lambda x: ST.stream_copy(x, "dma", nbuf=CEIL_NBUF), flat),
        "blocked": (lambda x: ST.stream_copy_blocked(x, tt=tt), blocked),
        "tbsv": (lambda x: ST.stream_copy_blocked_tbsv(x, tt=tt), tbsv),
        "copy_": (copy_, flat),
    }


def run_ceiling(mt):
    """Rows 12-14: the copy kernels bit for bit, then the card's copy rates
    as bench.py measures them: a ping-pong chain of CEIL_K copies (the
    caching allocator hands each copy the buffer the one before last
    freed) after one untimed copy (chain_ms), CEIL_TRIALS trials a
    configuration, interleaved, median. The copy ceiling of a dtype is the
    best median of the hand-written flat modes (vmem, dma). Returns the
    rates and the three kernels' entries."""
    K, ST = mt.K, mt.ST
    t0 = time.perf_counter()
    ceiling_exactness(mt)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    inputs = {d: ((torch.randn(CEIL_FLAT, generator=gen, device=DEVICE)
                   * 3).to(d),
                  (torch.randn(CEIL_BLOCKED, generator=gen, device=DEVICE)
                   * 3).to(d))
              for d in (torch.float32, torch.bfloat16)}
    configs = {(d, name): cfg for d, (flat, blocked) in inputs.items()
               for name, cfg in ceiling_configs(mt, d, flat, blocked).items()}

    def chain(cfg):
        fn, x = cfg
        a = x
        for _ in range(CEIL_K):
            a = fn(a)
        return a

    # The ceiling path: counts reset just before, read just after.
    K.reset_launch_counts()
    for cfg in configs.values():                      # warm-up
        chain(cfg)
    trials = {key: [] for key in configs}
    for _ in range(CEIL_TRIALS):
        for key, cfg in configs.items():
            trials[key].append(chain_ms(*cfg))
    torch.cuda.synchronize()
    launches = launched(K)
    check(set(launches) == {"stream_copy", "stream_copy_blocked",
                            "stream_copy_blocked_tbsv"},
          f"ceiling path launches {launches}")
    # The chains' last copies still equal their inputs.
    for key, cfg in configs.items():
        check(torch.equal(chain(cfg), cfg[1]), f"{key}: the chain drifted")

    rates, per_copy = {}, {}
    for (d, name), ts in trials.items():
        nbytes = configs[(d, name)][1].numel() * configs[(d, name)][1].element_size()
        med = statistics.median(ts)
        per_copy[(d, name)] = med
        rates.setdefault(dtype_name(d), {})[name] = {
            "GBps": 2 * nbytes / (med * 1e-3) / 1e9, "ms": med,
            "spread": (max(ts) - min(ts)) / med,
            "trials_GBps": [2 * nbytes / (t * 1e-3) / 1e9 for t in ts]}
    for d in rates.values():
        d["ceiling_GBps"] = max(d["vmem"]["GBps"], d["dma"]["GBps"])
        d["ceiling_mode"] = max(("vmem", "dma"), key=lambda m: d[m]["GBps"])
    spec = HBM_BYTES_PER_S / 1e9
    for d, r in rates.items():
        log(f"copy rates {d} (median of {CEIL_TRIALS} interleaved trials of "
            f"{CEIL_K}-copy chains, GB/s = 2*bytes/t; spec {spec:.0f}): "
            + ", ".join(f"{m} {r[m]['GBps']:.1f} ({r[m]['GBps'] / spec:.1%} "
                        f"of spec, spread {r[m]['spread']:.1%})"
                        for m in ("vmem", "dma", "blocked", "tbsv", "copy_"))
            + f"; copy ceiling {r['ceiling_GBps']:.1f} GB/s "
            f"({r['ceiling_mode']}, {r['ceiling_GBps'] / spec:.1%} of spec)")
        r["over_copy_"] = {m: r[m]["GBps"] / r["copy_"]["GBps"]
                           for m in r if isinstance(r[m], dict)}
        log(f"copy rates {d} over copy_'s: " + ", ".join(
            f"{m} {x:.4f}x" for m, x in r["over_copy_"].items()
            if m != "copy_") + f"; ceiling "
            f"{r['ceiling_GBps'] / r['copy_']['GBps']:.4f}x")

    # Each kernel's entry: its time per copy at the bench size, its byte
    # bound, its plain version (one call) and the copy_ yardstick.
    plain_ms = {}
    for (d, name), (fn, x) in configs.items():
        plain = {"vmem": lambda: ST.stream_copy_plain(x, "vmem",
                                                      CEIL_BLOCK_ROWS),
                 "dma": lambda: ST.stream_copy_plain(x, "dma",
                                                     nbuf=CEIL_NBUF),
                 "blocked": lambda: ST.stream_copy_blocked_plain(
                     x, tt=2 if d == torch.bfloat16 else 1),
                 "tbsv": lambda: ST.stream_copy_blocked_tbsv_plain(
                     x, tt=2 if d == torch.bfloat16 else 1)}.get(name)
        if plain is not None:
            plain_ms[(d, name)] = cuda_ms(plain, reps=1, warmup=1)
    entries = []
    spec_rows = (("stream_copy", ("vmem", "dma"), 50, "R=327680,C=1024",
                  "redesigned"),
                 ("stream_copy_blocked", ("blocked",), 82,
                  "B=%d,T=%d,S1=%d,V=%d; tt=1 f32, 2 bf16" % CEIL_BLOCKED,
                  "redesigned"),
                 ("stream_copy_blocked_tbsv", ("tbsv",), 114,
                  "T=%d,B=%d,S1=%d,V=%d; tt=1 f32, 2 bf16"
                  % (T, B, S + 1, 1024), "redesigned"))
    for kname, modes, line, shape, status in spec_rows:
        def numbers(d, mode):
            x = configs[(d, mode)][1]
            return {"ms": per_copy[(d, mode)], "plain_ms": plain_ms[(d, mode)],
                    "bound_ms": bound_ms(2 * x.numel() * x.element_size(),
                                         0)[0],
                    "library_ms": per_copy[(d, "copy_")],
                    "rate_over_copy_":
                        rates[dtype_name(d)]["over_copy_"][mode]}
        f32, b16 = numbers(torch.float32, modes[0]), numbers(torch.bfloat16,
                                                             modes[0])
        entry = {
            "name": kname, "route": "cuda",
            "source": "monotonic_rnnt_tpu_torch/csrc/stream.cu",
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/stream.py:{line}",
            "launches": launches.get(kname, 0), "max_abs_err": 0.0,
            **f32, "bound_by": "bytes", "library_call": "Tensor.copy_",
            "status": status, "dtype": "float32", "shape": shape,
            "bf16": b16, "launches_by_path": {"ceiling":
                                              launches.get(kname, 0)},
            "max_abs_err_by_path": {"ceiling": 0.0}}
        if len(modes) > 1:
            entry["modes"] = {m: {"float32": numbers(torch.float32, m),
                                  "bfloat16": numbers(torch.bfloat16, m)}
                              for m in modes}
        entries.append(entry)
    del configs, inputs
    torch.cuda.empty_cache()
    log(f"ceiling phase: launches {launches}; {time.perf_counter() - t0:.1f} s")
    return rates, entries


def dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


def add_ceiling(entries, rates):
    """Each entry's (and its bf16 numbers') bound at the measured copy
    ceiling of its dtype: its bytes (bound_ms at the spec rate) over the
    ceiling, and the share of that bound the kernel reaches. A row bound
    by its operations keeps its bound."""
    def one(e, d):
        if e.get("bound_ms") is None or not e.get("ms"):
            return
        ceiling = rates[d]["ceiling_GBps"] * 1e9
        by_bytes = e.get("bound_by", "bytes") == "bytes"
        e["ceiling_bound_ms"] = (e["bound_ms"] * HBM_BYTES_PER_S / ceiling
                                 if by_bytes else e["bound_ms"])
        e["share_of_ceiling"] = e["ceiling_bound_ms"] / e["ms"]
        if e.get("kernel_ms"):   # the kernel alone, without the host prelude
            e["kernel_share_of_ceiling"] = e["ceiling_bound_ms"] / e["kernel_ms"]
        if e.get("queued_ms"):   # queued back to back, the prelude overlapped
            e["queued_share_of_ceiling"] = e["ceiling_bound_ms"] / e["queued_ms"]

    for e in entries:
        one(e, "float32")
        for key in ("bf16", "fused_joint_chunk"):
            if isinstance(e.get(key), dict):
                one(e[key], "bfloat16" if key == "bf16"
                    else e[key].get("dtype", "float32"))


def add_roofline(e2e, rates, nbytes_f32):
    """bench.py's roofline fraction of the padded step (bench.py:247-249,
    293-298, 383-390): 3 passes over the logits (two reads, one write) at
    the measured copy ceiling over the fwd+bwd time, the same at the
    blocked ceiling, and at the 3.35 TB/s spec."""
    for d, row in e2e.items():
        nbytes = nbytes_f32 // 2 if d == "bfloat16" else nbytes_f32
        t = row["fwd_bwd_ms"] * 1e-3
        row["roofline_fraction"] = (3 * nbytes / (rates[d]["ceiling_GBps"]
                                                  * 1e9)) / t
        row["fraction_of_blocked_ceiling"] = (
            3 * nbytes / (rates[d]["blocked"]["GBps"] * 1e9)) / t
        row["roofline_fraction_vs_spec"] = (3 * nbytes / HBM_BYTES_PER_S) / t


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def phase_trace(mt, main_inputs, weights):
    """One training step of the padded loss, traced (trace_step)."""
    logits, labels, ilen, slen = main_inputs
    x = leaf(logits, torch.float32)

    def step():
        costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen)
        (costs * weights).sum().backward()
        x.grad = None

    return trace_step(mt, step, "padded fwd+bwd, f32")


def phase_model_trace(mt):
    """One loss step of the model cell (run_model's) and one train_step
    (run_train's: the loss step, the clip and AdamW), f32 and bf16, traced
    (trace_step): how many device ops a step makes, and how busy the card
    is."""
    batch = model_batch(DEVICE)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        state = train_state(mt, dtype, DEVICE)
        model = state.model

        def step():
            model.zero_grad(set_to_none=True)
            model(*batch).mean().backward()

        out[name] = trace_step(mt, step, f"model loss step, {name}")
        out[f"train {name}"] = trace_step(
            mt, lambda: mt.train.train_step(state, batch),
            f"train_step, {name}")
        del model, state
    torch.cuda.empty_cache()
    return out


def phase_decode_trace(mt):
    """One beam decode (K=4) of the model cell and one streaming greedy
    chunk from the middle of the stream, f32 and bf16, traced (trace_step):
    the decoders' device ops, and how busy the card is."""
    feats, flen = model_batch(DEVICE)[:2]
    b, _, f = feats.shape
    chunks = stream_chunks(feats, flen)
    mid = len(chunks) // 2
    chunk, cv = chunks[mid]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        model = make_model(mt, dtype, DEVICE)
        out[f"beam {name}"] = trace_step(
            mt, lambda: model.beam_search_decode(feats, flen,
                                                 MODEL_MAX_LABELS,
                                                 DECODE_BEAM),
            f"beam decode K={DECODE_BEAM}, {name}")
        del model
        s_model = stream_model(mt, dtype, DEVICE)
        lookback = mt.models.conformer.streaming_lookback(s_model.cfg.encoder)
        state = stream_state_after(
            chunks, mid, lambda: s_model.streaming_init(
                b, f, lookback, MODEL_MAX_LABELS), s_model.streaming_step)
        out[f"stream {name}"] = trace_step(
            mt, lambda: s_model.streaming_step(state, chunk, cv),
            f"streaming greedy chunk {mid}, {name}")
        del s_model, state
    torch.cuda.empty_cache()
    return out


def trace_step(mt, step, what):
    """One call of step() under the port's device_trace (torch.profiler, CPU
    and CUDA, a Chrome trace into a temporary directory, its name and size
    printed), after one untimed call: the top 10 device operations by device
    time, the device ops counted, and the device time summed over the
    step's wall time (profiler on). A trace without device time is printed
    as a finding; a profiler exception fails the run."""
    step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="mrnnt_trace_") as out_dir:
        with mt.profiling.device_trace(out_dir) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        traces = [f"{t.name} ({t.stat().st_size / 1e6:.1f} MB)"
                  for t in Path(out_dir).glob("*.pt.trace.json")]
    check(len(traces) == 1, f"device_trace wrote {traces}")
    avgs = list(prof.key_averages())
    cuda_type = torch.autograd.DeviceType.CUDA
    # A user annotation (torch.optim's "Optimizer.step#AdamW.step") spans
    # the device ops under it: counting it would count them twice.
    kernels = [e for e in avgs if e.device_type == cuda_type
               and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"traced step ({what}): {wall_ms:.3f} ms wall; key_averages() "
            "shows no device time (a finding: time with CUDA events instead)")
        return {"wall_ms": wall_ms, "device_ms": None}
    kernels.sort(key=_device_us, reverse=True)
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    log(f"traced step ({what}, profiler on): wall {wall_ms:.3f} "
        f"ms, device time summed {device_ms:.3f} ms = {device_ms / wall_ms:.1%}"
        f" of the wall time, {sum(e.count for e in kernels)} device ops in "
        f"{len(kernels)} kinds; trace {traces[0]}; "
        "top 10 by device time: " + "; ".join(
            f"{e.key[:70]} x{e.count} {_device_us(e) / 1e3:.4f} ms"
            for e in kernels[:10]))
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "device_ops": sum(e.count for e in kernels)}


# --- the packed layout and the binding ------------------------------------------

def packed_step(fn, acts, reduce, *args, **kw):
    """fn(acts leaf, *args, **kw), reduced and differentiated; returns the
    (unreduced or reduced) output and acts' gradient."""
    a = acts.detach().clone().requires_grad_(True)
    out = fn(a, *args, **kw)
    reduce(out).backward()
    return out.detach(), a.grad


def check_bitwise(got, ref, what) -> float:
    """Held at 1e-6 relative, expected bit for bit; returns max |d|."""
    err = assert_close(got, ref, 0.0, 1e-6, what)
    if not torch.equal(got, ref):
        log(f"{what}: within 1e-6 relative but not bit for bit (max|d| "
            f"{err:.3g})")
    return err


def phase_packed_goldens(mt, golden):
    conv, bind = mt.convert, mt.interop

    def run(lg, lb, il, sl, **kw):
        lg, lb, il, sl = conv.loss_inputs_from_numpy(lg, lb, il, sl,
                                                     device=DEVICE)
        acts = mt.pack_acts(lg, il, sl).requires_grad_(True)
        costs = bind.monotonic_rnnt_loss(acts, lb, il, sl, **kw)
        costs.sum().backward()
        return (costs.detach().cpu().numpy(),
                mt.unpack_acts(acts.grad, il, sl).cpu().numpy())

    costs, grads = run(*golden.readme_batch())
    check(abs(costs[0] - golden.README_LOSS) < 1e-4, f"README loss {costs}")
    check(np.abs(grads[0] - golden.README_GRADS).max() < 1e-2, "README grads")
    lg, lb, il, sl, exp_l, exp_g = golden.multibatch()
    costs, grads = run(lg, lb, il, sl)
    check(np.abs(costs - exp_l).max() < 1e-4, f"multibatch loss {costs}")
    check(np.abs(grads - exp_g).max() < 1e-2, "multibatch grads")
    for align, shift, expected in ((golden.ALIGN_A, 1, 1.22),
                                   (golden.ALIGN_B, 0, 2.7)):
        costs, grads = run(*golden.readme_batch(),
                           alignment=torch.from_numpy(align[None]),
                           max_distance_from_alignment=shift)
        check(abs(costs[0] - expected) < 1e-2,
              f"binding restricted shift={shift}: {costs} vs {expected}")
        check(np.isfinite(grads).all(), "binding restricted grads finite")
    log("packed goldens through the binding on the card: README -log 0.363 "
        "+ gradient table, multibatch 0.39/0.363, restricted 1.22 and 2.7 ok")


def run_packed(mt, golden, main_inputs, weights, restricted):
    """The reference's packed layout and torch binding at the benchmark
    lattice: the binding and the packed loss against the padded loss on the
    same logits (expected bit for bit), the native engine on the host
    against the card, the goldens, and the packed step's time beside the
    padded step's; the packed step's calls of rows 1-2 are held against
    their plain versions. Returns the packed path's launches, max |d| per
    wrapper and timings."""
    K, bind = mt.K, mt.interop
    logits, labels, ilen, slen = main_inputs
    align, (r_costs, r_grads) = restricted
    args = (labels, ilen, slen)
    t0 = time.perf_counter()
    acts = mt.pack_acts(logits, ilen, slen)
    rows = acts.shape[0]
    cells = logits.shape[0] * logits.shape[1] * logits.shape[2]
    log(f"packed layout: {rows} rows of {cells} padded "
        f"({acts.numel() * 4 / 1e9:.3f} GB f32)")
    weighted = lambda c: (c * weights).sum()
    ident = lambda c: c

    # The packed path: counts reset once before, read after each part.
    K.reset_launch_counts()
    with rows12_capture(mt, 0) as cap:
        costs, grads = packed_step(bind.monotonic_rnnt_loss, acts, weighted,
                                   *args)
    torch.cuda.synchronize()
    after_step = launched(K)
    with torch.no_grad():
        costs_only = bind.monotonic_rnnt_loss(acts, *args)
    torch.cuda.synchronize()
    launches = launched(K)
    check(after_step == LOSS_STEP,
          f"packed training step launches {after_step}")
    check(launches == {row: LOSS_STEP[row] + COST_ONLY.get(row, 0)
                       for row in LOSS_STEP},
          f"packed cost-only launches {launches}")
    kernel_errs = compare_captured_rows12(mt, cap, "packed step")
    del cap

    errs = {}
    for name, reduce in (("weighted", weighted), ("sum", lambda c: c.sum()),
                         ("mean", lambda c: c.mean())):
        ref_c, ref_g = packed_step(mt.monotonic_rnnt_loss, logits, reduce,
                                   *args)
        ref_g = mt.pack_acts(ref_g, ilen, slen)
        if name == "weighted":
            runs = {"monotonic_rnnt_loss": (costs, grads),
                    "MonotonicRNNTLoss(none)": packed_step(
                        bind.MonotonicRNNTLoss(reduction="none"), acts,
                        weighted, *args)}
            with torch.no_grad():
                ref_only = mt.monotonic_rnnt_loss(logits, *args)
            errs["cost-only"] = check_bitwise(costs_only, ref_only,
                                              "packed cost-only costs")
        else:
            runs = {f"MonotonicRNNTLoss({name})": packed_step(
                bind.MonotonicRNNTLoss(reduction=name), acts, ident, *args)}
            ref_c = reduce(ref_c)
        for what, (c, g) in runs.items():
            errs[what] = max(check_bitwise(c, ref_c, f"{what} costs"),
                             check_bitwise(g, ref_g, f"{what} grads"))
        del ref_g, runs

    # The +-8 restricted variant, and bf16 through the packed loss.
    c, g = packed_step(bind.monotonic_rnnt_loss, acts, weighted, *args,
                       alignment=align, max_distance_from_alignment=ALIGN_SHIFT)
    errs["restricted"] = max(
        check_bitwise(c, r_costs, "packed restricted costs"),
        check_bitwise(g, mt.pack_acts(r_grads, ilen, slen),
                      "packed restricted grads"))
    lg16 = logits.to(torch.bfloat16)
    c, g = packed_step(mt.monotonic_rnnt_loss_packed, mt.pack_acts(
        lg16, ilen, slen), weighted, *args)
    ref_c, ref_g = packed_step(mt.monotonic_rnnt_loss, lg16, weighted, *args)
    check(g.dtype == torch.bfloat16, f"packed bf16 grads dtype {g.dtype}")
    errs["bf16"] = max(check_bitwise(c, ref_c, "packed bf16 costs"),
                       check_bitwise(g, mt.pack_acts(ref_g, ilen, slen),
                                     "packed bf16 grads"))
    del c, g, ref_c, ref_g, lg16
    torch.cuda.empty_cache()

    # The native engine on the host, first 4 samples, against the card.
    n4 = int((ilen[:4].long() * (slen[:4].long() + 1)).sum())
    il4, sl4 = ilen[:4].cpu(), slen[:4].cpu()
    a4 = acts[:n4].cpu().requires_grad_(True)
    t_nat = time.perf_counter()
    c4 = bind.monotonic_rnnt_loss(a4, labels[:4].cpu(), il4, sl4)
    (c4 * weights[:4].cpu()).sum().backward()
    t_nat = time.perf_counter() - t_nat
    ref4 = costs[:4].cpu()
    e_nc = assert_close(c4.detach(), ref4, 1e-4, 1e-5, "native vs card costs")
    # Two f32 implementations: each sample's |ll| (~1.3e3 here, ulp 1.2e-4)
    # enters every occupancy exponent, so the gradients are held at the
    # oracle's 1e-3 or 16 ulps of |ll| relative (~2e-3), the larger.
    ulp = torch.nextafter(ref4, ref4 + 1) - ref4
    rtol = torch.clamp(16 * ulp, min=1e-3).repeat_interleave(
        il4.long() * (sl4.long() + 1))
    g_ref = grads[:n4].cpu()
    e_ng = assert_close(a4.grad, g_ref, 1e-6, rtol[:, None],
                        "native vs card grads")
    past = int((~((a4.grad - g_ref).abs() <= 1e-6 + 1e-3 * g_ref.abs()))
               .sum())
    log(f"native engine on the host (4 samples, {n4} rows, {t_nat:.2f} s) vs "
        f"the card's binding: costs max|d| {e_nc:.3g}, grads max|d| "
        f"{e_ng:.3g} (relative L2 {rel_l2(a4.grad, g_ref):.3g}; {past} of "
        f"{g_ref.numel()} entries past 1e-6 + 1e-3|ref|; bound "
        f"{float(rtol.max()):.3g} relative)")
    phase_packed_goldens(mt, golden)

    lg_leaf, a_leaf = leaf(logits, torch.float32), leaf(acts, torch.float32)

    def step(fn, x):
        (fn(x, *args) * weights).sum().backward()
        x.grad = None

    gthr = mt.unpack_acts(acts, ilen, slen)
    timing = {"packed_fwd_bwd_ms": cuda_ms(
                  lambda: step(bind.monotonic_rnnt_loss, a_leaf)),
              "padded_fwd_bwd_ms": cuda_ms(
                  lambda: step(mt.monotonic_rnnt_loss, lg_leaf)),
              "unpack_ms": cuda_ms(lambda: mt.unpack_acts(acts, ilen, slen)),
              "pack_ms": cuda_ms(lambda: mt.pack_acts(gthr, ilen, slen))}
    timing["packed_over_padded_ms"] = (timing["packed_fwd_bwd_ms"]
                                       - timing["padded_fwd_bwd_ms"])
    log("packed vs padded at B=%d,T=%d,S=%d,V=%d (f32): max|d| by check "
        % (B, T, S, V) + json.dumps(errs) + "; launches step "
        f"{after_step}, +cost-only {launches}; timing " + json.dumps(timing)
        + f"; phase {time.perf_counter() - t0:.1f} s")
    del acts, gthr, lg_leaf, a_leaf, grads
    torch.cuda.empty_cache()
    return {"packed": launches}, {"packed": kernel_errs}, timing


# --- the checked final-cell gather -------------------------------------------

GATHER_CASE = (8, 50, 10, 128)   # B, T, S, V of the live calls
GATHER_REPS = 200                # host timings of each gather
GATHER_CALL_REPS = 40            # host timings of each live call


def host_ms(fn, reps):
    """The host time of fn() in ms (perf_counter around each call, from an
    idle card; the call's device work finishes after the reading), after
    three warm-up calls: the median and quartiles over `reps`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {"median": med, "q1": q1, "q3": q3}


def phase_gather_cost(mt):
    """The host time that the final-cell gather's bounds check adds
    (reference._gather_ll: take_index on both indices and a NaN fill, JAX's
    out-of-bounds rule, which an exported artifact needs; band_final_slot
    checks T_b the same way), against the bare gather it replaced and
    against the host time of one training step of each live route that
    makes it, at GATHER_CASE: the oracle, the vocab-sharded core on a
    one-rank gloo group and the banded loss. Returns the figures, each
    call's spread (q3 - q1) beside the check's cost."""
    from monotonic_rnnt_tpu_torch.scripts._cases import costs_and_grads

    b, t, s, v = GATHER_CASE
    x, labels, ilen, slen = make_inputs(b, t, s, v, seed=5,
                                        t_range=(s + 1, t), s_range=(0, s),
                                        device=DEVICE)
    alphas = torch.randn((b, t, s + 1), device=DEVICE)

    def bare():      # the gather without the check
        b_idx = torch.arange(alphas.shape[0], device=alphas.device)
        t_last = (ilen.to(torch.int64) - 1).clamp(min=0)
        return alphas[b_idx, t_last, slen.to(torch.int64)]

    checked = lambda: mt.reference._gather_ll(alphas, ilen, slen)
    check(torch.equal(bare(), checked()), "the checked gather differs from "
          "the bare one on in-range lengths")
    figs = {"bare_gather": host_ms(bare, GATHER_REPS),
            "checked_gather": host_ms(checked, GATHER_REPS)}
    cost = figs["checked_gather"]["median"] - figs["bare_gather"]["median"]
    bands = mt.bands.default_bands(ilen, slen, t)
    band = banded_case(b, t, s, v, 2, seed=5, device=DEVICE)
    with one_rank_group() as group:
        calls = {
            "oracle_step": (lambda z: mt.monotonic_rnnt_loss(
                z, labels, ilen, slen, backend="reference"), x),
            "vocab_sharded_step": (lambda z: mt.par.rnnt_loss_vocab_sharded(
                z, labels, ilen, slen, bands.min_s, bands.max_s, 0, group),
                x),
            "banded_step": (lambda z: mt.monotonic_rnnt_loss_banded(
                z, band["labels"], band["ilen"], band["slen"],
                bands=band["bands"]), band["logits_band"])}
        for name, (fn, arg) in calls.items():
            figs[name] = host_ms(lambda: costs_and_grads(fn, arg),
                                 GATHER_CALL_REPS)
            figs[name]["spread"] = figs[name]["q3"] - figs[name]["q1"]
    figs["check_cost_ms"] = cost
    log(f"final-cell gather at B,T,S,V={GATHER_CASE} ({gpu_line()}), host "
        f"ms: {json.dumps(figs)}; the check adds {cost * 1e3:.1f} us a call")
    return figs


# --- the acceptance and fuzz harness ---------------------------------------------

ACCEPTANCE_CASES = 40     # fuzz_gpu cases at seed 0: the phase in <= 120 s
ACCEPTANCE_SEED = 0
# gpu_acceptance's checks that no other phase makes (by name substring).
ACCEPTANCE_CHECKS = ("large-V", "odd-V", "large-shape", "over-cap")
ACCEPTANCE_N_CHECKS = 6


def run_acceptance(mt):
    """The port's acceptance harness, short: fuzz_gpu's overflow probe and
    ACCEPTANCE_CASES drawn cases at seed 0 (among them at least one case
    of each dimension the harness adds: scale 50/100, sharded, export),
    then the gpu_acceptance checks that no other phase makes, all under a
    Hold: every kernel call the phase makes is held against its plain
    version on its own operands. Returns the phase's launches (path
    acceptance), each launched kernel's max |d| against its plain version,
    and the timing (with the phase's worst |d| of the losses against the
    oracle)."""
    from monotonic_rnnt_tpu_torch.scripts import fuzz_gpu, gpu_acceptance

    K, dev = mt.K, torch.device(DEVICE)
    t0 = time.perf_counter()
    K.reset_launch_counts()
    with Hold(mt, "acceptance") as hold:
        fuzz = fuzz_gpu.run(ACCEPTANCE_CASES, ACCEPTANCE_SEED, dev, log=log)
        check(fuzz["ok"], f"fuzz_gpu failed: {fuzz['failed_case']}")
        drawn = fuzz["drawn"]
        check(all(drawn[k] for k in ("overflow_scale", "sharded", "export")),
              f"the fuzz cases drew no case of an added dimension: {drawn}")
        acc = gpu_acceptance.Acceptance(dev, only=ACCEPTANCE_CHECKS, log=log)
        gpu_acceptance.run(acc)
        check(not acc.failures, f"acceptance checks failed: {acc.failures}")
        check(len(acc.results) == ACCEPTANCE_N_CHECKS,
              f"{len(acc.results)} acceptance checks ran, not "
              f"{ACCEPTANCE_N_CHECKS}")
        torch.cuda.synchronize()
    launches = launched(K)
    check(hold.calls == launches, f"acceptance: held calls {hold.calls}, "
          f"launches {launches}")
    timing = {"fuzz_cases": ACCEPTANCE_CASES, "fuzz_s": fuzz["seconds"],
              "fuzz_drawn": drawn,
              "checks_s": {r["name"]: r["seconds"] for r in acc.results},
              "oracle_max_abs_err": max([fuzz["max_abs_err"]] + [
                  r["max_abs_err"] for r in acc.results]),
              "phase_s": time.perf_counter() - t0}
    log(f"acceptance phase ({gpu_line()}): {json.dumps(timing)}; launches "
        f"{launches}, each held against its plain version: max |d| "
        + json.dumps(hold.errs))
    return {"acceptance": launches}, {"acceptance": hold.errs}, timing


# --- Viterbi alignment ----------------------------------------------------------

def run_alignment(mt, case):
    """Viterbi alignment and the occupancy posteriors at the banded case,
    on the full lattice and on the band; their checks, the realignment
    through the binding's restricted loss, the two Viterbi calls' times;
    every kernel call of the four is held against its plain version.
    Returns the alignment path's launches, max |d| per wrapper and the
    times."""
    K, bd = mt.K, mt.bands
    args = (case["labels"], case["ilen"], case["slen"])
    ilen, slen = case["ilen"], case["slen"]
    clipped = bd.clip_bands_to_width(case["bands"], case["layout"])
    t0 = time.perf_counter()
    caps = (Capture(mt.alignment, {"softmax_stats": {0, 1},
                                   "softmax_stats_banded": {0},
                                   "fwdbwd_scan": {0}}),
            Capture(mt.cuda_banded, {"softmax_stats_banded": {0},
                                     "fwdbwd_scan_banded": {0}}))
    K.reset_launch_counts()
    with caps[0], caps[1]:
        full = mt.viterbi_alignment(case["logits"], *args, bands=clipped)
        torch.cuda.synchronize()
        after_full = launched(K)
        band = mt.viterbi_alignment_banded(case["logits_band"], *args,
                                           bands=case["bands"])
        torch.cuda.synchronize()
        after_band = launched(K)
        occ = mt.occupancy_posteriors(case["logits"], *args, bands=clipped)
        occ_b = mt.occupancy_posteriors_banded(case["logits_band"], *args,
                                               bands=case["bands"])
        torch.cuda.synchronize()
    launches = launched(K)
    check(after_full == {"softmax_stats": 1},
          f"viterbi_alignment launches {after_full}")
    check(after_band == {"softmax_stats": 1, "softmax_stats_banded": 1},
          f"viterbi_alignment_banded launches {after_band}")
    check(launches == {"softmax_stats": 2, "fwdbwd_scan": 1,
                       "softmax_stats_banded": 2, "fwdbwd_scan_banded": 1},
          f"alignment path launches {launches}")
    errs = {}
    for cap in caps:
        for name, e in compare_captured(mt, cap, "alignment").items():
            errs[name] = max(e, errs.get(name, 0.0))
    del caps

    check(torch.equal(full.alignment, band.alignment),
          "banded and full Viterbi alignments differ")
    e_s = assert_close(band.score, full.score, 1e-4, 1e-5,
                       "banded vs full Viterbi scores")
    with torch.no_grad():
        cost = mt.monotonic_rnnt_loss(case["logits"], *args, bands=clipped)
        own = mt.monotonic_rnnt_alignment_score(case["logits"], *args,
                                                full.alignment)
    tol = 1e-4 + 1e-5 * cost.abs()
    check(bool((full.score >= cost - tol).all()),
          f"Viterbi score {full.score.tolist()} below the loss "
          f"{cost.tolist()}")
    e_own = assert_close(full.score, own, 1e-4, 1e-5,
                         "Viterbi score vs its alignment's score")
    # A frame's sum is exp(alpha(t-1) + beta(t) - ll) summed over s, so it
    # misses 1 by the f32 rounding of that exponent: a few ulps of |ll|
    # (~1e-3 at T=1600, where ll ~ -1.1e4). Bound: 1e-4 or 32 ulps of ll.
    t_idx = torch.arange(occ.shape[1], device=DEVICE)[None, :]
    valid = t_idx < ilen[:, None]
    ll = cost.abs()
    sum_tol = torch.clamp(32 * (torch.nextafter(ll, ll + 1) - ll), min=1e-4)
    dev_sum = torch.where(valid, (occ.sum(-1) - 1).abs(), 0.0)
    e_sum = float(dev_sum.max())
    check(bool((dev_sum <= sum_tol[:, None]).all()),
          f"occupancy sums over s: max |1 - sum| {e_sum:.3g} over the "
          f"bounds {sum_tol.tolist()}")
    rel = rel_l2(occ_b, bd.pack_band(occ, case["layout"]))
    check(rel <= 2e-3, f"banded occupancy vs full: relative L2 {rel:.3g}")

    # Realign: the Viterbi path's +-BAND_SHIFT band through the binding's
    # restricted loss on the packed acts, against the banded loss.
    t_max, s1 = case["logits"].shape[1], case["labels"].shape[1] + 1
    bands2 = bd.bands_from_alignment(full.alignment, ilen, slen, BAND_SHIFT, 0)
    w2 = bd.suggested_band_width(ilen, slen, bands2, t_max, s1)
    check(bool(bd.band_layout_is_exact(ilen, slen, bands2, t_max, s1,
                                       w2).all()), "realigned layout exact")
    layout2 = bd.compute_band_layout(ilen, slen, bands2, t_max, s1, w2)
    with torch.no_grad():
        acts = mt.pack_acts(case["logits"], ilen, slen)
        via_binding = mt.interop.monotonic_rnnt_loss(
            acts, *args, alignment=full.alignment,
            max_distance_from_alignment=BAND_SHIFT)
        del acts
        banded = mt.monotonic_rnnt_loss_banded(
            bd.pack_band(case["logits"], layout2), *args, bands=bands2)
    e_re = assert_close(via_binding, banded, 1e-4, 1e-5,
                        "realigned binding loss vs banded loss")
    timing = {"viterbi_full_ms": cuda_ms(
                  lambda: mt.viterbi_alignment(case["logits"], *args,
                                               bands=clipped),
                  reps=3, warmup=1),
              "viterbi_banded_ms": cuda_ms(
                  lambda: mt.viterbi_alignment_banded(
                      case["logits_band"], *args, bands=case["bands"]),
                  reps=3, warmup=1)}
    log(f"alignment at B,T,S,V={BANDED_CASE} (W={case['w']}): alignments "
        f"identical; scores {full.score.tolist()} (banded max|d| {e_s:.3g}; "
        f"vs own alignment's score {e_own:.3g}; loss {cost.tolist()}); "
        f"occupancy sums max |1 - sum| {e_sum:.3g} (bounds "
        f"{[round(b, 5) for b in sum_tol.tolist()]}), banded vs full relative L2 "
        f"{rel:.3g}; realigned +-{BAND_SHIFT} (W={w2}) binding vs banded "
        f"loss max|d| {e_re:.3g}; launches {launches}; "
        + json.dumps(timing) + f"; phase {time.perf_counter() - t0:.1f} s")
    del full, band, occ, occ_b
    torch.cuda.empty_cache()
    return {"alignment": launches}, {"alignment": errs}, timing


def moved(obj, device):
    """obj with every tensor in it (in tuples, named tuples and dicts) moved
    to device."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(moved(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(moved(v, device) for v in obj)
    return obj


class _Port:
    """The port's modules that the phases use."""

    def __init__(self):
        import monotonic_rnnt_tpu_torch as pkg
        from monotonic_rnnt_tpu_torch import (convert, interop, models,
                                              parallel)
        from monotonic_rnnt_tpu_torch.ops import (alignment, banded, bands,
                                                  chunked, chunked_banded,
                                                  collective, helpers, loss,
                                                  reference)
        from monotonic_rnnt_tpu_torch.models import lm, train
        from monotonic_rnnt_tpu_torch.parallel import sharding
        from monotonic_rnnt_tpu_torch.ops.cuda import (_build, banded_kernels,
                                                       fused, kernels,
                                                       split_kernels, stream)
        from monotonic_rnnt_tpu_torch.ops.cuda import banded as cuda_banded
        from monotonic_rnnt_tpu_torch import serving
        from monotonic_rnnt_tpu_torch.utils import profiling, provenance

        pkg_dir = Path(pkg.__file__).resolve().parent
        if pkg_dir.parent != ROOT:
            raise RuntimeError(f"imported the port from {pkg_dir}, not from "
                               f"this checkout ({ROOT})")
        self.monotonic_rnnt_loss = pkg.monotonic_rnnt_loss
        self.monotonic_rnnt_loss_banded = pkg.monotonic_rnnt_loss_banded
        self.rnnt_loss_fused_joint = pkg.rnnt_loss_fused_joint
        self.rnnt_loss_fused_joint_banded = pkg.rnnt_loss_fused_joint_banded
        self.config_override = pkg.config_override
        self.rnnt_loss_reference = pkg.rnnt_loss_reference
        self.convert, self.build, self.fused, self.K = (convert, _build, fused,
                                                        kernels)
        self.bands, self.banded, self.BK = bands, banded, banded_kernels
        self.SK, self.helpers = split_kernels, helpers
        self.chunked, self.chunked_banded = chunked, chunked_banded
        self.par, self.collective, self.sharding = (parallel, collective,
                                                    sharding)
        self.ST, self.interop, self.profiling = stream, interop, profiling
        self.models, self.loss, self.cuda_banded = models, loss, cuda_banded
        self.alignment, self.reference = alignment, reference
        self.train, self.lm = train, lm
        self.serving, self.provenance = serving, provenance
        for name in ("pack_acts", "unpack_acts", "monotonic_rnnt_loss_packed",
                     "viterbi_alignment", "viterbi_alignment_banded",
                     "occupancy_posteriors", "occupancy_posteriors_banded",
                     "monotonic_rnnt_alignment_score"):
            setattr(self, name, getattr(pkg, name))


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    mt = _Port()
    import golden  # the reference's worked example (tests/golden.py)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({gpu}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build(mt)
    rates, stream_entries = run_ceiling(mt)

    main_inputs = make_inputs(B, T, S, V, seed=SEED,
                              t_range=(3 * T // 4, T), s_range=(3 * S // 5, S))
    weights = torch.linspace(-0.5, 2.0, B, device="cuda")  # one negative
    errs = phase_kernels(mt, main_inputs)
    main_launches, costs_f32 = phase_main(mt, main_inputs, weights,
                                          torch.float32)
    _, costs_bf16 = phase_main(mt, main_inputs, weights, torch.bfloat16)
    phase_cost_only(mt, main_inputs, costs_f32)
    phase_goldens(mt, golden)
    restricted = phase_restricted(mt, main_inputs, weights)
    phase_train(mt, main_inputs)
    kernels, e2e = phase_timing(mt, main_inputs, weights, errs, main_launches)
    glue_timing(mt, main_inputs)
    add_roofline(e2e, rates, main_inputs[0].numel() * 4)
    log(f"end-to-end loss at B={B},T={T},S={S},V={V}: {json.dumps(e2e)}")
    split_errs, split_rows = run_split(mt, main_inputs)
    scan_shapes = {"fwdbwd_scan": (B, T), "alpha_scan": (B, T),
                   "beta_scan": (B, T),
                   "fwdbwd_scan_banded": tuple(BANDED_CASE[:2]),
                   "alpha_scan_banded": tuple(BANDED_CASE[:2])}
    floors = phase_step_floor(mt, sorted(set(scan_shapes.values())))
    band_kernels, band_e2e, band_keep, band_case = run_banded(
        mt, golden, main_inputs, weights, restricted)
    log(f"end-to-end banded loss at B,T,S,V={BANDED_CASE}, shift "
        f"{BAND_SHIFT}: {json.dumps(band_e2e)}")
    # What the alignment and packed phases read waits on the host, so the
    # next phases find the card as without them: ~5.5 GB kept there slowed
    # the host-bound banded fused-joint step.
    parked = moved((main_inputs, restricted, band_case), "cpu")
    del main_inputs, restricted, band_case
    torch.cuda.empty_cache()
    fused_launches, fused_errs, fused_e2e = run_fused_joint(mt)
    log(f"end-to-end fused-joint losses at B,T',S,V,H={FUSED_CASE} and "
        f"B,T,S,V,H={FUSED_BANDED_CASE}: {json.dumps(fused_e2e)}")
    sharded_launches, sharded_errs, partial_entry = run_sharded(
        mt, band_keep, {torch.float32: costs_f32, torch.bfloat16: costs_bf16})
    del band_keep
    model_launches, model_errs = run_model(mt)
    train_launches, train_errs = run_train(mt)
    decode_launches, decode_errs, _ = run_decode(mt, gpu)
    # The alignment, packed and traced phases run last, so that the figures
    # above are taken as without them (a profiler session or thousands of
    # small ops could leave host state behind that slows later host-bound
    # steps).
    main_inputs, restricted, band_case = moved(parked, DEVICE)
    del parked
    serving_launches, serving_errs, _ = run_serving(mt, gpu, main_inputs,
                                                    weights, e2e)
    traced_launches, traced_errs, _ = phase_traced_routes(
        mt, gpu, main_inputs, weights, band_case)
    align_launches, align_errs, align_timing = run_alignment(mt, band_case)
    ratio = (align_timing["viterbi_full_ms"]
             / band_e2e["float32"]["banded_fwd_bwd_ms"])
    log(f"Viterbi at B,T,S,V={BANDED_CASE}: {json.dumps(align_timing)}; the "
        f"full-lattice call over the banded training step: {ratio:.1f}x")
    del band_case
    torch.cuda.empty_cache()
    packed_launches, packed_errs, packed_e2e = run_packed(
        mt, golden, main_inputs, weights, restricted)
    log(f"end-to-end packed loss at B={B},T={T},S={S},V={V}: "
        f"{json.dumps(packed_e2e)}")
    phase_gather_cost(mt)
    phase_trace(mt, main_inputs, weights)
    del main_inputs, restricted
    phase_model_trace(mt)
    phase_decode_trace(mt)
    torch.cuda.empty_cache()
    acc_launches, acc_errs, _ = run_acceptance(mt)
    # Every path's launches and kept calls' max |d|; by_path takes, for
    # each kernel row, the paths that ran it.
    path_launches = {**fused_launches,
                     **sharded_launches, **packed_launches, **align_launches,
                     **model_launches, **train_launches, **decode_launches,
                     **serving_launches, **traced_launches, **acc_launches}
    path_errs = {**fused_errs, **sharded_errs, **packed_errs,
        **align_errs, **model_errs, **train_errs, **decode_errs,
        **serving_errs, **traced_errs, **acc_errs}
    split_kernels = split_kernel_entries(split_errs, split_rows)
    for entries, base in ((kernels, "padded"), (band_kernels, "banded"),
                          (split_kernels, "split"),
                          ([partial_entry], "tp_padded")):
        by_path(entries, base, path_launches, path_errs)
    chunk_entries = {e["name"]: e for e in band_kernels + split_kernels}
    chunk_entries["grad_pass"]["fused_joint_chunk"] = fused_e2e[
        "fused_joint_grad_pass_chunk"]
    for name, where in (("beta_scan", "fused_joint_chunk"),
                        ("alpha_scan", "fused_joint_forward")):
        prefix = ("fused_joint_beta_scan_chunk" if name == "beta_scan"
                  else "fused_joint_alpha_scan")
        chunk_entries[name][where] = {
            k: fused_e2e[f"{prefix}_{k}"]
            for k in ("shape", "ms", "queued_ms", "queued_ns_per_step",
                      "kernel_queued_ms", "kernel_queued_ns_per_step")}
    kernels += band_kernels + split_kernels + [partial_entry] + stream_entries
    for e in kernels:   # the model's paths, on every row (0: not on it)
        for path in ("model", "model_fused_joint", "train",
                     "train_fused_joint", "train_dp", "train_tp", "decode",
                     "decode_lm", "stream", "stream_beam",
                     "decode_marginal", "export", "export_debug",
                     "traced", "acceptance"):
            e["launches_by_path"].setdefault(path, 0)
        unheld = [p for p, n in e["launches_by_path"].items()
                  if n and p not in e["max_abs_err_by_path"]]
        check(not unheld, f"{e['name']}: no kernel call of the paths "
              f"{unheld} was held against its plain version")
    add_ceiling(kernels, rates)
    add_step_floor(kernels, floors, scan_shapes)
    check(len(kernels) == 14, f"the kernels JSON lists {len(kernels)} of 14")
    log(f"total {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                   Path(sys.argv[4])))
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):

1. device  - require CUDA, print the card's name and power limit as
             nvidia-smi reports them, turn TF32 off;
2. build   - compile the CUDA kernels from pacednegatives_tpu_torch/csrc;
3. kernels - each kernel against its plain PyTorch version on the card at
             the serving and training shapes: max |diff| against the stated
             tolerance, median kernel and plain times; the GEMM at the
             serving, training and refresh rows, each beside torch.matmul;
             the fused block's
             backward (K4) also at L 512 / dk 128; the chunked path's
             backward kernels K2b (at its L 512 training shape and at
             dk 128) and K2a (at its L 768 training shape, at Lq 256 /
             Lk 128 and at dk 128; beside the memory-efficient SDPA
             backward on fp32 operands; and bit for bit on inputs where
             its three-term split is exact), and K1 at the serving,
             refresh and L 512 /
             dk 128 shapes and with fp32 output at both training shapes
             (SDPA beside it, and its host cost per call); every dpos and
             every K1 output must be bitwise equal across two runs; K2b
             and K4's core beside the memory-efficient SDPA backward, per
             call and back to back, with their host cost per call, and
             their dpos within the elementwise bound of
             ``dpos_error_bound``;
4. slice   - monoT5 rerank at t5-base width (random weights from a seed,
             flash_v3 on, bf16) through ``Reranker.rerank``: unpacked, then
             packed with length buckets. Launch counts must equal the
             routing's prediction, scores must be finite, and the first
             block's scores must agree with the port run on the CPU;
5. train   - the LCE training step at t5-base width (flash_v3 + fused_qkv,
             bf16, batch 16 x (1 + 7 negatives) x 188 tokens) through
             ``cli.train.main`` for a few optimizer steps: launch counts as
             the routing predicts, finite losses, changed weights; then one
             step with the kernels against the dense route on the same
             weights and batch (loss and per-leaf gradients); then the
             runner's default config (remat with
             ``remat_policy="dots_nobatch"``, K3 recomputed in the
             backward) through ``cli.train.main``; the step under each
             remat policy against remat off (step 1 bit for bit, step ms
             and peak memory); and dropout with ``grad_accum_steps=2`` on
             the dense route (no kernel launched);
6. chunked - the 512-token LCE step with chunked attention and the
             attention-core kernels (t5-base, bf16, batch 16 x (1 + 7) x
             512 tokens in 8 microbatches, bf16 accumulation carry and
             residual) through ``cli.train.main``: K1 and K2b launched
             exactly 12 x 8 times a step and K2a never, finite losses,
             every weight moved; step 1 against the plain chunked route;
             then two steps at L 768, where K2a takes the backward (K2a
             12 times a step, K2b never), and step 1 at L 768 against the
             plain chunked route;
   fused512 - the JAX bench's fused512: flash_v3 + fused_qkv at L 512
             (K3 and K4 12 x 8 times a step, K1 / K2 never) with factored
             moments, bf16 residual and carry, 8 microbatches, through
             ``make_fused_step``; step 1 against the plain chunked route;
7. dense   - the MIPS top-k kernels against their plain versions at the
             dense paths' scales (K6 over an 8.8M-row int8 index, K5 over a
             1M-row fp32 index at k' = 1000, bf16 docs, k' = k against an
             exact top-k): values within an fp32 summation-order bound,
             indices equal except near-tie swaps, two runs bitwise equal;
             the kernels' launch and the merge timed apart, and at k' = k
             the per-block selection beside the one over long runs;
             then ``cli.train.main`` with online mining over an int8 index
             of 16,384 docs (K6 once a step, two refreshes), and
             ``cli.build_pools.main --method dense`` on that run (K5 once
             per 64 queries; pools equal to ``--topk exact``'s up to
             near-tie swaps);
8. evaluate - ``cli.evaluate.main`` on phase 5's run: BM25 top 1000 of
             256 judged queries (planted topics of a 2,048-doc synthetic
             corpus), the top 100 reranked in blocks of 64, paired metrics
             against BM25; bf16 (K3 12 times a block) and ``--int8``
             (``torch._int_mm``, no hand kernel). Launch counts, finite
             scores, every judged query in the per-query file, the bm25
             row equal to the CPU CLI's, and the first two queries' 200
             pairs on the card against the CPU (bf16 and int8); BM25
             build / search seconds, rerank docs/s, CLI seconds;
9. curricula - ``cli.train.main`` at phase 5's preset for 6 steps under
             each pacing curriculum: interp, level, eta and contrast (the
             pair loss: K3 = K4 = 12 a step over 32 rows), meta-cheap (K3
             48, K4 24 a step) and, dense, 2 steps of meta-std (no
             kernel). Launch counts, finite losses, every weight moved,
             median step ms of steps 2-6, and each difficulty trajectory
             (the pool slots drawn included) equal to the controller's
             rule replayed on the host from the logged metrics; one pair
             step and one meta-cheap step with the kernels against the
             dense route; one meta-std step under ``dots_nobatch``
             against remat off; the pair step alone, timed and one step
             profiled; meta-std's
             v-gradient at t5-base in fp32 against central finite
             differences; and meta-std refusing the kernels' routes.

Then a JSON line with one entry per kernel (its time beside its bound, its
plain version's and, where one PyTorch call computes the same function,
that call's), and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pacednegatives_tpu_torch import kernels
from pacednegatives_tpu_torch.cli.build_pools import main as build_pools_main
from pacednegatives_tpu_torch.cli.evaluate import main as evaluate_main
from pacednegatives_tpu_torch.cli.train import main as train_main
from pacednegatives_tpu_torch.curriculum import (
    EtaController,
    MetaWeightTable,
)
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.eval.run_io import read_trec_run
from pacednegatives_tpu_torch.index import bm25
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.dual_encoder import encode_corpus
from pacednegatives_tpu_torch.ops.flash import (
    NEG_INF,
    attention_backward,
    attention_backward_plain,
    dpos_error_bound,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_backward_v2,
    flash_attention_backward_v2_plain,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from pacednegatives_tpu_torch.ops.flash_v3 import (
    fused_self_attention,
    fused_self_attention_plain,
    v3_backward,
    v3_backward_plain,
    v3_forward,
)
from pacednegatives_tpu_torch.ops import mips
from pacednegatives_tpu_torch.ops.gemm import gemm, gemm_plain
from pacednegatives_tpu_torch.ops.mips import (
    block_scores,
    mips_topk_exact,
    mips_topk_pallas,
    mips_topk_pallas_plain,
    mips_topk_pallas_quantized,
    mips_topk_pallas_quantized_plain,
    quantize_embeddings,
)
from pacednegatives_tpu_torch.optim import tree_leaves
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_fused_step,
    make_meta_train_step,
    make_optimizer,
    make_train_step,
    pair_index_stream,
)
from pacednegatives_tpu_torch.train.loop import CHECKPOINT_FILE, MetricWriter
from pacednegatives_tpu_torch.train.runner import load_run

BF16_ULP_REL = 2.0**-7  # one bf16 ulp, relative to the largest magnitude
B_SERVE, L_SERVE = 256, 188  # Reranker batch and t5-base prompt length
N_QUERIES, N_CANDIDATES = 64, 100
# The training slice (bench.py:117-126): batch 16 pairs x (1 + 7 sampled
# negatives) = 128 rows of 188 tokens, pools of 100 over 2048 docs.
B_TRAIN, N_NEG_TRAIN, TRAIN_STEPS = 16, 7, 8
ROWS_TRAIN = B_TRAIN * (1 + N_NEG_TRAIN)
# Step 1 with the kernels against the dense route, same weights and batch,
# both bf16: the routes round at different points (K3 rounds the
# unnormalised probabilities against the running max, the dense path the
# normalised weights; K4 recomputes its own), ~2^-8 relative per rounding,
# compounded over 12 + 12 layers forward and back. The same comparison run
# on the CPU at t5-base width (plain versions, bf16, 12 rows) gave a loss
# 2.1e-4 apart and per-leaf gradient errors ||on - off|| / ||off|| of
# median 0.018 and max 0.057 (encoder block 0's q); in fp32 the two routes
# agree to 1.3e-4 at most. A routing or gradient fault (a wrong head, a lost
# dpos, a transposed weight) is O(1) on the leaves it touches.
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_REL_L2 = 0.15  # per leaf
STEP_GRAD_REL_L2_MEDIAN = 0.05  # over the leaves
# First-block scores, GPU kernels vs the CPU plain versions, both bf16:
# the two differ by bf16 rounding flips (different summation order) that
# accumulate over 12 + 12 layers; the verbalizer log-probs are O(1) and a
# scoring difference that matters (a routing, mask or cast error) is O(0.1).
SCORE_ATOL = 5e-2
# The chunked 512-token slice: the JAX bench's fused512 training phase
# (bench.py:1203-1227) with flash_v3 off, so that the encoder runs the
# chunked core and its kernels: 16 pairs x (1 + 7) = 128 rows of
# 24 + 484 + 4 = 512 tokens in 8 microbatches.
B512, N512, STEPS512, MB512 = 16, 7, 4, 8
ROWS512 = B512 * (1 + N512) // MB512  # one microbatch: the kernels' batch
# Step 1, kernel route (K1 + K2b) against the plain chunked route on the
# same weights and batch, both bf16 with a bf16 carry. K2b's arithmetic is
# the plain backward's; the forwards differ where K1 rounds the
# unnormalised p against a running max over 64-key tiles and the plain
# route against the row's final max (one bf16 ulp at most). A CPU rehearsal
# at t5-base width (8 rows of 512 tokens, 2 microbatches, bf16 carry)
# modelled that with the plain route at chunk 64 against chunk 512: loss
# 2.2e-5 apart, per-leaf ||on - off|| / ||off|| of median 0.025 and max
# 0.054 (encoder block 0's q); in fp32, 6.9e-4 at most. The kernel route's
# plain versions against the plain route at chunk 512 gave the same bits.
# A routing or gradient fault (a lost dpos, a wrong head, a dpos group
# dropped) is O(1) on the leaves it touches. K2a's numerics in place of
# K2b's would not show here (the two differ by bf16 rounding of the
# operands, a few bf16 ulps): phase 3's per-kernel tolerance and the
# separate launch counts catch that swap.
STEP512_LOSS_RTOL = 1e-3
STEP512_GRAD_REL_L2 = 0.15  # per leaf
STEP512_GRAD_REL_L2_MEDIAN = 0.075  # over the leaves
# The K2a path: t5-base at 24 + 740 + 4 = 768 tokens, where the resident
# estimate passes the 48 MiB gate (flash_v2_eligible) and K2a runs. Keys
# in chunks of 256, so none are padded and the kernels see Lk = 768.
B768, N768, STEPS768 = 2, 3, 2
ROWS768 = B768 * (1 + N768)  # one microbatch: the kernels' batch
# Step 1 at L 768, kernel route (K1 + K2a) against the plain chunked route
# (256-key chunks), same weights and batch, both bf16 with an fp32 carry.
# K2a keeps fp32 operands where the plain route's backward rounds p, g and
# ds to bf16 (a few bf16 ulps on the attention gradients), and K1 rounds
# the unnormalised p against the running max of 64-key tiles. A CPU
# rehearsal at t5-base width modelled both
# (scripts/torch_attention_bwd_step_rehearsal.py: K1 as the plain route at
# 64-key chunks, K2a as its plain version), at 8 rows: losses equal,
# per-leaf ||on - off|| / ||off|| of median 2.7e-5 and max 0.0082 (encoder
# block 0's q; 0.0087 at 2 rows). On the card the forwards also sum in
# other orders (K1's tiles against the plain route's matmuls), so bf16
# flips spread through 12 + 12 layers as at L 512, whose gradient
# tolerances cover that (its rehearsal: median 0.025, max 0.054): the same
# ones here, with K2a's share (0.0082) well inside. The loss is the
# forward's alone and sums 8 rows where L 512's sums 128: a first run on
# the card read 5.0e-4 (L 512: 1.1e-4), so 10x that. A routing or gradient
# fault (a lost dpos, a wrong head, a dropped key chunk, a wrong mask) is
# O(1) on the leaves it touches; a K2a arithmetic fault smaller than that
# is phase 3's to catch.
STEP768_LOSS_RTOL = 5e-3
STEP768_GRAD_REL_L2 = 0.15  # per leaf
STEP768_GRAD_REL_L2_MEDIAN = 0.075  # over the leaves
# Tolerances of the chunked path's backward kernels against their plain
# versions on the card (outputs fp32 on both sides, never rounded):
# K2b rounds p, g and ds to bf16 on both sides, and a value whose fp32 sums
# differ in the last bit (another summation order) may round one bf16 ulp
# apart, so one bf16 ulp of each output's largest magnitude bounds dq, dk
# and dv; dpos sums the unrounded fp32 ds in another order: within the
# elementwise bound of ``dpos_error_bound`` (as K4's core). K2a multiplies
# fp32 operands on both sides: the plain version in fp32 (TF32 off), the
# kernel as sums of products of three bf16 terms of each operand, which
# hold it exactly, but for dV's dropped cross terms (<= 2^-23 of sum p|g|;
# t5_attention_bwd_fp32.cu); so the two differ by fp32 summation order (the
# tensor cores' accumulation truncates) and p's MUFU exp and 1 / l: 1e-4
# of the largest, dpos included.
K2B_TOL = BF16_ULP_REL
K2A_TOL, K2A_DPOS_TOL = 1e-4, 1e-4
# The least time the card could take (H100 SXM data sheet): bytes over
# 3.35 TB/s, operations over the peak of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


# Phase 7. K6 at the JAX bench's 4096-aligned MS MARCO point (bench.py:
# 581-586) with the online pool of 128 + 1 and its tiling (bench.py:635-638,
# online.py:75-76): 6.8 GB of int8. K5 at the build_pools call of the
# bench's 1M point (1000 per query, block 1024, k' = k). As (B, N, D, k,
# block_n, k'): k' None takes the wrappers' default min(k, block_n).
MSMARCO_N = 8_806_400
K6_SCALE = (16, MSMARCO_N, 768, 129, 4096, 32)
K6_ONLINE = (16, 16_384, 768, 65, 4096, 32)  # 7b's call
K5_POOLS = (64, 1_003_520, 768, 1000, 1024, None)
K5_BF16 = (16, 262_144, 768, 129, 4096, 32)
K5_EXACT = (16, 262_144, 768, 129, 4096, 129)
# Value tolerance of a MIPS kernel against its plain version: a D-term dot
# product summed in another order differs by at most D * 2^-23 * sum|q_i
# d_i| <= D * 2^-23 * |q| |d| (per-add error 2^-24, doubled because the
# tensor cores' fp32 accumulation truncates); the embeddings are unit rows
# (int8: |dequantised row| within 1% of 1), so with |q| = 1 the bound is
# D * 2^-23 * 1.01. Indices may differ only between near-ties: where they
# do, the kernel's doc must score (plain arithmetic) within the same bound
# of the plain version's doc at that rank.
def mips_tol(D: int) -> float:
    return D * 2.0**-23 * 1.01


# Phase 7b: phase 5's t5-base preset with online mining over an int8 index
# of 16,384 docs (four 4096-row blocks: the multi-block merge runs with
# k' 32 < k 65), pools of 64, refresh every 2 steps, 4 steps.
ONLINE_STEPS = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
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
    return statistics.median(times)


def time_ms_back_to_back(fn, calls: int = 20, warmup: int = 3,
                         reps: int = 5) -> float:
    """Median device time per call of ``calls`` calls of ``fn`` issued back
    to back between one pair of CUDA events, as a loop of calls runs (a
    refresh's 1,536 forwards): the wrapper's host time hides under the
    card's work unless it exceeds it. ``time_ms`` synchronises after every
    call, so for a call of ~0.1 ms it also counts the host's time to
    enqueue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, err: float, tol: float, **fields) -> dict:
    """Emit one comparison and fail the run if it is out of tolerance."""
    ok = err <= tol
    emit("kernels", check=name, max_abs_err=err, tol=tol, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{name}: max |diff| {err} > tolerance {tol}")
    return {"max_abs_err": err, **fields}


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """{"bound_ms", "bound_by"}: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


# L x L x dk products of the chunked path's backward function, each counted
# once, on the tensor cores' bf16 peak: K2b's five (s, dp, dv, dq, dk) on
# bf16 operands; K2a's five with each fp32 operand held in three bf16
# terms (csrc/t5_attention_bwd_fp32.cu): S 1 (q and k are bf16), dP 3,
# dV 6 (the pairs i + j <= 2), dQ 3, dK 3. What the kernels recompute
# (S and dP in both passes; K2a's S^T and dP^T once for each 64-column
# half at dk 128) is their cost, not the function's: 7 + 13 (7 + 17)
# passes where K2a's function needs 16, 3 + 4 where K2b's needs 5.
CORE_BWD_PRODUCTS = {"k2b": 5, "k2a": 16}


def core_bwd_bytes(B: int, H: int, Lq: int, Lk: int, dk: int) -> int:
    """K2b's and K2a's bytes: q, k, v (bf16), g, dcap, m, l, pos and the key
    mask in, dq, dk, dv and dpos out (fp32), each once."""
    return (B * H * (Lq + 2 * Lk) * dk * 2 + B * H * Lq * dk * 4
            + 3 * B * H * Lq * 4 + 2 * H * Lq * Lk * 4 + B * Lk * 4
            + B * H * (Lq + 2 * Lk) * dk * 4)


def core_bwd_bound(kernel: str, B: int, H: int, Lq: int, Lk: int,
                   dk: int) -> dict:
    """K2b's or K2a's bound: its bytes, and its products as
    ``CORE_BWD_PRODUCTS`` counts them."""
    return bound(core_bwd_bytes(B, H, Lq, Lk, dk),
                 CORE_BWD_PRODUCTS[kernel] * 2 * B * H * Lq * Lk * dk, "bf16")


def k2a_exact_probe(B: int, H: int, Lq: int, Lk: int, dk: int,
                    device: str, g: torch.Generator) -> tuple:
    """K2a's arguments (q, k, v, pos, key_mask, m, l, dcap, g) on which
    each of its products is exact in fp32 when every fp32 operand is held
    in three bf16 terms, and is not when in two: so the kernel must equal
    its plain version (and exact arithmetic) bit for bit. q has entries in
    {-1, 0, 1}, the same in every batch row; k and v have one-hot rows (key
    j at column j % dk); pos = -q k^T, m = 0, l = 1 and the key mask 0
    (keys past 3 Lk / 4 masked in batch row 1): s = 0 and p = 1 (or 0).
    g = +-(1 + n 2^-18), n < 2^18, on the query rows that are multiples of
    16 (one row a 16-row wgmma step), 0 elsewhere; dcap = 0. Then ds = dP
    = g at column j % dk, which has up to 19 significant bits: three bf16
    terms hold it, two leave up to 2^-17. Every sum adds values that are
    multiples of 2^-18 below 2^5 (dq: Lk / dk <= 12 copies; dk, dv: <= Lq /
    16 rows; dpos: B rows), so every order of it is exact when Lq <= 256
    and B <= 8. p's split is not probed (p = 1 has one term)."""
    assert Lq <= 256 and B <= 8 and Lk <= 12 * dk
    q1 = torch.randint(-1, 2, (1, H, Lq, dk), generator=g, device=device)
    q = q1.expand(B, H, Lq, dk).to(torch.bfloat16).contiguous()
    onehot = torch.nn.functional.one_hot(
        torch.arange(Lk, device=device) % dk, dk).float()
    k = onehot.expand(B, H, Lk, dk).to(torch.bfloat16).contiguous()
    v = k.clone()
    pos = -(q1[0].float() @ onehot.t()).contiguous()
    key_mask = torch.zeros((B, Lk), device=device)
    if B > 1:
        key_mask[1, 3 * Lk // 4:] = NEG_INF
    n = torch.randint(0, 2**18, (B, H, Lq, dk), generator=g, device=device)
    sign = torch.randint(0, 2, (B, H, Lq, dk), generator=g,
                         device=device) * 2 - 1
    gv = sign * (1 + n.double() * 2.0**-18)
    gv[:, :, torch.arange(Lq, device=device) % 16 != 0] = 0
    zeros = torch.zeros((B, H, Lq), device=device)
    return (q, k, v, pos, key_mask, zeros, zeros + 1, zeros.clone(),
            gv.float().contiguous())


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------


def phase_device() -> tuple[dict, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the GPU and has no CPU mode", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    # fp32 references in full fp32; bf16 GEMMs accumulate in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", **device, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False,
         allow_bf16_reduced_precision_reduction=False)
    return device, smi


def phase_build() -> None:
    so, seconds = kernels.build()
    kernels.library()
    ptxas = [line.strip() for line in kernels.build_log().splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    emit("build", seconds=seconds, library=so.name, ptxas=ptxas)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(g, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _key_mask(g, B, L):
    lens = torch.randint(L // 2, L + 1, (B,), generator=g, device="cuda")
    keep = torch.arange(L, device="cuda")[None] < lens[:, None]
    return torch.where(keep, 0.0, NEG_INF).float().contiguous()


def phase_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    D, H, dk = 768, 12, 64
    inner = H * dk
    M = B_SERVE * L_SERVE
    results = {}

    # GEMM, at the two projections of one layer, at the serving block's
    # rows (256 x 188), a training step's (128 x 188) and a refresh
    # batch's (128 x 160). Tolerance: both round an fp32 sum to bf16; the
    # sums differ only in order, so a result may differ by one bf16 ulp, at
    # most 2^-7 of |C|max.
    gemm_rows = {}
    for prefix, rows in (("", M), ("train_", ROWS_TRAIN * L_SERVE),
                         ("refresh_", 128 * 160)):
        a = _randn(g, rows, D)
        for label, n, scale in (("qkv", 3 * inner, D**-0.5),
                                ("o", D, inner**-0.5)):
            w = _randn(g, D if label == "qkv" else inner, n, scale=scale)
            ref = gemm_plain(a, w)
            err = max_abs(gemm(a, w), ref)
            tol = BF16_ULP_REL * ref.float().abs().max().item()
            K = a.shape[1]
            gemm_rows[prefix + label] = check(
                f"gemm_{prefix}{label}", err, tol, shape=[rows, K, n],
                ms=time_ms(lambda: gemm(a, w)),
                plain_ms=time_ms(lambda: gemm_plain(a, w)),
                # the yardstick: one cuBLAS product (the plain version is
                # the same call)
                library_ms=time_ms(lambda: torch.matmul(a, w)),
                **bound(2 * (rows * K + K * n + rows * n),
                        2 * rows * K * n, "bf16"),
            )
    results["gemm"] = gemm_rows

    # Attention core. Tolerances: out (fp32 here) <= 2e-2 absolute at
    # unit-scale inputs, from the bf16 rounding of the unnormalised p
    # (2^-9 relative) taken against the running max in the kernel and the
    # final max in the plain version; m <= 1e-3 absolute and l <= 1e-3
    # relative (fp32 sums in another order).
    att = {}
    cases = (
        # the slice: q/k/v strided views into the fused (B, L, 3*H*dk) qkv
        # buffer, heads written into a (B, L, H, dk) buffer, as K3 calls it
        ("slice", B_SERVE, 12, L_SERVE, 64, True),
        # a refresh batch of the online encoder (128 docs of 160 tokens)
        ("refresh", 128, 12, 160, 64, True),
        ("L512_dk128", 32, 12, 512, 128, False),
    )
    for label, B, Hc, L, d, fused_layout in cases:
        if fused_layout:
            qkv = _randn(g, B, L, 3, Hc, d)
            q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
        else:
            q, k, v = (_randn(g, B, Hc, L, d) for _ in range(3))
        pos = (torch.randn((Hc, L, L), generator=g, device="cuda")
               * 0.5).contiguous()
        km = _key_mask(g, B, L)
        ref, rm, rl = flash_attention_forward_plain(q, k, v, pos, km,
                                                    torch.float32)
        out32 = torch.empty((B, L, Hc, d), dtype=torch.float32, device="cuda")
        o, m, l = flash_attention_forward(q, k, v, pos, km,
                                          out=out32.transpose(1, 2))
        _attention_repeats(label, (o, m, l), lambda: flash_attention_forward(
            q, k, v, pos, km, out=torch.empty_like(out32).transpose(1, 2)))
        check(f"attention_{label}_m", max_abs(m, rm), 1e-3)
        check(f"attention_{label}_l_rel",
              ((l - rl).abs() / rl).max().item(), 1e-3)
        # timed as the slice runs it: bf16 out, K3's layout
        out16 = torch.empty((B, L, Hc, d), dtype=torch.bfloat16, device="cuda")
        launch16 = lambda: flash_attention_forward(
            q, k, v, pos, km, out=out16.transpose(1, 2))
        # the yardstick: one scaled_dot_product_attention call, T5's unit
        # scale, the position bias and key mask summed into one (B, H, L,
        # L) bf16 attn_mask (built outside the timing)
        mask = (pos[None] + km[:, None, None, :]).to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library = lambda: sdpa(q, k, v, attn_mask=mask, scale=1.0)
        qkv_bytes = 4 * B * Hc * L * d * 2  # q, k, v in, out out (bf16)
        att[label] = check(
            f"attention_{label}_out", max_abs(o, ref), 2e-2,
            shape=[B, Hc, L, d], fused_layout=fused_layout,
            ms=time_ms(launch16), host_us=_host_us(launch16),
            ms_back_to_back=time_ms_back_to_back(launch16),
            plain_ms=time_ms(lambda: flash_attention_forward_plain(
                q, k, v, pos, km, out=out16.transpose(1, 2))),
            library_ms=time_ms(library),
            library_ms_back_to_back=time_ms_back_to_back(library),
            # q.k^T and p.v; pos and key mask in, (m, l) out (fp32)
            **bound(qkv_bytes + Hc * L * L * 4 + B * L * 4
                    + 2 * B * Hc * L * 4, 4 * B * Hc * L * L * d, "bf16"),
        )
        del mask
    # K1 as the chunked path calls it: fp32 output, (B, H, L, dk) buffers,
    # at the shapes of phase 6's two runs (one microbatch each)
    for label, B, L in (("train512", ROWS512, 512),
                        ("train768", ROWS768, 768)):
        q, k, v = (_randn(g, B, H, L, dk) for _ in range(3))
        pos = (torch.randn((H, L, L), generator=g, device="cuda")
               * 0.5).contiguous()
        km = _key_mask(g, B, L)
        ref, rm, rl = flash_attention_forward_plain(q, k, v, pos, km,
                                                    torch.float32)
        o, m, l = flash_attention_forward(q, k, v, pos, km, torch.float32)
        _attention_repeats(label, (o, m, l), lambda: flash_attention_forward(
            q, k, v, pos, km, torch.float32))
        check(f"attention_{label}_m", max_abs(m, rm), 1e-3)
        check(f"attention_{label}_l_rel", ((l - rl).abs() / rl).max().item(),
              1e-3)
        mask = (pos[None] + km[:, None, None, :]).to(torch.bfloat16)
        launch32 = lambda: flash_attention_forward(q, k, v, pos, km,
                                                   torch.float32)
        # the yardstick as above (its output is bf16, not fp32)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0)
        att[f"{label}_fp32_out"] = check(
            f"attention_{label}_out", max_abs(o, ref), 2e-2,
            shape=[B, H, L, dk],
            ms=time_ms(launch32), host_us=_host_us(launch32),
            ms_back_to_back=time_ms_back_to_back(launch32),
            plain_ms=time_ms(lambda: flash_attention_forward_plain(
                q, k, v, pos, km, torch.float32)),
            library_ms=time_ms(library),
            library_ms_back_to_back=time_ms_back_to_back(library),
            # q, k, v in (bf16), out (fp32); pos, key mask in, (m, l) out
            **bound(3 * B * H * L * dk * 2 + B * H * L * dk * 4
                    + H * L * L * 4 + B * L * 4 + 2 * B * H * L * 4,
                    4 * B * H * L * L * dk, "bf16"),
        )
        del mask
    results["attention"] = att
    # K2b and K2a at the shapes of phase 6's runs (several dpos groups of
    # DPOS_ROWS_PER_GROUP rows each), plus dk 128 and Lq != Lk
    results["core_bwd"] = {
        "k2b_train512": _check_core_bwd(g, "k2b", ROWS512, 12, 512, 512,
                                        64),
        "k2b_dk128": _check_core_bwd(g, "k2b", 4, 16, 512, 512, 128),
        "k2a_L768": _check_core_bwd(g, "k2a", ROWS768, 12, 768, 768, 64),
        "k2a_Lq256_Lk128": _check_core_bwd(g, "k2a", 4, 12, 256, 128, 64),
        "k2a_dk128": _check_core_bwd(g, "k2a", 4, 16, 768, 768, 128),
        # K2a on inputs where three bf16 terms make it exact and two do not
        "k2a_exact_dk64": _check_k2a_exact(g, 5, 2, 70, 768, 64),
        "k2a_exact_dk128": _check_k2a_exact(g, 5, 2, 70, 768, 128),
    }

    # The fused block (K3) at the slice shape and at fused512's (one
    # microbatch of 512 tokens)
    results["fused_self_attention"] = {
        "serving": _check_k3(g, "serving", B_SERVE, L_SERVE),
        "train512": _check_k3(g, "train512", ROWS512, 512),
    }
    results["v3_backward"] = {
        label: _check_k4(g, label, *shape)
        for label, shape in (("train", (ROWS_TRAIN, L_SERVE, 12, 64)),
                             ("train512", (ROWS512, 512, 12, 64)),
                             ("L512_dk128", (32, 512, 12, 128)))
    }
    return results


def _attention_repeats(label: str, first, again_fn) -> None:
    """K1's (out, m, l) must be bitwise equal across two runs."""
    again = again_fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    emit("kernels", check=f"attention_{label}_bitwise_repeat", ok=same)
    if not same:
        raise AssertionError(f"attention {label}: two runs differ")


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue (the wrapper's
    checks, allocations and tensor-map encoding, the launch), with the card
    kept busy so that the queue never drains: one warm-up call, then
    ``calls`` calls timed by the host clock without a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def _dpos_check(name: str, got, ref, args, dcap=None) -> float:
    """dpos against its plain version within the elementwise bound of
    ``dpos_error_bound`` (args: K4's (q, k, v, g, pos, key_mask, m, l)):
    the check's value is max |got - ref| / bound, which must be <= 1."""
    bound = dpos_error_bound(*args, dcap)
    err = (got.double() - ref.double()).abs()
    ratio = float((err / bound.clamp_min(1e-300)).max())
    check(f"{name}_dpos_over_bound", ratio, 1.0,
          dpos_max_abs_err=float(err.max()), dpos_bound_max=float(bound.max()),
          dpos_max=float(ref.abs().max()))
    del bound, err
    torch.cuda.empty_cache()
    return ratio


def _sdpa_bwd_library(q, k, v, g, pos, km, dtype=torch.bfloat16,
                      stats=None, ref=None) -> dict:
    """The yardstick of the attention backward kernels: one
    ``aten._scaled_dot_product_efficient_attention_backward`` call (dq, dk,
    dv and the (B, H, Lq, Lk) gradient of the bias) plus the batch sum of
    that gradient (dpos), on q/k/v/g in ``dtype`` and pos + key mask as one
    attn_bias of that dtype (the op takes one dtype: bf16 for K2b and K4's
    core, whose fp32 g is rounded; fp32 for K2a). out and the logsumexp come
    from the op's forward, outside the timing, or with ``stats`` = (out, m,
    l) from the kernels' forward (logsumexp = m + log l), so that the op
    computes K2a's function on K2a's inputs. The bias's rows are padded to
    16 bytes, as SDPA pads them. Never called by the port. {"library_ms":
    ms or None, "library_ms_back_to_back": ms or None, "library_note": why
    None}, and with ``ref`` (dq, dk, dv, dpos) "library_err_rel": max |op -
    ref| / max |ref| of each."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    qc, kc, vc, gc = (t.to(dtype).contiguous() for t in (q, k, v, g))
    bias = torch.empty((B, H, Lq, -(-Lk // 8) * 8), dtype=dtype,
                       device="cuda")[..., :Lk]
    bias.copy_(pos[None] + km[:, None, None, :])
    ops = torch.ops.aten
    try:
        out, lse, seed, offset = ops._scaled_dot_product_efficient_attention(
            qc, kc, vc, bias, True, 0.0, False, scale=1.0)
        if stats is not None:
            o, m, l = stats
            out = o.to(dtype).contiguous()
            lse = lse.clone()
            lse[..., :Lq] = m + torch.log(l)

        def run():
            grads = ops._scaled_dot_product_efficient_attention_backward(
                gc, qc, kc, vc, bias, out, lse, seed, offset, 0.0,
                [True, True, True, True], False, scale=1.0)
            return (*grads[:3], grads[3].sum(dim=0))

        got = run()
        err = {} if ref is None else {"library_err_rel": {
            name: max_abs(a, b) / b.abs().max().item()
            for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, ref)}}
        del got
        return {"library_ms": time_ms(run),
                "library_ms_back_to_back": time_ms_back_to_back(run),
                "library_note": None, **err}
    except RuntimeError as e:
        return {"library_ms": None, "library_ms_back_to_back": None,
                "library_note": str(e).strip().splitlines()[0][:200]}


def _check_k3(g, label, B, L) -> dict:
    """The fused block (K3: GEMM + ``t5_attention_fwd`` + GEMM) against
    ``fused_self_attention_plain``, T5-initialised weights and unit-scale
    activations. Tolerance: y is rounded to bf16 once (one ulp) on top of
    the attention outputs' own one-ulp flips carried through Wo (~2^-8
    relative): 2^-6 of |y|max covers both."""
    D, H, dk = 768, 12, 64
    inner = H * dk
    x = _randn(g, B, L, D)
    wqkv = torch.cat([_randn(g, D, inner, scale=(D * dk) ** -0.5),
                      _randn(g, D, 2 * inner, scale=D**-0.5)], dim=1)
    wo = _randn(g, inner, D, scale=inner**-0.5)
    rel_bias = torch.randn((32, H), generator=g, device="cuda") * D**-0.5
    pos3 = t5.compute_position_bias(rel_bias, L, L, True, 32,
                                    128)[0].contiguous()
    km = _key_mask(g, B, L)
    args = (x, wqkv, wo, pos3, km)
    ref = fused_self_attention_plain(*args)
    rows = B * L
    return check(
        f"fused_self_attention_{label}",
        max_abs(fused_self_attention(*args), ref),
        4 * BF16_ULP_REL * ref.float().abs().max().item(),
        shape=[B, L, D],
        ms=time_ms(lambda: fused_self_attention(*args)),
        plain_ms=time_ms(lambda: fused_self_attention_plain(*args)),
        library_ms=None,  # no single PyTorch call computes the block
        # the whole call (K3): x, Wqkv, Wo in and y out (bf16); pos, key
        # mask in and (m, l) out (fp32); both projections and the core
        **bound(2 * (2 * rows * D + D * 3 * inner + inner * D)
                + H * L**2 * 4 + B * L * 4 + 2 * B * H * L * 4,
                2 * rows * D * 4 * inner + 4 * B * H * L**2 * dk, "bf16"),
    )


def _check_k4(g, label, B, L, H, dk) -> dict:
    """The fused block's backward (K4: GEMM + ``t5_attention_bwd``) against
    ``v3_backward_plain`` on the same bf16 inputs and the same (m, l).

    Tolerances: dqkv and attn are fp32 sums rounded once to bf16 on both
    sides, in another order, from probabilities and ds that may round to
    bf16 one ulp apart: 2 bf16 ulps of each output's largest magnitude.
    dpos is an fp32 sum of ds over the batch rows in another order: the
    core's against its plain version on the same q/k/v within the
    elementwise bound of ``dpos_error_bound``, and the whole call's equal
    to the core's bit for bit (the plain call's GEMM may round q/k/v one
    bf16 ulp apart, outside what the bound covers). Every output must be
    bitwise equal across two runs (fixed reduction order, no atomics)."""
    D = 768
    inner = H * dk
    x = _randn(g, B, L, D)
    wqkv = torch.cat([_randn(g, D, inner, scale=(D * dk) ** -0.5),
                      _randn(g, D, 2 * inner, scale=D**-0.5)], dim=1)
    wo = _randn(g, inner, D, scale=inner**-0.5)
    rel_bias = torch.randn((32, H), generator=g, device="cuda") * D**-0.5
    pos3 = t5.compute_position_bias(rel_bias, L, L, True, 32,
                                    128)[0].contiguous()
    km = _key_mask(g, B, L)
    _, m, l = v3_forward(x, wqkv, wo, pos3, km)
    d_attn = _randn(g, B, L, inner)
    args = (x, wqkv, pos3, km, m, l, d_attn)
    ref = v3_backward_plain(*args)
    got = v3_backward(*args)
    again = v3_backward(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dqkv", "attn"), got[:2], ref[:2]):
        check(f"v3_backward_{label}_{name}", max_abs(a, b),
              2 * BF16_ULP_REL * b.float().abs().max().item())
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    emit("kernels", check=f"v3_backward_{label}_bitwise_repeat",
         ok=deterministic)
    if not deterministic:
        raise AssertionError(f"v3_backward {label}: two runs differ")
    # the hand kernel alone (K4's core) on the same q/k/v views, so the
    # GEMM's rounding stays out of the comparison
    qkv = gemm(x.reshape(B * L, D), wqkv).view(B, L, 3, H, dk)
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    gv = d_attn.view(B, L, H, dk).transpose(1, 2)
    core = (q, k, v, gv, pos3, km, m, l)
    core_ref = attention_backward_plain(*core)
    core_got = attention_backward(*core)
    torch.cuda.synchronize()
    same = torch.equal(got[2], core_got[4])
    emit("kernels", check=f"v3_backward_{label}_dpos_equals_core", ok=same)
    if not same:
        raise AssertionError(f"v3_backward {label}: dpos is not the core's")
    errs = {
        name: check(f"t5_attention_bwd_{label}_{name}", max_abs(a, b),
                    2 * BF16_ULP_REL * b.float().abs().max().item())
        ["max_abs_err"]
        for name, a, b in zip(("dq", "dk", "dv", "attn"), core_got[:4],
                              core_ref[:4])
    }
    errs["dpos_over_bound"] = _dpos_check(f"t5_attention_bwd_{label}",
                                          core_got[4], core_ref[4], core)
    del core_got, core_ref
    launch = lambda: attention_backward(*core)
    return {
        "shape": [B, L, H, dk], "max_abs_err": max(
            errs[n] for n in ("dq", "dk", "dv", "attn")),
        "errors": errs, "bitwise_repeat": deterministic,
        "ms": time_ms(launch), "host_us": _host_us(launch),
        "ms_back_to_back": time_ms_back_to_back(launch),
        "plain_ms": time_ms(lambda: attention_backward_plain(*core)),
        # it also recomputes out; the yardstick does not
        **_sdpa_bwd_library(q, k, v, gv, pos3, km),
        # q, k, v, g in and dq, dk, dv, attn out (bf16); pos and dpos (H,
        # L, L), key mask, m, l (fp32); six products: s, o, dv, dp, dq, dk
        **bound(8 * B * H * L * dk * 2 + 2 * H * L * L * 4 + B * L * 4
                + 2 * B * H * L * 4, 6 * 2 * B * H * L * L * dk, "bf16"),
        "k4_ms": time_ms(lambda: v3_backward(*args)),
        "k4_plain_ms": time_ms(lambda: v3_backward_plain(*args)),
        # the whole call (K4): x, Wqkv, d_attn in and dqkv, attn out
        # (bf16); pos, key mask, m, l in and dpos out (fp32); the qkv
        # recompute's GEMM and the core's six products
        **{"k4_" + key: val for key, val in bound(
            2 * (B * L * D + D * 3 * inner + 2 * B * L * inner
                 + B * L * 3 * inner)
            + 2 * H * L * L * 4 + B * L * 4 + 2 * B * H * L * 4,
            2 * B * L * D * 3 * inner + 6 * 2 * B * H * L * L * dk,
            "bf16").items()},
    }


def _check_core_bwd(g, kernel, B, H, Lq, Lk, dk) -> dict:
    """K2b or K2a against its plain version on the same bf16 q/k/v, fp32
    cotangent and the forward's (m, l); all outputs, dpos among them, must
    be bitwise equal across two runs (fixed reduction order, no atomics)."""
    fn, plain, tol = {
        "k2b": (flash_attention_backward_v2, flash_attention_backward_v2_plain,
                K2B_TOL),
        "k2a": (flash_attention_backward, flash_attention_backward_plain,
                K2A_TOL),
    }[kernel]
    label = f"{kernel}_B{B}_H{H}_Lq{Lq}_Lk{Lk}_dk{dk}"
    q = _randn(g, B, H, Lq, dk)
    k, v = (_randn(g, B, H, Lk, dk) for _ in range(2))
    pos = (torch.randn((H, Lq, Lk), generator=g, device="cuda")
           * 0.5).contiguous()
    km = _key_mask(g, B, Lk)
    out, m, l = flash_attention_forward(q, k, v, pos, km, torch.float32)
    gout = torch.randn((B, H, Lq, dk), generator=g, device="cuda")
    dcap = (gout * out).sum(dim=-1)
    args = (q, k, v, pos, km, m, l, dcap, gout)
    ref = plain(*args)
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    errs = {
        name: check(f"{label}_{name}", max_abs(a, b),
                    tol * b.abs().max().item())["max_abs_err"]
        for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3])
    }
    if kernel == "k2b":
        errs["dpos_over_bound"] = _dpos_check(
            label, got[3], ref[3], (q, k, v, gout, pos, km, m, l), dcap)
    else:
        errs["dpos_rel"] = check(
            f"{label}_dpos_rel",
            max_abs(got[3], ref[3]) / ref[3].abs().max().item(),
            K2A_DPOS_TOL)["max_abs_err"]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    emit("kernels", check=f"{label}_bitwise_repeat", ok=bitwise)
    if not bitwise:
        raise AssertionError(f"{label}: two runs differ")
    del got, again
    # the yardstick: K2b's on bf16 operands from the op's own forward; K2a's
    # on fp32 operands with K1's (out, m, l), K2a's own inputs
    library = (_sdpa_bwd_library(q, k, v, gout, pos, km) if kernel == "k2b"
               else _sdpa_bwd_library(q, k, v, gout, pos, km, torch.float32,
                                      stats=(out, m, l), ref=ref))
    del ref
    launch = lambda: fn(*args)
    if kernel == "k2a":
        # the deleted SIMT kernel's yardstick, for PERF.md: the five
        # products as fp32 FMAs; not this kernel's bound, so on a line of
        # its own and not in the kernels line
        emit("kernels", info=f"{label}_simt_fp32_fma_bound",
             simt_fp32_fma_bound_ms=bound(
                 core_bwd_bytes(B, H, Lq, Lk, dk),
                 5 * 2 * B * H * Lq * Lk * dk, "fp32")["bound_ms"])
    return {
        "shape": [B, H, Lq, Lk, dk],
        "max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")),
        "errors": errs, "bitwise_repeat": bitwise,
        "ms": time_ms(launch), "host_us": _host_us(launch),
        "ms_back_to_back": time_ms_back_to_back(launch),
        "plain_ms": time_ms(lambda: plain(*args)),
        **library,
        **core_bwd_bound(kernel, B, H, Lq, Lk, dk),
    }


def _check_k2a_exact(g, B, H, Lq, Lk, dk) -> dict:
    """K2a against its plain version on ``k2a_exact_probe``'s inputs, where
    both compute the function exactly: every output equal bit for bit (a
    kernel that held g or ds in two bf16 terms would miss by up to 2^-17 a
    term). The random-input checks' 1e-4 of the largest cannot tell two
    terms from three: there the sound kernel reads 2e-6 to 1e-5 of each
    output's largest (fp32 summation order, the MUFU's exp and 1 / l), and
    two terms would add 4-7e-6 (tests/test_torch_k2a_split.py's float64
    emulation at its ragged shape)."""
    label = f"k2a_exact_B{B}_H{H}_Lq{Lq}_Lk{Lk}_dk{dk}"
    args = k2a_exact_probe(B, H, Lq, Lk, dk, "cuda", g)
    ref = flash_attention_backward_plain(*args)
    got = flash_attention_backward(*args)
    errs = {name: check(f"{label}_{name}", max_abs(a, b), 0.0,
                        largest=b.abs().max().item())["max_abs_err"]
            for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, ref)}
    return {"shape": [B, H, Lq, Lk, dk], "errors": errs}


# ---------------------------------------------------------------------------
# Phase 4: the serving slice
# ---------------------------------------------------------------------------


def _variable_corpus(max_d: int) -> TextCorpus:
    """The JAX bench's packed-rerank corpus (bench.py:488-516): clipped
    lognormal doc lengths, median ~55 words, MS MARCO passage-like."""
    rng = np.random.default_rng(7)
    d_lens = np.clip(
        rng.lognormal(mean=4.0, sigma=0.45, size=2048).astype(int),
        12, max_d - 2,
    )
    vocab = [f"w{i}" for i in range(500)]
    docs = [" ".join(rng.choice(vocab, size=n)) for n in d_lens]
    queries = [" ".join(rng.choice(vocab, size=n))
               for n in rng.integers(4, 12, size=256)]
    return TextCorpus([f"d{i}" for i in range(len(docs))], docs,
                      [f"q{i}" for i in range(len(queries))], queries)


def _first_stage_run(corpus: TextCorpus, seed: int) -> dict[str, list[str]]:
    rng = np.random.default_rng(seed)
    return {
        corpus.query_ids[q]: [corpus.doc_ids[i] for i in
                              rng.choice(corpus.num_docs, N_CANDIDATES,
                                         replace=False)]
        for q in range(N_QUERIES)
    }


def _serve(label, params, cfg, store, corpus, tok, **kw) -> tuple[Reranker, dict]:
    rr = Reranker(params, cfg, store, corpus, rel_id=tok.true_id,
                  nrel_id=tok.false_id, batch_size=B_SERVE, device="cuda",
                  **kw)
    run = _first_stage_run(corpus, seed=1)
    q_rows = np.asarray([corpus.query_index[q] for q, ds in run.items()
                         for _ in ds], np.int64)
    d_rows = np.asarray([corpus.doc_index[d] for ds in run.values()
                         for d in ds], np.int64)
    if rr.packed and rr.bucket_lens:
        buckets = [b for _, b in rr._bucket_plan(q_rows, d_rows)]
    else:
        buckets = [store.prompt_len] * -(-len(q_rows) // B_SERVE)
    warmed = rr.warm(q_rows, d_rows)

    # keep the scores rerank() computes, for the checks below
    captured = []
    score_pairs = rr.score_pairs
    rr.score_pairs = lambda q, d: captured.append(score_pairs(q, d)) \
        or captured[-1]

    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    ranked = rr.rerank(run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"gemm": gemm.launches,
                "attention": flash_attention_forward.launches}

    scores = captured[0]
    n_kernel_blocks = sum(b >= 64 for b in buckets)
    want = {"attention": cfg.num_layers * n_kernel_blocks,
            "gemm": 2 * cfg.num_layers * n_kernel_blocks}
    ok_counts = launches == want and n_kernel_blocks > 0
    finite = bool(np.isfinite(scores).all())
    pos = 0
    ordered = True
    for qid, docs in run.items():
        s = scores[pos:pos + len(docs)]
        pos += len(docs)
        ordered &= ranked[qid] == [docs[i]
                                   for i in np.argsort(-s, kind="stable")]
    fields = dict(
        case=label, pairs=len(q_rows), blocks=len(buckets),
        buckets=sorted(set(buckets)), warmed=warmed, seconds=seconds,
        docs_per_s=len(q_rows) / seconds, launches=launches,
        expected_launches=want, finite=finite, order_consistent=ordered,
        score_mean=float(scores.mean()), score_std=float(scores.std()),
    )
    emit("slice", **fields)
    if not (ok_counts and finite and ordered):
        raise AssertionError(f"slice {label}: {fields}")
    return rr, {**fields, "q_rows": q_rows, "d_rows": d_rows}


def phase_slice() -> dict:
    cfg = dataclasses.replace(t5.T5Config.base(), dtype=torch.bfloat16,
                              flash_v3=True)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    params = t5.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")

    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=0,
                                  doc_len=150, query_len=12)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24, max_d_tokens=160)
    L = store.prompt_len
    emit("slice", config="t5-base", vocab=cfg.vocab_size, dtype="bfloat16",
         flash_v3=True, prompt_len=L, batch=B_SERVE)
    rr, unpacked = _serve("unpacked", params, cfg, store, corpus, tok)

    # first block: the same port on the CPU with the same weights, through
    # the plain versions
    q0, d0 = unpacked["q_rows"][:B_SERVE], unpacked["d_rows"][:B_SERVE]
    gpu = rr._score_block(q0, d0, None)
    t0 = time.perf_counter()
    cpu_rr = Reranker(t5.tree_map(lambda t: t.cpu(), params), cfg, store,
                      corpus, rel_id=tok.true_id, nrel_id=tok.false_id,
                      batch_size=B_SERVE, device="cpu")
    cpu = cpu_rr._score_block(q0, d0, None)
    err = float(np.abs(gpu - cpu).max())
    same_top = int((np.argsort(-gpu)[:10] == np.argsort(-cpu)[:10]).sum())
    emit("slice", check="first_block_vs_cpu", max_abs_err=err, tol=SCORE_ATOL,
         ok=err <= SCORE_ATOL, cpu_seconds=time.perf_counter() - t0,
         top10_same_positions=same_top)
    if err > SCORE_ATOL:
        raise AssertionError(f"first block: GPU vs CPU max |diff| {err}")

    vcorpus = _variable_corpus(max_d=160)
    vstore = TokenizedStore.build(vcorpus, tok, max_q_tokens=24,
                                  max_d_tokens=160)
    _, packed = _serve("packed_bucketed", params, cfg, vstore, vcorpus, tok,
                       packed=True,
                       bucket_lens=tuple(range(32, vstore.prompt_len, 32)))
    return {"unpacked": unpacked, "packed": packed,
            "launches": {k: unpacked["launches"][k] + packed["launches"][k]
                         for k in ("gemm", "attention")}}


# ---------------------------------------------------------------------------
# Phase 5: the training slice
# ---------------------------------------------------------------------------

# cli.train preset: t5-base, bf16, flash_v3 + fused_qkv, dense attention,
# no dropout or remat; the synthetic corpus and pools of the JAX bench's
# training phase (bench.py:117-126); fp32 AdamW with clip 1.0.
TRAIN_PRESET = dict(
    curriculum="lce", model="base", vocab_size=32128, bf16=True, remat=False,
    flash_v3=True, fused_qkv=True, attention_impl="dense", dropout=False,
    batch_size=B_TRAIN, n=N_NEG_TRAIN, max_q_tokens=24, max_d_tokens=160,
    synthetic_docs=2048, synthetic_queries=256, synthetic_pairs=1024,
    synthetic_pool=100, total_steps=B_TRAIN * TRAIN_STEPS,
    warmup_steps=B_TRAIN, microbatches=1, chunk_size=1, log_mode="all",
)


# The runner's own defaults on phase 5's preset: remat on with
# remat_policy="dots_nobatch" (RunConfig's), 4 steps.
DEFAULT_STEPS = 4
DEFAULT_PRESET = dict(
    {k: v for k, v in TRAIN_PRESET.items() if k != "remat"},
    total_steps=B_TRAIN * DEFAULT_STEPS)
# Dropout with optax.MultiSteps: phase 5's preset on the dense route (JAX
# refuses dropout with flash_v3), the default remat, 2 mini-steps an
# update, 4 mini-steps: the second update moves every weight (the first
# runs at lr(0) = 0).
DROPOUT_PRESET = dict(DEFAULT_PRESET, flash_v3=False, dropout=True,
                      grad_accum_steps=2)
# A training step under each remat policy, on one batch: step 1 against
# remat off bit for bit (the recompute runs the same ops and kernels on the
# same inputs), then REMAT_STEPS - 1 steps timed and one profiled.
REMAT_POLICIES = ("full", "dots_nobatch", "dots")
REMAT_STEPS = 4


def _train_cfg(flash_v3: bool) -> t5.T5Config:
    return dataclasses.replace(t5.T5Config.base(), dtype=torch.bfloat16,
                               flash_v3=flash_v3, fused_qkv=True)


# cli.train preset of phase 6: t5-base, bf16, fused_qkv, chunked attention
# over 512-key chunks with the attention-core kernels, bf16 residual and
# accumulation carry, 8 microbatches; fp32 AdamW with clip 1.0; the
# synthetic corpus and pools of phase 5.
CHUNKED_PRESET = dict(
    TRAIN_PRESET, flash_v3=False, attention_impl="chunked",
    attention_chunk=512, flash_kernel=True, attn_residual_dtype="bf16",
    batch_size=B512, n=N512, max_d_tokens=484, microbatches=MB512,
    grad_accum_dtype="bf16", total_steps=B512 * STEPS512,
    warmup_steps=B512,
)
# the K2a path: 768 tokens in 256-key chunks, a small batch in one
# microbatch, fp32 residual and carry
K2A_PRESET = dict(
    CHUNKED_PRESET, attention_chunk=256, attn_residual_dtype="fp32",
    batch_size=B768, n=N768, max_d_tokens=740, microbatches=1,
    grad_accum_dtype="fp32", total_steps=B768 * STEPS768,
    warmup_steps=B768,
)


def _chunked_cfg(kernel: bool, chunk: int = 512,
                 residual: str = "bf16") -> t5.T5Config:
    return dataclasses.replace(
        t5.T5Config.base(), dtype=torch.bfloat16, fused_qkv=True,
        attention_impl="chunked", attention_chunk=chunk, flash_kernel=kernel,
        attn_residual_dtype=residual)


COUNTED = {
    "gemm": gemm,
    "attention": flash_attention_forward,
    "attention_bwd": attention_backward,
    "core_bwd_k2a": flash_attention_backward,
    "core_bwd_k2b": flash_attention_backward_v2,
    "mips_topk": mips_topk_pallas,
    "mips_topk_int8": mips_topk_pallas_quantized,
}


def _launches() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _zero_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def _per_step(**counts) -> dict:
    """Launches expected per optimizer step: the named ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in COUNTED}


def _train_run(smi: str, case: str, preset: dict, per_step: dict,
               once: dict | None = None, out: str | None = None) -> dict:
    """cli.train.main with ``preset``, counted: launches must be
    ``per_step`` times the steps plus ``once`` (launches outside the
    steps), losses finite and every weight moved. The run directory is
    ``out`` when given (and kept), else a temporary one."""
    with tempfile.TemporaryDirectory() as tmp:
        out = out or os.path.join(tmp, "run")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        summary = train_main(preset={**preset, "out_dir": out},
                             argv=[], device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        final = torch.load(os.path.join(out, "final", CHECKPOINT_FILE),
                           map_location="cuda", weights_only=True)["params"]
    steps = summary["steps"]
    want = {name: n * steps + (once or {}).get(name, 0)
            for name, n in per_step.items()}
    losses = [r["loss"] for r in rows if "loss" in r]
    finite = len(losses) == steps and bool(np.isfinite(losses).all())
    # the runner's initial weights: the same seed, the same draws
    init = t5.flatten_params(t5.init_params(
        t5.T5Config.base(), torch.Generator(device="cuda").manual_seed(42),
        "cuda"))
    changed = sum(not torch.equal(final[k], init[k]) for k in init)
    weights_finite = all(torch.isfinite(v).all().item()
                         for v in final.values())
    # steady steps/s: the loop's cumulative rate after step 1 and step N
    sps = [(r["step"], r["steps_per_sec"]) for r in rows
           if "steps_per_sec" in r]
    (k1, r1), (kn, rn) = sps[0], sps[-1]
    step_s = (kn / rn - k1 / r1) / (kn - k1)
    rows_per_step = preset["batch_size"] * (1 + preset["n"])
    fields = dict(
        case=case, steps=steps, seconds=seconds,
        prompt_len=preset["max_q_tokens"] + preset["max_d_tokens"] + 4,
        rows_per_step=rows_per_step, microbatches=preset["microbatches"],
        steps_per_s=1.0 / step_s,
        trained_negatives_per_s=preset["batch_size"] * preset["n"] / step_s,
        nvidia_smi=smi, launches=launches, expected_launches=want,
        losses=losses, losses_finite=finite, leaves_changed=changed,
        leaves=len(init), weights_finite=weights_finite,
        refresh_seconds=[r["refresh_seconds"] for r in rows
                         if "refresh_seconds" in r],
    )
    emit("train", **fields)
    if not (launches == want and finite and changed == len(init)
            and weights_finite):
        raise AssertionError(f"train {case}: {fields}")
    return fields


def _step_env(cfg: t5.T5Config, max_d: int, pairs: int, n_neg: int,
              loss: str = "lce"):
    """(tokenizer, DeviceCorpus, t5-base weights from seed 0 in ``cfg``'s
    dtype, controller, one batch of ``pairs`` x (1 + ``n_neg``) rows) on
    the card: phase 5's synthetic corpus and pools at prompt budget
    ``max_d``; with ``loss="pair"``, the pair batch at difficulty 0.5 and
    an eta controller (one negative an example)."""
    tok = HashTokenizer(vocab_size=32128)
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=max_d)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100, seed=42)
    dc = DeviceCorpus.build(store, triples, device="cuda")
    params = t5.init_params(cfg,
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False,
                         ce_scale=(1 + n_neg) * float(np.log(32128)))
    if loss == "pair":
        ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                             total_steps=8, kind="eta",
                             objective="self_paced", ce_scale=PACED_CE_SCALE)
        batch = dc.pair_batch(torch.arange(pairs, device="cuda"),
                              torch.tensor(0.5, device="cuda"))
        return tok, dc, params, ctrl, batch
    batch = dc.lce_batch(torch.Generator(device="cuda").manual_seed(1),
                         torch.arange(pairs, device="cuda"),
                         torch.tensor(0.5, device="cuda"), n_neg)
    return tok, dc, params, ctrl, batch


def _make_step(cfg: t5.T5Config, tok, ctrl, tx, n_neg: int,
               loss: str = "lce", **step_kw):
    return make_train_step(cfg, ctrl, tx, loss=loss, n_neg_per_example=n_neg,
                           use_mean=False, rel_id=tok.true_id,
                           nrel_id=tok.false_id, **step_kw)


def _step_ab(case: str, cfg_on: t5.T5Config, cfg_off: t5.T5Config,
             max_d: int, want_on: dict, tols: tuple, pairs: int = B_TRAIN,
             n_neg: int = N_NEG_TRAIN, loss: str = "lce",
             **step_kw) -> dict:
    """Step 1 with the kernels (``cfg_on``) against the plain route
    (``cfg_off``) on the same weights and batch (``pairs`` x (1 + ``n_neg``)
    rows). The first update runs at lr(0) = 0, so the AdamW first moment
    after it is 0.1 x the clipped gradient: compared leaf by leaf as
    ||on - off|| / ||off||. The plain route must launch no kernel."""
    loss_tol, grad_tol, grad_median_tol = tols
    tok, _, params, ctrl, batch = _step_env(cfg_on, max_d, pairs, n_neg,
                                            loss)
    runs = {}
    for on, cfg in ((True, cfg_on), (False, cfg_off)):
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = _make_step(cfg, tok, ctrl, tx, n_neg, loss, **step_kw)
        before = _launches()
        state, metrics = step(init_train_state(params, tx,
                                               ctrl.init("cuda")), batch)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in _launches().items()}
        runs[on] = (metrics["loss"].item(), t5.flatten_params(
            state.opt_state.mu), used)
        del state
    (loss_on, mu_on, used_on), (loss_off, mu_off, used_off) = (runs[True],
                                                               runs[False])
    rel = {k: ((mu_on[k] - mu_off[k]).norm() / mu_off[k].norm()).item()
           for k in mu_off if mu_off[k].norm() > 0}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_on - loss_off) / abs(loss_off)
    fields = dict(
        case=case, loss_kernels=loss_on, loss_plain=loss_off,
        loss_rel_err=loss_rel, loss_tol=loss_tol,
        grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
        grad_rel_l2_median=statistics.median(rel.values()),
        grad_tol=grad_tol, grad_median_tol=grad_median_tol,
        leaves=len(rel), launches_kernels=used_on, launches_plain=used_off,
        expected_launches_kernels=want_on,
    )
    emit("train", **fields)
    if not (used_on == want_on and used_off == _per_step()
            and loss_rel <= loss_tol and rel[worst] <= grad_tol
            and fields["grad_rel_l2_median"] <= grad_median_tol):
        raise AssertionError(f"step 1 {case}: {fields}")
    return fields


def _fwd_bwd_memory(cfg: t5.T5Config, params: dict, batch: dict) -> dict:
    """Memory of one forward + backward over ``batch``'s rows (the step's
    weights in the compute dtype, q|k|v fused), over what was allocated
    before it: what the forward leaves allocated (the activations the
    policy keeps) and the peak (the recompute's included), without the
    optimizer's temporaries. Earlier steps' autograd graphs can linger in
    reference cycles (checkpoint frames) until the cyclic collector runs;
    collected first, so that none is freed inside the measured window."""
    params = t5.tree_map(
        lambda t: (t.to(cfg.dtype) if t.dim() >= 2 and t.shape[-1] >= 128
                   else t).detach().requires_grad_(True),
        t5.fuse_attention_params(params))
    rows = [torch.cat([batch[f"pos_{k}"], batch[f"neg_{k}"]])
            for k in ("ids", "mask", "labels")]
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = t5.forward_logits(params, cfg, rows[0], rows[2], rows[1])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    logits.square().mean().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del params, logits
    return {"held_after_forward_mib": held / 2**20,
            "fwd_bwd_peak_mib": peak / 2**20}


def _profiled_step(step, state, batch):
    """One step under ``torch.profiler``: the CUDA kernels' summed device
    time (one stream, so they do not overlap) and the ``aten::`` ops the
    profiler records (nested calls included)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    return state, busy, aten


def _remat_ab(smi: str, case: str, cfg: t5.T5Config, max_d: int, pairs: int,
              n_neg: int, policies: tuple, per_step: dict,
              per_step_remat: dict, fwd_bwd: bool = True, loss: str = "lce",
              **step_kw) -> dict:
    """``cfg``'s step on one batch of ``pairs`` x (1 + ``n_neg``) rows under
    remat off and each of ``policies`` from the same weights: step 1's loss
    and AdamW first moment must equal remat off's bit for bit; then the
    steps' median ms (host clock, synchronised), the peak of
    ``torch.cuda.max_memory_allocated`` over them, one profiled step
    (device-busy ms, ``aten`` ops) and, with ``fwd_bwd``, the memory of a
    forward + backward alone (``_fwd_bwd_memory``)."""
    tok, _, params, ctrl, batch = _step_env(cfg, max_d, pairs, n_neg, loss)
    runs, ref = {}, None
    for policy in ("off",) + policies:
        off = policy == "off"
        c = dataclasses.replace(cfg, remat=not off,
                                remat_policy="full" if off else policy)
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = _make_step(c, tok, ctrl, tx, n_neg, loss, **step_kw)
        state = init_train_state(params, tx, ctrl.init("cuda"))
        gc.collect()  # the last policy's graphs (see _fwd_bwd_memory)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = _launches()
        times = []
        for i in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first = (metrics["loss"].clone(),
                         t5.flatten_params(t5.tree_map(
                             torch.clone, state.opt_state.mu)))
        peak = torch.cuda.max_memory_allocated()
        state, busy, aten = _profiled_step(step, state, batch)
        used = {k: v - before[k] for k, v in _launches().items()}
        want = {k: n * (REMAT_STEPS + 1) for k, n in
                (per_step if off else per_step_remat).items()}
        del state
        memory = _fwd_bwd_memory(c, params, batch) if fwd_bwd else {}
        if ref is None:
            ref = first
        differ = sorted(k for k in ref[1]
                        if not torch.equal(first[1][k], ref[1][k]))
        step_ms = statistics.median(times[1:])
        runs[policy] = dict(
            step_ms=step_ms, step_ms_all=times, busy_ms=busy,
            idle_share=1.0 - busy / step_ms, aten_ops_per_step=aten,
            peak_mib=peak / 2**20, resident_mib=resident / 2**20, **memory,
            step1_loss_equal_to_off=torch.equal(first[0], ref[0]),
            step1_mu_leaves_differing_from_off=differ,
            loss=first[0].item(), launches=used, expected_launches=want)
        emit("train", case=f"{case}_remat_{policy}", nvidia_smi=smi,
             **runs[policy])
        del first
        if (differ or not runs[policy]["step1_loss_equal_to_off"]
                or used != want):
            raise AssertionError(f"{case} remat {policy}: {runs[policy]}")
    return runs


def phase_train(smi: str, run_dir: str) -> dict:
    emit("train", config="t5-base", vocab=32128, dtype="bfloat16",
         flash_v3=True, fused_qkv=True, batch=B_TRAIN, n=N_NEG_TRAIN,
         rows=ROWS_TRAIN, prompt_len=L_SERVE, steps=TRAIN_STEPS)
    layers = _train_cfg(True).num_layers
    # per step: K3 forward and K4 backward once per encoder layer; GEMMs:
    # the forward's two projections and the backward's qkv recompute
    per_step = _per_step(attention=layers, attention_bwd=layers,
                         gemm=3 * layers)
    # the run directory stays for phase 8's evaluation
    run = _train_run(smi, "cli.train.main", TRAIN_PRESET, per_step,
                     out=run_dir)
    step1 = _step_ab("step1_flash_v3_vs_dense", _train_cfg(True),
                     _train_cfg(False), 160, per_step,
                     (STEP_LOSS_RTOL, STEP_GRAD_REL_L2,
                      STEP_GRAD_REL_L2_MEDIAN))
    # under remat the backward recomputes each block, K3 (GEMM, core,
    # GEMM) included: the kernels are ctypes calls that no policy can
    # save, as JAX saves no pallas_call output. A step: K3's core twice
    # and K4 once per encoder layer; GEMMs 2 + 2 + 1 per layer.
    per_step_remat = _per_step(attention=2 * layers, attention_bwd=layers,
                               gemm=5 * layers)
    default = _train_run(smi, "default_runconfig_dots_nobatch",
                         DEFAULT_PRESET, per_step_remat)
    remat = _remat_ab(smi, "L188", _train_cfg(True), 160, B_TRAIN,
                      N_NEG_TRAIN, REMAT_POLICIES, per_step, per_step_remat)
    # dense attention: no kernel runs
    dropout = _train_run(smi, "dropout_multisteps", DROPOUT_PRESET,
                         _per_step())
    return {"run": run, "step1": step1, "default": default, "remat": remat,
            "dropout": dropout}


def phase_chunked(smi: str) -> dict:
    emit("chunked", config="t5-base", vocab=32128, dtype="bfloat16",
         attention_impl="chunked", attention_chunk=512, flash_kernel=True,
         fused_qkv=True, attn_residual_dtype="bf16", grad_accum_dtype="bf16",
         batch=B512, n=N512, rows=B512 * (1 + N512), microbatches=MB512,
         prompt_len=512, steps=STEPS512)
    layers = _chunked_cfg(True).num_layers
    # per step: K1 forward and K2b backward once per encoder layer per
    # microbatch; the decoder's attention (Lq = label length) is not
    # 128-aligned and takes the plain route
    per_step = _per_step(attention=layers * MB512,
                         core_bwd_k2b=layers * MB512)
    run = _train_run(smi, "chunked_512", CHUNKED_PRESET, per_step)
    step1 = _step_ab("step1_chunked_kernels_vs_plain", _chunked_cfg(True),
                     _chunked_cfg(False), 484, per_step,
                     (STEP512_LOSS_RTOL, STEP512_GRAD_REL_L2,
                      STEP512_GRAD_REL_L2_MEDIAN),
                     microbatches=MB512, grad_accum_dtype="bf16")
    # the same step under RunConfig's default remat: K1 again in each
    # block's recompute (a ctypes call no policy can save), K2b once
    remat = _remat_ab(smi, "chunked512", _chunked_cfg(True), 484, B512,
                      N512, ("dots_nobatch",), per_step,
                      _per_step(attention=2 * layers * MB512,
                                core_bwd_k2b=layers * MB512),
                      fwd_bwd=False, microbatches=MB512,
                      grad_accum_dtype="bf16")
    # L 768: K2a (the resident estimate fails the 48 MiB gate), one
    # microbatch: K1 and K2a once per encoder layer a step, K2b never
    per_step768 = _per_step(attention=layers, core_bwd_k2a=layers)
    k2a = _train_run(smi, "chunked_768_k2a", K2A_PRESET, per_step768)
    step768 = _step_ab(
        "step1_chunked_768_k2a_vs_plain",
        _chunked_cfg(True, K2A_PRESET["attention_chunk"], "fp32"),
        _chunked_cfg(False, K2A_PRESET["attention_chunk"], "fp32"),
        K2A_PRESET["max_d_tokens"], per_step768,
        (STEP768_LOSS_RTOL, STEP768_GRAD_REL_L2, STEP768_GRAD_REL_L2_MEDIAN),
        pairs=B768, n_neg=N768, microbatches=1, grad_accum_dtype="fp32")
    return {"run": run, "step1": step1, "remat": remat, "k2a_run": k2a,
            "step768": step768}


def _fused512_cfg(flash_v3: bool) -> t5.T5Config:
    return dataclasses.replace(_chunked_cfg(False), flash_v3=flash_v3)


def phase_fused512(smi: str) -> dict:
    """The JAX bench's fused512 (bench.py:1203-1223, bench_fused
    :137-165): flash_v3 + fused_qkv at L 512 over chunked attention (512-key
    chunks, no attention-core kernel), bf16 residual and carry, 8
    microbatches, factored moments, no remat; driven through
    make_train_step / make_fused_step (RunConfig has no ``moments``). Then
    step 1 against the plain chunked route with fp32 AdamW."""
    cfg = _fused512_cfg(True)
    layers = cfg.num_layers
    # per step: K3 and K4 once per encoder layer per microbatch; GEMMs
    # 3 per call pair; the decoder's attention takes the plain route
    per_step = _per_step(attention=layers * MB512, attention_bwd=layers
                         * MB512, gemm=3 * layers * MB512)
    emit("fused512", config="t5-base", flash_v3=True, fused_qkv=True,
         attention_impl="chunked", attention_chunk=512, flash_kernel=False,
         attn_residual_dtype="bf16", grad_accum_dtype="bf16",
         moments="factored", remat=False, batch=B512, n=N512,
         rows=B512 * (1 + N512), microbatches=MB512, prompt_len=512,
         steps=STEPS512)
    tok, dc, params, ctrl, _ = _step_env(cfg, 484, B512, N512)
    tx = make_optimizer(1e-3, total_steps=STEPS512, warmup_steps=1,
                        moments="factored")
    step = _make_step(cfg, tok, ctrl, tx, N512, microbatches=MB512,
                      grad_accum_dtype="bf16")
    fused = make_fused_step(dc, step, ctrl, loss="lce", n_neg_per_example=N512)
    state = init_train_state(params, tx, ctrl.init("cuda"))
    pairs = pair_index_stream(1024, B512, seed=42, shuffle=False)
    torch.cuda.synchronize()
    _zero_launches()
    losses, times = [], []
    for _ in range(STEPS512):
        idx = torch.from_numpy(next(pairs)).cuda()
        t0 = time.perf_counter()
        state, metrics = fused(state, idx)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = _launches()
    want = {k: n * STEPS512 for k, n in per_step.items()}
    init, final = t5.flatten_params(params), t5.flatten_params(state.params)
    changed = sum(not torch.equal(final[k], init[k]) for k in init)
    finite = bool(np.isfinite(losses).all()) and all(
        torch.isfinite(v).all().item() for v in final.values())
    step_s = statistics.median(times[1:])
    fields = dict(case="fused512", steps=STEPS512, losses=losses,
                  step_s=times, steps_per_s=1.0 / step_s,
                  trained_negatives_per_s=B512 * N512 / step_s,
                  launches=launches, expected_launches=want,
                  leaves_changed=changed, leaves=len(init), finite=finite,
                  nvidia_smi=smi)
    emit("fused512", **fields)
    if not (launches == want and finite and changed == len(init)):
        raise AssertionError(f"fused512: {fields}")
    del state, fused, step
    step1 = _step_ab("step1_fused512_vs_plain_chunked", cfg,
                     _fused512_cfg(False), 484, per_step,
                     (STEP512_LOSS_RTOL, STEP512_GRAD_REL_L2,
                      STEP512_GRAD_REL_L2_MEDIAN),
                     pairs=B512, n_neg=N512, microbatches=MB512,
                     grad_accum_dtype="bf16")
    return {"run": fields, "step1": step1}


# ---------------------------------------------------------------------------
# Phase 7: dense retrieval and online mining
# ---------------------------------------------------------------------------


def _unit_rows(g, n: int, D: int) -> torch.Tensor:
    x = torch.randn((n, D), generator=g, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _mips_index(g, N: int, D: int, kind: str, slab: int = 262_144):
    """Random unit embeddings from a seed, built on the card a slab at a
    time: (docs,) in fp32 / bf16, or (int8 values, scales) quantised slab
    by slab (no fp32 copy of the index)."""
    if kind == "int8":
        vals = torch.empty((N, D), dtype=torch.int8, device="cuda")
        scales = torch.empty((N,), dtype=torch.float32, device="cuda")
        for s0 in range(0, N, slab):
            s1 = min(s0 + slab, N)
            vals[s0:s1], scales[s0:s1] = quantize_embeddings(
                _unit_rows(g, s1 - s0, D))
        return vals, scales
    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    docs = torch.empty((N, D), dtype=dt, device="cuda")
    for s0 in range(0, N, slab):
        s1 = min(s0 + slab, N)
        docs[s0:s1] = _unit_rows(g, s1 - s0, D).to(dt)
    return (docs,)


def _topk_agreement(q, index, got, ref, tol) -> dict:
    """Values within ``tol`` everywhere; where the indices differ, the
    kernel's doc scores (the plain arithmetic) within ``tol`` of the plain
    version's value at that rank: a near-tie swap."""
    (v, i), (rv, ri) = got, ref
    rows, cols = (i != ri).nonzero(as_tuple=True)
    swap_err = 0.0
    if len(rows):
        s = block_scores(q, *(t[i[rows, cols]] for t in index))
        s = s[rows, torch.arange(len(rows), device=s.device)]
        swap_err = (s - rv[rows, cols]).abs().max().item()
    return {"max_abs_err": max_abs(v, rv), "near_tie_swaps": len(rows),
            "swap_err": swap_err}


def _mips_library_ms(q, index, k: int) -> dict:
    """The yardstick, never called by the port: one torch.mm, then
    torch.topk (int8: on a bf16 copy of the values, exact, built outside
    the timing, and scaled after the product); timed per call and back to
    back."""
    if len(index) == 2:
        vals, scales = index
        docs = torch.empty(vals.shape, dtype=torch.bfloat16, device="cuda")
        for s0 in range(0, vals.shape[0], 1 << 20):
            docs[s0:s0 + (1 << 20)] = vals[s0:s0 + (1 << 20)]
        q_b = q.to(torch.bfloat16)
        fn = lambda: torch.topk(torch.mm(q_b, docs.t()).float() * scales, k)
    else:
        q_l = q.to(index[0].dtype)
        fn = lambda: torch.topk(torch.mm(q_l, index[0].t()), k)
    return {"library_ms": time_ms(fn, warmup=1, reps=5),
            "library_ms_back_to_back": time_ms_back_to_back(fn, calls=5,
                                                            warmup=1)}


def _check_mips(g, case: str, kind: str, shape: tuple, exact: bool = False,
                library: bool = True) -> dict:
    """One K5 / K6 case: the kernel against its plain version (or, with
    ``exact``, against a full fp32 product and a stable-sort top-k), two
    runs bitwise equal, and kernel / plain / library times beside the
    bound."""
    B, N, D, k, block_n, kpb = shape
    index = _mips_index(g, N, D, kind)
    q = _unit_rows(g, B, D)
    fn, plain = ((mips_topk_pallas_quantized, mips_topk_pallas_quantized_plain)
                 if kind == "int8" else (mips_topk_pallas, mips_topk_pallas_plain))
    run = lambda: fn(q, *index, k, block_n=block_n, k_per_block=kpb)
    got, again = run(), run()
    if exact:
        ref_fn = lambda: mips_topk_exact(q, index[0], k)
    else:
        ref_fn = lambda: plain(q, *index, k, block_n=block_n,
                               k_per_block=kpb)
    ref = ref_fn()
    torch.cuda.synchronize()
    tol = mips_tol(D)
    agree = _topk_agreement(q, index, got, ref, tol)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    emit("dense", check=f"{case}_bitwise_repeat", ok=bitwise)
    if not bitwise:
        raise AssertionError(f"{case}: two runs differ")
    check(f"{case}_near_tie_swap_err", agree["swap_err"], tol,
          near_tie_swaps=agree["near_tie_swaps"])
    esize = index[0].element_size()
    nbytes = (N * D * esize + (N * 4 if kind == "int8" else 0) + B * D * 4
              + B * k * (4 + 8))
    # the wrapper's two parts apart: the kernel's launch alone (operand
    # checks and allocations included), and the merge of its candidates
    operands = index if kind == "int8" else (index[0], None)
    launch = lambda: mips._kernel_candidates(q, *operands, k, block_n, kpb,
                                             fn.__name__)
    cands = launch()
    kernel_ms = time_ms(launch, warmup=2, reps=10)
    merge_ms = time_ms(lambda: mips._merge_keys(cands, k), warmup=2, reps=10)
    split = {}
    if kind != "int8" and kpb is None and k <= block_n:
        # k' = k: the wrapper selects over long runs of rows; the same
        # function with the blocks as the segments, timed beside it
        per_block = lambda: mips._kernel_candidates(
            q, *operands, k, block_n, kpb, fn.__name__, fold=False)
        cands = per_block()
        split = dict(
            per_block_kernel_ms=time_ms(per_block, warmup=2, reps=10),
            per_block_merge_ms=time_ms(lambda: mips._merge_keys(cands, k),
                                       warmup=2, reps=10))
    del cands
    fields = dict(
        shape=[B, N, D, k, block_n, kpb], doc_type=kind,
        near_tie_swaps=agree["near_tie_swaps"], bitwise_repeat=bitwise,
        kernel_ms=kernel_ms, merge_ms=merge_ms, **split,
        ms=time_ms(run, warmup=2, reps=10),
        ms_back_to_back=time_ms_back_to_back(run, calls=5, warmup=1),
        plain_ms=time_ms(ref_fn, warmup=1, reps=3),
        **(_mips_library_ms(q, index, k) if library
           else {"library_ms": None}),
        **bound(nbytes, 2 * B * N * D, "fp32" if kind == "fp32" else "bf16"),
    )
    out = check(case, agree["max_abs_err"], tol, **fields)
    del index, got, again, ref
    torch.cuda.empty_cache()
    return out


def _online_preset() -> dict:
    return dict(TRAIN_PRESET, mining="online", quantize_index=True,
                synthetic_docs=K6_ONLINE[1], pool_size=K6_ONLINE[3] - 1,
                encode_batch=128, refresh_every=2,
                total_steps=B_TRAIN * ONLINE_STEPS)


def _write_tsv(path: str, ids, texts) -> None:
    with open(path, "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(ids, texts))


def _build_pools(run_dir: str, tmp: str, corpus: TextCorpus, topk: str,
                 cutoff: int) -> tuple[list[dict], dict, float]:
    docs, queries = os.path.join(tmp, "docs.tsv"), os.path.join(tmp,
                                                                "queries.tsv")
    _write_tsv(docs, corpus.doc_ids, corpus.doc_texts)
    _write_tsv(queries, corpus.query_ids, corpus.query_texts)
    out = os.path.join(tmp, f"pools_{topk}.jsonl")
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    build_pools_main(["--method", "dense", "--topk", topk, "--cutoff",
                      str(cutoff), "--run", run_dir, "--docs", docs,
                      "--queries", queries, "--out", out, "--device",
                      "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    with open(out) as f:
        return [json.loads(line) for line in f], launches, seconds


def phase_dense(smi: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(7)
    emit("dense", config="t5-base", dim=768)
    # 7a: the kernels at the dense paths' shapes
    kern = {
        "k6_msmarco": _check_mips(g, "mips_topk_int8_msmarco", "int8",
                                  K6_SCALE),
        "k6_online": _check_mips(g, "mips_topk_int8_online", "int8",
                                 K6_ONLINE),
        "k5_pools": _check_mips(g, "mips_topk_fp32_pools", "fp32", K5_POOLS),
        "k5_bf16": _check_mips(g, "mips_topk_bf16", "bf16", K5_BF16),
        "k5_exact": _check_mips(g, "mips_topk_fp32_exact", "fp32", K5_EXACT,
                                exact=True, library=False),
    }

    # 7b: online mining through cli.train.main
    layers = _train_cfg(True).num_layers
    # a step: the phase 5 step (K3 forward and K4 backward once per encoder
    # layer; GEMMs 3 per layer) plus K6 once; the query embedding (L 24)
    # is below the fused block's 64-token gate and launches nothing. Each
    # refresh (the first encode and one at step 2 of 4) encodes 16,384 docs
    # of L 160 in 128 batches of 128: one K3 per layer per batch, 12 x 128
    # = 1,536 attention and 3,072 GEMM launches.
    per_step = _per_step(attention=layers, attention_bwd=layers,
                         gemm=3 * layers, mips_topk_int8=1)
    batches = -(-K6_ONLINE[1] // 128)
    refreshes = 2
    once = {"attention": refreshes * layers * batches,
            "gemm": refreshes * 2 * layers * batches}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "online_run")
        run = _train_run(smi, "online_int8", _online_preset(), per_step,
                         once=once, out=run_dir)
        if len(run["refresh_seconds"]) != refreshes:
            raise AssertionError(f"online: refreshes {run['refresh_seconds']}")

        # 7c: build_pools --method dense on that run: 2,048 docs, 256
        # queries in batches of 64 -> K5 4 times (fp32 index, block 1024,
        # k' = k = 1000); the encode of the docs (L 160, batches of 256)
        # runs K3 12 x 8 times, the queries' (L 24) nothing
        corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=0)
        pools, launches, seconds = _build_pools(run_dir, tmp, corpus,
                                                "pallas", 1000)
        want = _per_step(mips_topk=4, attention=layers * 8,
                         gemm=2 * layers * 8)
        lengths = {len(p["doc_id_b"]) for p in pools}
        fields = dict(case="build_pools_pallas", seconds=seconds,
                      launches=launches, expected_launches=want,
                      pools=len(pools), pool_lengths=sorted(lengths))
        emit("dense", **fields)
        if launches != want or len(pools) != 256 or lengths != {1000}:
            raise AssertionError(f"build_pools: {fields}")
        # --topk exact: the same pools up to near-tie swaps, checked on the
        # run's own fp32 embeddings
        exact, _, _ = _build_pools(run_dir, tmp, corpus, "exact", 1000)
        params, mcfg, tok, rc = load_run(run_dir)
        store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                     max_d_tokens=rc.max_d_tokens)
        enc = lambda a, m: encode_corpus(
            params, mcfg, torch.from_numpy(a).cuda(),
            torch.from_numpy(m).cuda(), batch_size=256)
        q_emb, d_emb = enc(store.q_tokens, store.q_mask), enc(store.d_tokens,
                                                              store.d_mask)
        row = {d: r for r, d in enumerate(corpus.doc_ids)}
        qi, a, b = [], [], []
        for n, (p, e) in enumerate(zip(pools, exact)):
            for x, y in zip(p["doc_id_b"], e["doc_id_b"]):
                if x != y:
                    qi.append(n)
                    a.append(row[x])
                    b.append(row[y])
        swap_err = 0.0
        if qi:
            sa = (q_emb[qi] * d_emb[a]).sum(dim=1)
            sb = (q_emb[qi] * d_emb[b]).sum(dim=1)
            swap_err = (sa - sb).abs().max().item()
        # how close the scores lie: the spread of each query's top 1000
        # (the random-weight encoder maps the synthetic docs to nearly one
        # direction, so most of a pool sits within a few fp32 ulps)
        top = torch.topk(q_emb @ d_emb.t(), 1000).values
        spread = (top[:, 0] - top[:, -1]).median().item()
        check("build_pools_pallas_vs_exact_swap_err", swap_err,
              mips_tol(768), near_tie_swaps=len(qi),
              pool_slots=256 * 1000, median_top1000_score_spread=spread,
              same_query_order=[p["query_id"] for p in pools]
              == [e["query_id"] for e in exact])
    return {"kernels": kern, "online": run,
            "build_pools": {**fields, "near_tie_swaps_vs_exact": len(qi),
                            "median_top1000_score_spread": spread}}


# ---------------------------------------------------------------------------
# Phase 8: evaluation through cli.evaluate
# ---------------------------------------------------------------------------

# BM25 top 1000 per judged query, the top 100 reranked in the CLI's blocks
# of 64: 256 queries x 100 = 25,600 pairs, 400 blocks
EVAL_DEPTH, EVAL_BM25_K, EVAL_BATCH = 100, 1000, 64
EVAL_CHECK_QUERIES = 2  # the card against the CPU on their 200 pairs
# int8 scores, the card against the CPU: the int32 products are exact on
# both; the fp32 scale / norm order and the bf16 operands of the attention
# products round differently, and an operand an ulp apart can flip int8
# codes downstream. On the CPU, the JAX package against the port differs
# by up to 3.7e-3 at T5Config.tiny from such flips (tests/test_torch_
# quant.py); 2e-2 leaves room for t5-base's 12 + 12 layers.
INT8_SCORE_ATOL = 2e-2


@contextlib.contextmanager
def _timed_eval(timers: dict, scores: list):
    """Time the CLI's BM25 build and search and its rerank, and keep the
    scores its Reranker computes."""
    ix_cls = bm25.LexicalIndex
    saved = {(ix_cls, "build"): ix_cls.__dict__["build"],
             (ix_cls, "search"): ix_cls.__dict__["search"],
             (Reranker, "rerank"): Reranker.__dict__["rerank"],
             (Reranker, "score_pairs"): Reranker.__dict__["score_pairs"]}

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            timers[key] += time.perf_counter() - t0
            return out
        return call

    def keep(self, q_rows, d_rows):
        out = saved[(Reranker, "score_pairs")](self, q_rows, d_rows)
        scores.append(out)
        return out

    ix_cls.build = classmethod(timed(saved[(ix_cls, "build")].__func__,
                                     "bm25_build_s"))
    ix_cls.search = timed(saved[(ix_cls, "search")], "bm25_search_s")
    Reranker.rerank = timed(saved[(Reranker, "rerank")], "rerank_s")
    Reranker.score_pairs = keep
    try:
        yield
    finally:
        for (cls, name), attr in saved.items():
            setattr(cls, name, attr)


def _read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _evaluate(smi: str, label: str, argv: list[str], out: str,
              judged: set, want: dict) -> dict:
    """cli.evaluate.main on the card, counted and timed: launches must be
    ``want``, scores finite, every judged query in the per-query file."""
    timers = {"bm25_build_s": 0.0, "bm25_search_s": 0.0, "rerank_s": 0.0}
    scores: list = []
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    with _timed_eval(timers, scores):
        rows = evaluate_main(argv + ["--out", out, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    s = np.concatenate(scores)
    per = _read_csv(os.path.join(out, "perqueryresults.csv"))
    covered = {(r["name"], r["measure"]): set() for r in per}
    for r in per:
        covered[(r["name"], r["measure"])].add(r["qid"])
    results = _read_csv(os.path.join(out, "results.csv"))
    ok_rows = [r["name"] for r in results] == ["bm25", "run"] \
        and len(covered) == 6 and all(q == judged for q in covered.values())
    fields = dict(
        case=label, pairs=len(s), blocks=-(-len(s) // EVAL_BATCH),
        seconds=seconds, **timers, rerank_docs_per_s=len(s) / timers[
            "rerank_s"], native_bm25=bm25._lib() is not None,
        launches=launches, expected_launches=want,
        finite=bool(np.isfinite(s).all()), every_judged_query=ok_rows,
        metrics={r["name"]: {k: float(v) for k, v in r.items()
                             if k != "name" and v != ""}
                 for r in results}, nvidia_smi=smi)
    emit("evaluate", **fields)
    if not (launches == want and fields["finite"] and ok_rows):
        raise AssertionError(f"evaluate {label}: {fields}")
    return {**fields, "rows": rows}


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def phase_evaluate(smi: str, run_dir: str) -> dict:
    """BM25 first stage -> monoT5 rerank on the card -> paired metrics,
    through ``cli.evaluate.main`` on phase 5's run (t5-base, bf16,
    flash_v3 + fused_qkv, L 188): bf16 (K3 12 times a block of 64) and
    ``--int8`` (``torch._int_mm``, no hand kernel)."""
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=0,
                                  doc_len=150, query_len=12)
    layers = t5.T5Config.base().num_layers
    emit("evaluate", config="t5-base", run="phase 5's cli.train run",
         docs=corpus.num_docs, queries=corpus.num_queries, depth=EVAL_DEPTH,
         bm25_k=EVAL_BM25_K, batch=EVAL_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.tsv")
                 for k in ("docs", "queries", "qrels")}
        _write_tsv(paths["docs"], corpus.doc_ids, corpus.doc_texts)
        _write_tsv(paths["queries"], corpus.query_ids, corpus.query_texts)
        # the planted topics: doc d is relevant to query d % 256
        with open(paths["qrels"], "w") as f:
            f.writelines(f"q{d % 256}\td{d}\t1\n"
                         for d in range(corpus.num_docs))
        judged = set(corpus.query_ids)
        argv = ["--docs", paths["docs"], "--queries", paths["queries"],
                "--qrels", paths["qrels"], "--depth", str(EVAL_DEPTH),
                "--bm25_k", str(EVAL_BM25_K), "--save_runs", "true",
                "--perquery", "true", "--model", run_dir]
        blocks = -(-len(judged) * EVAL_DEPTH // EVAL_BATCH)
        bf16 = _evaluate(smi, "bf16", argv, os.path.join(tmp, "bf16"),
                         judged, _per_step(attention=layers * blocks,
                                           gemm=2 * layers * blocks))
        int8 = _evaluate(smi, "int8", argv + ["--int8", "true"],
                         os.path.join(tmp, "int8"), judged, _per_step())

        # the bm25 row: host code, so the CPU's must be the same
        t0 = time.perf_counter()
        cpu_rows = evaluate_main(argv[:-2] + ["--out",
                                              os.path.join(tmp, "cpu"),
                                              "--device", "cpu"])
        bm25_same = cpu_rows == bf16["rows"][:1] == int8["rows"][:1]
        emit("evaluate", check="bm25_row_vs_cpu", equal=bm25_same,
             cpu_seconds=time.perf_counter() - t0)
        if not bm25_same:
            raise AssertionError(f"bm25 row: {cpu_rows} vs {bf16['rows']}")

        # the first judged queries' pairs: the card against the CPU
        first, _ = read_trec_run(os.path.join(tmp, "bf16", "bm25.run"))
        qids = [q for q in corpus.query_ids if q in first][
            :EVAL_CHECK_QUERIES]
        q_rows = np.asarray([corpus.query_index[q] for q in qids
                             for _ in range(EVAL_DEPTH)], np.int64)
        d_rows = np.asarray([corpus.doc_index[d] for q in qids
                             for d in first[q][:EVAL_DEPTH]], np.int64)
    checks, card = {}, {}
    for label, int8_on, tol in (("bf16", False, SCORE_ATOL),
                                ("int8", True, INT8_SCORE_ATOL)):
        got = {}
        t0 = time.perf_counter()
        for dev in ("cuda", "cpu"):
            params, mcfg, tok, rc = load_run(run_dir, device=dev)
            store = TokenizedStore.build(corpus, tok,
                                         max_q_tokens=rc.max_q_tokens,
                                         max_d_tokens=rc.max_d_tokens)
            rr = Reranker(params, mcfg, store, corpus, rel_id=tok.true_id,
                          nrel_id=tok.false_id, batch_size=len(q_rows) // 2,
                          int8=int8_on, device=dev)
            got[dev] = rr.score_pairs(q_rows, d_rows)
            del params, rr
        card[label] = got["cuda"]
        err = float(np.abs(got["cuda"] - got["cpu"]).max())
        checks[label] = check(f"evaluate_{label}_scores_vs_cpu", err, tol,
                              pairs=len(q_rows),
                              seconds=time.perf_counter() - t0)
    top10 = [len(set(np.argsort(-card["bf16"][i:i + EVAL_DEPTH])[:10])
                 & set(np.argsort(-card["int8"][i:i + EVAL_DEPTH])[:10]))
             for i in range(0, len(q_rows), EVAL_DEPTH)]
    # as information: how far int8 moves the ranking, beside how far
    # apart the bf16 scores lie
    fidelity = dict(spearman=_spearman(card["bf16"], card["int8"]),
                    top10_overlap=top10,
                    max_abs_diff=float(np.abs(card["int8"]
                                              - card["bf16"]).max()),
                    bf16_score_std=float(card["bf16"].std()))
    emit("evaluate", check="int8_vs_bf16_on_card", **fidelity)
    return {"bf16": bf16, "int8": int8, "checks": checks,
            "int8_vs_bf16": fidelity}


# ---------------------------------------------------------------------------
# Phase 9: the pacing curricula
# ---------------------------------------------------------------------------

CURRICULUM_STEPS = 6
# phase 5's pools of 100: a level / contrast bump is 1 / (100 - 1)
POOL_SLOTS = 99
# eta and contrast: at random init a label token's CE is ~1.0-1.2 log V (a
# CPU forward of this config: 0.89-1.21 log V), above any eta in (0, 1) at
# the runner's auto ce_scale of log V, where eta's weights are all 0 and
# eta never moves. 4 log V puts the scaled CE near 0.25-0.3, below eta0
# 0.5: the weights are non-zero, eta moves, and contrast's ce < eta rate
# clears its threshold.
PACED_CE_SCALE = 4 * float(np.log(32128))
# cli.train presets: phase 5's (t5-base, bf16, flash_v3 + fused_qkv,
# dense, remat off, batch 16, L 188, pools of 100 over 2048 docs), 6
# optimizer steps, one metrics row a step, and each curriculum's own
# settings, chosen so that its difficulty moves within the 6 steps
CURRICULUM_PRESET = dict(TRAIN_PRESET,
                         total_steps=B_TRAIN * CURRICULUM_STEPS)
CURRICULUM_CASES = {
    # num_steps = int(0.667 * 96) = 64 examples: the ramp ends at step 4
    "interp": dict(frac_interpolate=0.667),
    "level": dict(heuristic_step_check=2, success_threshold=0.0),
    "eta": dict(ce_scale=PACED_CE_SCALE),
    "contrast": dict(rate_check=2, success_threshold=0.0,
                     ce_scale=PACED_CE_SCALE),
    "meta-cheap": dict(meta_lr=1e-2),
    # dense (std refuses the kernels' routes), 2 steps
    "meta-std": dict(meta_lr=1e-2, flash_v3=False, total_steps=B_TRAIN * 2),
}
# meta-std's v-gradient at t5-base in fp32: the oracle of
# tests/test_train.py:201-257 (3 examples, lr 0.05, central differences
# with eps 1e-2; rtol 5e-3, atol 2e-3)
META_FD_B, META_FD_LR, META_FD_EPS = 3, 0.05, 1e-2
META_FD_RTOL, META_FD_ATOL = 5e-3, 2e-3


@contextlib.contextmanager
def _row_times():
    """The host clock after each metrics row is written. Both loops read a
    step's metrics to the host (a synchronisation) to write its row, so
    with one row a step the gaps between rows are step times."""
    times = []
    write = MetricWriter.write

    def timed(self, record):
        write(self, record)
        times.append((time.perf_counter(), self.history[-1]))

    MetricWriter.write = timed
    try:
        yield times
    finally:
        MetricWriter.write = write


def _slot(rank: float) -> int:
    return int(round(rank * POOL_SLOTS))


def _index(difficulty) -> int:
    """difficulty_to_index in fp32, as the corpus computes it."""
    return int(np.floor(np.float32(difficulty) * np.float32(POOL_SLOTS)))


def _level_replay(rates: list, check: int) -> list:
    """LevelController's difficulty after each step, replayed on the host
    in fp32 from each step's logged rate: at every ``check``-th step a
    bump of 1 / 99 when the window's mean rate clears the threshold 0."""
    d, out = np.float32(0.0), []
    bump = np.float32(1.0 / POOL_SLOTS)
    for k, _ in enumerate(rates, 1):
        if k % check == 0 and np.mean(rates[k - check:k]) > 0.0:
            d = min(np.float32(1.0), np.float32(d + bump))
        out.append(float(d))
    return out


def _check_trajectory(name: str, rows: list, table) -> dict:
    """Each controller's rule replayed on the host from the logged
    metrics; raises where the logged difficulties or the pool slots the
    batches drew disagree."""
    got = [r.get("difficulty") for r in rows]
    slots = [_slot(r["neg_rank"]) for r in rows if "neg_rank" in r]
    if name == "interp":
        # InterpController in fp32: start 0 + (1 - 0) * (16 k / 64)
        want = [float(np.clip(np.float32(0.0) + np.float32(1.0)
                              * (np.float32(B_TRAIN * k) / np.float32(64)),
                              0.0, 1.0)) for k in range(1, len(rows) + 1)]
    elif name == "level":
        want = _level_replay([r["probs"] for r in rows], 2)
    elif name == "contrast":
        # the logged success_rate is the rate the window accumulates
        want = _level_replay([r["success_rate"] for r in rows], 2)
    elif name == "eta":
        want = [min(max(r["eta"], 0.0), 1.0) for r in rows]
    else:
        # the table's rows j < steps moved into (0, 1), the rest stayed 1;
        # each step logged the mean of the row it stored
        steps = len(rows)
        moved = table[:steps]
        ok = bool(((moved > 0) & (moved < 1)).all()
                  and (moved != 1).all()
                  and (table[steps:] == 1).all())
        means = moved.mean(dim=1).tolist()
        err = max(abs(r["avg_weight"] - m) for r, m in zip(rows, means))
        traj = dict(avg_weight=[r["avg_weight"] for r in rows],
                    table_rows_moved=steps, table_rows=table.shape[0],
                    avg_weight_vs_table=err)
        if not (ok and err <= 1e-6):
            raise AssertionError(f"{name} table: {traj}")
        return traj
    # the batch of step k drew the slot of the difficulty before it (0
    # before step 1: eta's difficulty is 0 until its first update)
    want_slots = [_index(d) for d in [0.0] + want[:-1]]
    traj = dict(difficulty=got, replayed=want, slots=slots,
                replayed_slots=want_slots)
    if got != want or slots != want_slots or len(set(got)) < 2:
        raise AssertionError(f"{name} trajectory: {traj}")
    return traj


def _curriculum_run(smi: str, name: str, per_step: dict) -> dict:
    """cli.train.main with ``name``'s preset, counted and timed: launches
    exactly ``per_step`` a step, finite losses, every weight moved, the
    difficulty trajectory as the controller's rule replays it."""
    preset = dict(CURRICULUM_PRESET, curriculum=name,
                  **CURRICULUM_CASES[name])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        with _row_times() as times:
            summary = train_main(preset={**preset, "out_dir": out},
                                 argv=[], device="cuda")
        seconds = time.perf_counter() - t0
        launches = _launches()
        saved = torch.load(os.path.join(out, "final", CHECKPOINT_FILE),
                           map_location="cuda", weights_only=True)
    steps = summary["steps"]
    rows = [r for _, r in times if "loss" in r]
    ends = [t for t, r in times if "loss" in r]
    step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    losses = [r["loss"] for r in rows]
    init = t5.flatten_params(t5.init_params(
        t5.T5Config.base(), torch.Generator(device="cuda").manual_seed(42),
        "cuda"))
    final = saved["params"]
    changed = sum(not torch.equal(final[k], init[k]) for k in init)
    finite = (len(losses) == steps and bool(np.isfinite(losses).all())
              and all(torch.isfinite(v).all().item()
                      for v in final.values()))
    want = {k: n * steps for k, n in per_step.items()}
    table = saved["curriculum"].get("table")
    fields = dict(
        case=name, steps=steps, seconds=seconds,
        rows_per_step=B_TRAIN * 2, nvidia_smi=smi,
        step_ms=step_ms, median_step_ms_2_on=statistics.median(step_ms),
        launches=launches, expected_launches=want,
        launches_per_step={k: v / steps for k, v in launches.items()},
        losses=losses, finite=finite, leaves_changed=changed,
        leaves=len(init),
        trajectory=_check_trajectory(name, rows, table),
        final_eta=rows[-1].get("eta"),
    )
    emit("curricula", **fields)
    if not (launches == want and finite and changed == len(init)):
        raise AssertionError(f"curricula {name}: {fields}")
    return fields


def _meta_ab(smi: str, case: str, variant: str, cfg_a: t5.T5Config,
             cfg_b: t5.T5Config, want_a: dict, want_b: dict) -> dict:
    """One meta step (``variant``) on ``cfg_a`` against ``cfg_b`` from the
    same fp32 master weights, table and batch: the meta loop's first (table
    row 0: pairs 0..15, each at its table weight 1) at the meta-cheap
    preset's meta_lr. The v-gradient each step took, recovered from the
    stored row as u = (v - logit(row)) / lr (cheap: (pce + nce) / B - 1 from
    the frozen forwards; std: gv through the virtual step), is compared as
    ||u_a - u_b|| / ||u_b||, the loss by its relative error and the AdamW
    first moments leaf by leaf, at phase 5's tolerances, as ``_step_ab``
    compares the pair step (lr(0) = 0: mu is 0.1 x the clipped gradient).
    Launches must be exactly ``want_a`` and ``want_b``."""
    meta_lr = CURRICULUM_CASES["meta-cheap"]["meta_lr"]
    tok, dc, params, _, _ = _step_env(cfg_a, 160, B_TRAIN, 1, "pair")
    table = MetaWeightTable(num_batches=8, batch_size=B_TRAIN)
    v = table.lookup(table.init("cuda"), 0)
    batch = dc.pair_batch(torch.arange(B_TRAIN, device="cuda"), v)
    runs = {}
    for label, cfg, want in (("a", cfg_a, want_a), ("b", cfg_b, want_b)):
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = make_meta_train_step(cfg, table, tx, lambda s: meta_lr,
                                    variant=variant, rel_id=tok.true_id,
                                    nrel_id=tok.false_id)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _launches()
        t0 = time.perf_counter()
        state, metrics = step(init_train_state(params, tx,
                                               table.init("cuda")), batch, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        used = {k: n - before[k] for k, n in _launches().items()}
        row = table.lookup(state.curriculum, 0)
        u = (v - torch.logit(row.double()).float()) / meta_lr
        runs[label] = dict(loss=metrics["loss"].item(), row=row, u=u,
                           mu=t5.flatten_params(state.opt_state.mu),
                           used=used, want=want, ms=ms,
                           peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        del state
    a, b = runs["a"], runs["b"]
    rel = {k: ((a["mu"][k] - b["mu"][k]).norm() / b["mu"][k].norm()).item()
           for k in b["mu"] if b["mu"][k].norm() > 0}
    worst = max(rel, key=rel.get)
    u_rel = ((a["u"] - b["u"]).norm() / b["u"].norm()).item()
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    fields = dict(
        case=case, variant=variant, nvidia_smi=smi, pairs=B_TRAIN,
        meta_lr=meta_lr, loss_a=a["loss"], loss_b=b["loss"],
        loss_rel_err=loss_rel, loss_tol=STEP_LOSS_RTOL,
        v_grad_a=a["u"].tolist(), v_grad_rel_l2=u_rel,
        row_max_abs_err=(a["row"] - b["row"]).abs().max().item(),
        row_bitwise=torch.equal(a["row"], b["row"]),
        grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
        grad_rel_l2_median=statistics.median(rel.values()),
        grad_tol=STEP_GRAD_REL_L2, grad_median_tol=STEP_GRAD_REL_L2_MEDIAN,
        mu_leaves_bitwise=sum(torch.equal(a["mu"][k], b["mu"][k])
                              for k in b["mu"]),
        leaves=len(rel), step_ms_a=a["ms"], step_ms_b=b["ms"],
        peak_mib_a=a["peak_mib"], peak_mib_b=b["peak_mib"],
        launches_a=a["used"], launches_b=b["used"],
        expected_launches_a=want_a, expected_launches_b=want_b,
    )
    emit("curricula", **fields)
    if not (a["used"] == want_a and b["used"] == want_b
            and loss_rel <= STEP_LOSS_RTOL and u_rel <= STEP_GRAD_REL_L2
            and rel[worst] <= STEP_GRAD_REL_L2
            and fields["grad_rel_l2_median"] <= STEP_GRAD_REL_L2_MEDIAN):
        raise AssertionError(f"meta step {case}: {fields}")
    return fields


def _meta_std_fd_check(smi: str) -> dict:
    """meta-std's v-gradient at t5-base in fp32 on the dense route: the
    stored row after one step against sigmoid(v - lr * gv_fd), gv_fd the
    central finite difference of F(v) = weighted_CE(theta - lr *
    d/dtheta weighted_CE(theta, v), v) - sum(v) through real model
    applies (tests/test_train.py:201-257's oracle, at its tolerances)."""
    from pacednegatives_tpu_torch.ops.losses import token_ce

    cfg = dataclasses.replace(t5.T5Config.base(), dtype=torch.float32)
    tok, dc, params, _, _ = _step_env(cfg, 160, META_FD_B, 1, "pair")
    batch = dc.pair_batch(torch.arange(META_FD_B, device="cuda"),
                          torch.tensor(0.4, device="cuda"))
    table = MetaWeightTable(num_batches=8, batch_size=META_FD_B)
    tx = make_optimizer(1e-3, total_steps=4)
    step = make_meta_train_step(cfg, table, tx, lambda s: META_FD_LR,
                                variant="std", rel_id=tok.true_id,
                                nrel_id=tok.false_id)

    def per_example(p):
        return [token_ce(t5.forward_logits(
            p, cfg, batch[f"{s}_ids"], batch[f"{s}_labels"],
            batch[f"{s}_mask"]), batch[f"{s}_labels"]) for s in ("pos", "neg")]

    def F(v):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in t5.flatten_params(params).items()}
        pce, nce = per_example(t5.unflatten_params(leaves))
        g = torch.autograd.grad((pce * v).sum() / META_FD_B
                                + (nce * v).sum() / META_FD_B,
                                list(leaves.values()))
        virt = t5.unflatten_params({k: p.detach() - META_FD_LR * gk for
                                    (k, p), gk in zip(leaves.items(), g)})
        with torch.no_grad():
            pce, nce = per_example(virt)
            return ((pce * v).sum() / META_FD_B + (nce * v).sum() / META_FD_B
                    - v.sum()).item()

    v0 = torch.ones(META_FD_B, device="cuda")
    gv_fd = []
    for i in range(META_FD_B):
        e = torch.zeros(META_FD_B, device="cuda")
        e[i] = META_FD_EPS
        gv_fd.append((F(v0 + e) - F(v0 - e)) / (2 * META_FD_EPS))
    gv_fd = np.asarray(gv_fd)
    t0 = time.perf_counter()
    new_state, _ = step(init_train_state(params, tx, table.init("cuda")),
                        batch, 2)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got = table.lookup(new_state.curriculum, 2).cpu().numpy()
    want = 1.0 / (1.0 + np.exp(-(1.0 - META_FD_LR * gv_fd)))
    err = np.abs(got - want)
    ok = bool((err <= META_FD_ATOL + META_FD_RTOL * np.abs(want)).all()
              and np.abs(gv_fd).max() > 0.1)
    fields = dict(check="meta_std_v_gradient_vs_finite_differences",
                  config="t5-base fp32 dense", examples=META_FD_B,
                  lr=META_FD_LR, eps=META_FD_EPS, gv_fd=gv_fd.tolist(),
                  stored=got.tolist(), want=want.tolist(),
                  max_abs_err=float(err.max()), rtol=META_FD_RTOL,
                  atol=META_FD_ATOL, step_s=step_s, ok=ok, nvidia_smi=smi)
    emit("curricula", **fields)
    if not ok:
        raise AssertionError(f"meta-std v-gradient: {fields}")
    del new_state

    # std refuses every route through a hand kernel's autograd Function:
    # flash_v3 when the step is built; chunked flash_kernel in
    # _FlashCore's backward, at a 128-aligned length (L 128), where the
    # chunked core takes the kernel route (at L 188 it takes the plain,
    # twice-differentiable one): K1 must have launched first
    refused, k1 = {}, {}
    _, _, params, _, batch = _step_env(_chunked_cfg(True), 100, META_FD_B, 1,
                                       "pair")
    state = init_train_state(params, tx, table.init("cuda"))
    for label, c in (("flash_v3", _train_cfg(True)),
                     ("chunked_flash_kernel", _chunked_cfg(True))):
        before = flash_attention_forward.launches
        try:
            step = make_meta_train_step(c, table, tx, lambda s: META_FD_LR,
                                        variant="std")
            step(state, batch, 0)
        except NotImplementedError as e:
            refused[label] = str(e)
        else:
            raise AssertionError(f"meta-std ran on the {label} route")
        k1[label] = flash_attention_forward.launches - before
    emit("curricula", check="meta_std_refuses_kernel_routes",
         prompt_len=batch["pos_ids"].shape[1], k1_launches=k1, **refused)
    if not (batch["pos_ids"].shape[1] == 128 and k1["flash_v3"] == 0
            and k1["chunked_flash_kernel"] > 0):
        raise AssertionError(f"meta-std refusals: K1 launches {k1}")
    return {**fields, "refused": sorted(refused)}


def phase_curricula(smi: str) -> dict:
    """Every pacing curriculum through ``cli.train.main`` at t5-base (phase
    5's preset): the pair loss (interp, level, eta, contrast) runs one
    forward over [pos; neg], 32 rows, a step; meta-cheap a frozen pos + neg
    forward, then a main pos + neg forward and backward, 16 rows each;
    meta-std the dense route, no kernel. Then one pair step and one
    meta-cheap step with the kernels against the dense route, one meta-std
    step under ``dots_nobatch`` against remat off, and meta-std's
    v-gradient on the card."""
    layers = t5.T5Config.base().num_layers
    emit("curricula", config="t5-base", vocab=32128, dtype="bfloat16",
         flash_v3=True, fused_qkv=True, batch=B_TRAIN, prompt_len=L_SERVE,
         steps=CURRICULUM_STEPS, cases=CURRICULUM_CASES)
    # the pair step: K3 and K4 once per encoder layer; GEMMs 2 + 1 a layer
    pair = _per_step(attention=layers, attention_bwd=layers,
                     gemm=3 * layers)
    # meta-cheap: four forwards (K3 4 x 12), two backwards (K4 2 x 12)
    cheap = _per_step(attention=4 * layers, attention_bwd=2 * layers,
                      gemm=8 * layers + 2 * layers)
    runs = {name: _curriculum_run(smi, name, per) for name, per in (
        ("interp", pair), ("level", pair), ("eta", pair),
        ("contrast", pair), ("meta-cheap", cheap), ("meta-std", _per_step()))}
    step1 = _step_ab("step1_pair_flash_v3_vs_dense", _train_cfg(True),
                     _train_cfg(False), 160, pair,
                     (STEP_LOSS_RTOL, STEP_GRAD_REL_L2,
                      STEP_GRAD_REL_L2_MEDIAN), n_neg=1, loss="pair")
    # the pair step alone, outside the CLI's loop: step ms, device-busy ms
    # of a profiled step, aten ops (phase 5's L188 remat-off case is the
    # LCE step's, 128 rows)
    profile = _remat_ab(smi, "pair_L188", _train_cfg(True), 160, B_TRAIN, 1,
                        (), pair, pair, fwd_bwd=False, loss="pair")["off"]
    # meta-cheap's forwards on the fp32 masters, q|k|v concatenated on each
    # call: K3 / K4 against the dense route
    cheap_ab = _meta_ab(smi, "meta_cheap_flash_v3_vs_dense", "cheap",
                        _train_cfg(True), _train_cfg(False), cheap,
                        _per_step())
    # meta-std under RunConfig's default remat (the selective checkpoint
    # saving the projections' products) against remat off, dense
    std_remat = _meta_ab(
        smi, "meta_std_dots_nobatch_vs_remat_off", "std",
        dataclasses.replace(_train_cfg(False), remat=True,
                            remat_policy="dots_nobatch"),
        _train_cfg(False), _per_step(), _per_step())
    fd = _meta_std_fd_check(smi)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in COUNTED}
    return {"runs": runs, "step1": step1, "profile": profile,
            "meta_cheap_ab": cheap_ab, "meta_std_remat": std_remat,
            "meta_std_fd": fd, "launches": launches}


def _entry(name: str, source: str, replaces: str, launches: int, r: dict,
           **extra) -> dict:
    """One kernel of the final line, from its phase-3 or phase-7 check."""
    return {"name": name, "route": "cuda",
            "source": "pacednegatives_tpu_torch/csrc/" + source,
            "replaces": "pacednegatives_tpu/" + replaces,
            "launches": launches,
            **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_note", "library_err_rel",
                                       "host_us",
                                       "ms_back_to_back",
                                       "library_ms_back_to_back",
                                       "shape", "kernel_ms", "merge_ms",
                                       "per_block_kernel_ms",
                                       "per_block_merge_ms")
               if key in r},
            **extra}


def main() -> int:
    t_start = time.perf_counter()
    device, smi = phase_device()
    phase_build()
    k = phase_kernels()
    s = phase_slice()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        tr = phase_train(smi, run_dir)
        ch = phase_chunked(smi)
        f512 = phase_fused512(smi)
        dn = phase_dense(smi)
        ev = phase_evaluate(smi, run_dir)
    cu = phase_curricula(smi)
    dk = dn["kernels"]
    paths = {"serving": s["launches"], "train": tr["run"]["launches"],
             "train_default_dots_nobatch": tr["default"]["launches"],
             "train_dropout_multisteps": tr["dropout"]["launches"],
             "fused512": f512["run"]["launches"],
             "chunked_512": ch["run"]["launches"],
             "chunked_768": ch["k2a_run"]["launches"],
             "online": dn["online"]["launches"],
             "build_pools": dn["build_pools"]["launches"],
             "evaluate": ev["bf16"]["launches"],
             "evaluate_int8": ev["int8"]["launches"],
             "curricula": cu["launches"]}
    total = {name: sum(p.get(name, 0) for p in paths.values())
             for name in COUNTED}
    print(json.dumps({"kernels": [
        _entry("gemm_bf16", "gemm_bf16.cu", "ops/flash_v3.py:147",
               total["gemm"], k["gemm"]["qkv"],
               also_replaces=["pacednegatives_tpu/ops/flash_v3.py:279"],
               o_projection=k["gemm"]["o"],
               **{label: k["gemm"][label] for label in (
                   "train_qkv", "train_o", "refresh_qkv", "refresh_o")}),
        _entry("t5_attention_fwd", "t5_attention_fwd.cu", "ops/flash.py:121",
               total["attention"], k["attention"]["slice"],
               also_replaces=["pacednegatives_tpu/ops/flash.py:498",
                              "pacednegatives_tpu/ops/flash_v3.py:147"],
               refresh=k["attention"]["refresh"],
               L512_dk128=k["attention"]["L512_dk128"],
               train512_fp32_out=k["attention"]["train512_fp32_out"],
               train768_fp32_out=k["attention"]["train768_fp32_out"],
               fused_self_attention=k["fused_self_attention"]),
        _entry("t5_attention_bwd", "t5_attention_bwd.cu",
               "ops/flash_v3.py:279", total["attention_bwd"],
               k["v3_backward"]["train"],
               k4_ms=k["v3_backward"]["train"]["k4_ms"],
               k4_plain_ms=k["v3_backward"]["train"]["k4_plain_ms"],
               train512=k["v3_backward"]["train512"],
               L512_dk128=k["v3_backward"]["L512_dk128"]),
        _entry("t5_attention_core_bwd_k2b", "t5_attention_bwd.cu",
               "ops/flash.py:614", total["core_bwd_k2b"],
               k["core_bwd"]["k2b_train512"],
               dk128=k["core_bwd"]["k2b_dk128"]),
        _entry("t5_attention_core_bwd_k2a", "t5_attention_bwd_fp32.cu",
               "ops/flash.py:353", total["core_bwd_k2a"],
               k["core_bwd"]["k2a_L768"],
               also_replaces=["pacednegatives_tpu/ops/flash.py:384"],
               Lq256_Lk128=k["core_bwd"]["k2a_Lq256_Lk128"],
               dk128=k["core_bwd"]["k2a_dk128"]),
        _entry("mips_topk", "mips_topk.cu", "ops/mips.py:112",
               total["mips_topk"], dk["k5_pools"],
               bf16=dk["k5_bf16"], exact=dk["k5_exact"]),
        _entry("mips_topk_int8", "mips_topk.cu", "ops/mips.py:186",
               total["mips_topk_int8"], dk["k6_msmarco"],
               online_shape=dk["k6_online"]),
    ], "launches_by_path": paths,
        "docs_per_s": {"unpacked": s["unpacked"]["docs_per_s"],
                       "packed_bucketed": s["packed"]["docs_per_s"]},
        "train": {"steps_per_s": tr["run"]["steps_per_s"],
                  "trained_negatives_per_s":
                      tr["run"]["trained_negatives_per_s"],
                  "step1_loss_rel_err": tr["step1"]["loss_rel_err"],
                  "step1_grad_rel_l2_max": tr["step1"]["grad_rel_l2_max"]},
        "train_default_dots_nobatch": {
            "steps_per_s": tr["default"]["steps_per_s"],
            "trained_negatives_per_s":
                tr["default"]["trained_negatives_per_s"]},
        "remat": {case: {policy: {key: r.get(key) for key in (
            "step_ms", "busy_ms", "idle_share", "peak_mib", "resident_mib",
            "held_after_forward_mib", "fwd_bwd_peak_mib")}
            for policy, r in runs.items()}
            for case, runs in (("L188", tr["remat"]),
                               ("chunked512", ch["remat"]))},
        "train_dropout_multisteps": {
            "steps_per_s": tr["dropout"]["steps_per_s"],
            "losses": tr["dropout"]["losses"]},
        "train_fused512": {
            "steps_per_s": f512["run"]["steps_per_s"],
            "trained_negatives_per_s":
                f512["run"]["trained_negatives_per_s"],
            "step1_loss_rel_err": f512["step1"]["loss_rel_err"],
            "step1_grad_rel_l2_max": f512["step1"]["grad_rel_l2_max"],
            "step1_grad_rel_l2_median": f512["step1"]["grad_rel_l2_median"]},
        "train_chunked_512": {
            "steps_per_s": ch["run"]["steps_per_s"],
            "trained_negatives_per_s": ch["run"]["trained_negatives_per_s"],
            "step1_loss_rel_err": ch["step1"]["loss_rel_err"],
            "step1_grad_rel_l2_max": ch["step1"]["grad_rel_l2_max"],
            "step1_grad_rel_l2_median": ch["step1"]["grad_rel_l2_median"]},
        "train_chunked_768_k2a": {
            "steps_per_s": ch["k2a_run"]["steps_per_s"],
            "step1_loss_rel_err": ch["step768"]["loss_rel_err"],
            "step1_grad_rel_l2_max": ch["step768"]["grad_rel_l2_max"],
            "step1_grad_rel_l2_median": ch["step768"]["grad_rel_l2_median"]},
        "train_online_int8": {
            "steps_per_s": dn["online"]["steps_per_s"],
            "refresh_seconds": dn["online"]["refresh_seconds"]},
        "build_pools": {key: dn["build_pools"][key] for key in
                        ("seconds", "pools", "near_tie_swaps_vs_exact",
                         "median_top1000_score_spread")},
        "evaluate": {label: {key: ev[label][key] for key in (
            "pairs", "seconds", "bm25_build_s", "bm25_search_s", "rerank_s",
            "rerank_docs_per_s", "native_bm25", "metrics")}
            for label in ("bf16", "int8")},
        "evaluate_scores_vs_cpu": {label: r["max_abs_err"]
                                   for label, r in ev["checks"].items()},
        "evaluate_int8_vs_bf16": ev["int8_vs_bf16"],
        "curricula": {
            **{name: {key: r[key] for key in (
                "median_step_ms_2_on", "launches_per_step")}
               for name, r in cu["runs"].items()},
            "pair_step_alone": {key: cu["profile"][key] for key in (
                "step_ms", "busy_ms", "idle_share", "aten_ops_per_step",
                "peak_mib")},
            "step1_pair_loss_rel_err": cu["step1"]["loss_rel_err"],
            "step1_pair_grad_rel_l2_max": cu["step1"]["grad_rel_l2_max"],
            **{name: {key: cu[name][key] for key in (
                "loss_rel_err", "v_grad_rel_l2", "grad_rel_l2_max",
                "grad_rel_l2_median", "row_bitwise", "step_ms_a",
                "step_ms_b")}
               for name in ("meta_cheap_ab", "meta_std_remat")},
            "meta_std_fd_max_abs_err": cu["meta_std_fd"]["max_abs_err"]},
        "seconds": time.perf_counter() - t_start,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   embed_grad - the embedding lookup's backward (E1, ``csrc/embed_grad.cu``)
             at lce-b64's encoder lookup (512 x 188 ids, D 768) and
             lce-b32's (256 x 188, D 1024), vocab 32,128, bf16, about half
             the ids pad, and at the Moonlight cell's (its ~24,000 real
             ids of 256 x 188, D 2,048, vocab 20,480): each row within one bf16 ulp of its largest fp64
             value, bitwise equal across two calls; the whole op (sort and
             both passes), the plain version, aten's
             ``embedding_dense_backward`` and the ``index_put_`` that
             autograd through ``table[ids]`` ran, timed;
   moe_gemm - M1, the expert layers' grouped GEMM (``csrc/moe_gemm.cu``)
             at the Moonlight cell's shapes (gate|up and down, forward, dX
             and dW over ~15,000 slots on 8 experts): against the plain
             per-expert loop, bitwise equal across two calls, timed beside
             ``torch._grouped_mm``;
   moonlight - the Moonlight cell's model (DeepSeek-V3 layers at
             Moonlight-16B-A3B's widths: 9 layers, 8 of 64 experts held,
             vocabulary 20,480, bf16) trained through ``make_train_step``
             for a few LCE steps of 32 x (1 + 7) rows with the counts
             zeroed first: M1 exactly 4 x 8 (forward and dX) and 2 x 8
             (dW) times a step, E1 once, no other kernel; finite losses,
             step ms and peak memory;
4. slice   - monoT5 rerank at t5-base width (random weights from a seed,
             flash_v3 on, bf16) through ``Reranker.rerank``: unpacked, then
             packed with length buckets. Launch counts must equal the
             routing's prediction, scores must be finite, and the first
             block's scores must agree with the port run on the CPU;
5. train   - the LCE training step at t5-base width (flash_v3 + fused_qkv,
             bf16, batch 16 x (1 + 7 negatives) x 188 tokens) through
             ``cli.train.main`` for a few optimizer steps (with
             ``--export_hf``, read in phase 10): launch counts as
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
             differences; and meta-std refusing the kernels' routes;
10. scored - K3 against its plain version at the scored pool's bucket
             widths 64 and 160 and the SPLADE query length 24; phase 5's
             preset with 64 model-scored candidates a pair through
             ``cli.train.main`` (4 steps, K3 24 / K4 12 a step;
             ``neg_scored`` 16 x (64 + 7)) and 2 steps scoring through the
             W8A8 forward with a bf16 stream (K3 12); the first step's 2 x
             64 candidate scores on the card against the CPU, bf16 and
             int8_bf16; the JAX bench's fused_scored (C 256 of pools of
             1,000, a lognormal packed corpus, buckets 64/96/128/160,
             chunks of 256 rows) through ``make_scored_pool_step`` without
             a hand kernel and with flash_v3 + fused_qkv (K3 240, K4 48 a
             step), bucketed against full-width scores (max |diff|, order
             moves), steps/s and negatives scored/s beside the matched
             ref_varlen control (an upper-bound multiple: the control
             pads to the fixed budget); phase 5's HF export read back bit
             for bit and trained from for 2 steps (ce_scale 1.0); and
             ``cli.build_pools.main --method splade`` on phase 5's run over
             phase 8's corpus (K3 384), the first docs' activations and
             top terms against the CPU;
11. distill - ``cli.mine_negatives.main`` (budget 1000) and
             ``cli.teacher_scores.main`` over phase 8's corpus with one
             judged positive a query (256 pairs), each run twice in this
             process, byte for byte the same; ``cli.distill.main`` at
             t5-base (its own config: bf16, remat ``dots``, dense) for 6
             MarginMSE steps and 2 CE steps of 16 triples: finite losses,
             every weight moved (but the decoder self-attention's q, k
             and rel_bias, which MarginMSE gives an exact zero gradient),
             no hand kernel launched, step ms; then ``make_distill_step``
             with flash_v3 + fused_qkv at phase 5's prompt width (K3 = K4
             = 12 a step): step 1 against the dense route (CE at the LCE
             step's gates; MarginMSE within twice the dense bf16 route's
             distance from the dense route in fp32), steps timed, two
             steps traced by
             ``utils.profiling.trace`` (the trace must name the hand
             kernels); ``debug_nans`` on a clean dense step and on a NaN
             teacher score (it must raise); ``cost_analysis`` of a dense
             forward beside ``t5_forward_flops``; MFU against
             ``device_peak_flops``;
12. parallel - phase 5's step on pairs 0..15 over ranks (the port's
             ``parallel/``): (a) under an NCCL mesh of one rank in this
             process, bit for bit the step without a mesh (K3 = K4 = 12),
             and a one-shard int8 index (phase 7b's 16,384 docs) bit for
             bit the unsharded K6 top-k; (b) 4 gloo ranks in processes of
             their own sharing the card (``--parallel-rank``; they load
             phase 2's build), a dp2 x seq2 mesh with
             ``negative_parallel`` (in the port the same row split as
             dp4), then 2 of
             them, dp2 and a 2-shard K6 index: each step against the one
             process's at phase 5's gates, the same state on every rank,
             K3 = K4 = 12 a rank, peak MiB a rank; the index one
             process's up to near-tie swaps; (c) phase 7b's online setting
             with ``OverlappedRefresher`` on a side stream of the card:
             the slices bit for bit the serial refresh, ``start()``'s
             share of a refresh, 8 steps beside a refresh against the
             steps then the refresh (seconds, launches), a profiled window
             (the side stream's K1 beside the main stream's kernels), and
             the loop's swap one chunk after the serial loop's; (d) with
             two cards, (b)'s dp2 over NCCL, else "not run: 1 card";
13. tensor - tensor parallelism (a mesh's ``model`` axis): K1 and K2b
             against their plain versions at a tp2 rank's shape (32 rows,
             6 heads, L 256); 4 gloo ranks sharing the card
             (``--tensor-rank``) run one online step of t5-base on
             dp2 x tp2 (the 2,048-doc int8 index in two 1,024-doc shards,
             K6 once a rank), then 2 of them 2 fused LCE steps on dp1 x
             tp2 (bf16, fused_qkv, chunked attention with the kernels at
             L 256: 24 query + 228 doc + 4 template tokens; 8 pairs x
             (1 + 3)); each rank holds 6 of the 12 heads and runs K1 and
             K2b on them, 12 each a step. Against the one process: the
             losses and step 1's per-leaf gradients at phase 5's gates,
             the whole state the same on every rank, launches, peak MiB
             and seconds a step a rank; every weight moved after step 2.
             With two cards the steps over NCCL, else "not run: 1 card".

The CPU side of phases 4, 8 and 10's card-against-CPU checks runs in a
background process of this script (``--cpu-job``, no card in sight, half
the cores) while the card phases go on; those comparisons are made after
phase 11, before the multi-process phases (a ``cpu_reference`` line).

Then a JSON line with one entry per kernel (its time beside its bound, its
plain version's and, where one PyTorch call computes the same function,
that call's), and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import datetime
import gc
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from pacednegatives_tpu_torch import distill as distill_pkg
from pacednegatives_tpu_torch import kernels
from pacednegatives_tpu_torch.cli.build_pools import main as build_pools_main
from pacednegatives_tpu_torch.cli.distill import main as distill_main
from pacednegatives_tpu_torch.cli.evaluate import main as evaluate_main
from pacednegatives_tpu_torch.cli.mine_negatives import main as mine_main
from pacednegatives_tpu_torch.cli.teacher_scores import main as teacher_main
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
from pacednegatives_tpu_torch.distill import TeacherBatcher, TeacherScores
from pacednegatives_tpu_torch.distill.loader import load_triples_tsv
from pacednegatives_tpu_torch.distill.train import (
    init_distill_state,
    make_distill_step,
)
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.eval.run_io import read_trec_run
from pacednegatives_tpu_torch.index import bm25
from pacednegatives_tpu_torch.index.dense import DenseIndex
from pacednegatives_tpu_torch.models import deepseek_v3, t5
from pacednegatives_tpu_torch.models.dual_encoder import encode_corpus
from pacednegatives_tpu_torch.ops import moe
from pacednegatives_tpu_torch.models.hf_import import load_hf_checkpoint
from pacednegatives_tpu_torch.models.monot5 import score_batch
from pacednegatives_tpu_torch.models.quant import (
    quantize_scoring_params,
    score_batch_int8,
)
from pacednegatives_tpu_torch.models.splade import splade_activations
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
from pacednegatives_tpu_torch.ops.embedding import (
    embedding_grad,
    embedding_grad_plain,
    embedding_lookup,
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
    topk_stable,
)
from pacednegatives_tpu_torch.optim import tree_leaves
from pacednegatives_tpu_torch.parallel import MeshConfig, create_mesh
from pacednegatives_tpu_torch.parallel.collectives import (
    gather_batch,
    gather_model,
)
from pacednegatives_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_fused_step,
    make_meta_train_step,
    make_optimizer,
    make_train_step,
    pair_index_stream,
)
from pacednegatives_tpu_torch.train.loop import CHECKPOINT_FILE, MetricWriter
from pacednegatives_tpu_torch.train.online import (
    OnlineMiningConfig,
    OnlineMiningLoop,
    make_online_fused_step,
    make_refresh_fn,
)
from pacednegatives_tpu_torch.train.overlap import OverlappedRefresher
from pacednegatives_tpu_torch.train.runner import load_run
from pacednegatives_tpu_torch.train.state import (
    encoder_weights,
    gather_train_state,
    shard_train_state,
)
from pacednegatives_tpu_torch.train.scored_pool import (
    balanced_slots,
    make_scored_pool_step,
    score_candidates,
)
from pacednegatives_tpu_torch.utils import profiling

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


# The card-against-CPU checks of phases 4, 8 and 10 need the port's
# t5-base forwards on the CPU (~250 s on 8 cores). They run in one
# background process, a job at a time on half the cores, while the card
# phases go on; each comparison is made once phase 11 has ended, before
# the multi-process phases 12 and 13 (which would compete for the cores).
CPU_THREADS = max(1, len(os.sched_getaffinity(0)) // 2)
CPU_REFERENCE_TIMEOUT_S = 600


def _serve_block_cpu(params, cfg, store, corpus, rel_id, nrel_id, q_rows,
                     d_rows) -> np.ndarray:
    """Phase 4's first block through the port's Reranker on the CPU."""
    rr = Reranker(params, cfg, store, corpus, rel_id=rel_id, nrel_id=nrel_id,
                  batch_size=len(q_rows), device="cpu")
    return rr._score_block(q_rows, d_rows, None)


def _eval_scores_cpu(run_dir, corpus, q_rows, d_rows) -> dict:
    """Phase 8's pairs scored by phase 5's run on the CPU, bf16 and int8."""
    out = {}
    for label, int8_on in (("bf16", False), ("int8", True)):
        params, mcfg, tok, rc = load_run(run_dir, device="cpu")
        store = TokenizedStore.build(corpus, tok,
                                     max_q_tokens=rc.max_q_tokens,
                                     max_d_tokens=rc.max_d_tokens)
        rr = Reranker(params, mcfg, store, corpus, rel_id=tok.true_id,
                      nrel_id=tok.false_id, batch_size=len(q_rows) // 2,
                      int8=int8_on, device="cpu")
        out[label] = rr.score_pairs(q_rows, d_rows)
        del params, rr
    return out


def _candidate_scores(params, cfg, ids, mask, rel_id, nrel_id) -> dict:
    """Phase 10's candidates scored bf16 and int8_bf16 on ``ids``' device."""
    kw = dict(rel_id=rel_id, nrel_id=nrel_id)
    with torch.no_grad():
        return {"bf16": score_batch(params, cfg, ids, mask, **kw).float(),
                "int8_bf16": score_batch_int8(
                    quantize_scoring_params(params, cfg), cfg, ids, mask,
                    stream_dtype=torch.bfloat16, **kw).float()}


CPU_JOBS = {"serve_block": _serve_block_cpu, "eval_scores": _eval_scores_cpu,
            "candidate_scores": _candidate_scores}


def _cpu_job(path: str) -> None:
    """A job of the background process (``--cpu-job``): its inputs from
    ``path.in``, its result and CPU seconds to ``path.out``."""
    torch.set_num_threads(CPU_THREADS)
    job = torch.load(path + ".in", weights_only=False)
    t0 = time.perf_counter()
    out = CPU_JOBS[job["fn"]](**job["inputs"])
    torch.save({"out": out, "cpu_seconds": time.perf_counter() - t0},
               path + ".tmp")
    os.replace(path + ".tmp", path + ".out")


class CpuReference:
    """The CPU side of the card-against-CPU checks, run in the background:
    ``submit`` queues a job (a process of this script with no card in
    sight, started when the one before it has ended), ``finish`` waits for
    all of them and hands each result to its comparison, ``close`` kills
    what still runs."""

    def __init__(self):
        self.dir, self.thread, self.proc = None, None, None
        self.jobs, self.queue = [], queue.Queue()
        self.lock, self.closed = threading.Lock(), False

    def submit(self, name: str, fn: str, compare, **inputs) -> None:
        if self.thread is None:
            self.dir = tempfile.mkdtemp(prefix="cpu_reference_")
            self.thread = threading.Thread(target=self._run, daemon=True)
            self.thread.start()
        path = os.path.join(self.dir, name)
        torch.save({"fn": fn, "inputs": inputs}, path + ".in")
        self.jobs.append((name, path, compare))
        self.queue.put(path)

    def _run(self) -> None:
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(CPU_THREADS),
                   PYTHONPATH=os.pathsep.join(
                       [here, os.environ.get("PYTHONPATH", "")]))
        while (path := self.queue.get()) is not None:
            with self.lock:
                if self.closed:
                    return
                err = open(path + ".err", "w")
                self.proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--cpu-job",
                     path], cwd=here, env=env, stdout=subprocess.DEVNULL,
                    stderr=err)
            self.proc.wait()
            err.close()

    def finish(self) -> None:
        if self.thread is None:
            return
        t0 = time.perf_counter()
        self.queue.put(None)
        self.thread.join(timeout=CPU_REFERENCE_TIMEOUT_S)
        if self.thread.is_alive():
            raise AssertionError("CPU reference: not done in "
                                 f"{CPU_REFERENCE_TIMEOUT_S} s")
        results = {}
        for name, path, _ in self.jobs:
            if not os.path.exists(path + ".out"):
                with open(path + ".err") as f:
                    raise AssertionError(f"CPU reference {name}:\n"
                                         f"{f.read()[-6000:]}")
            results[name] = torch.load(path + ".out", weights_only=False)
        emit("cpu_reference", threads=CPU_THREADS,
             waited_s=time.perf_counter() - t0,
             cpu_seconds={name: r["cpu_seconds"]
                          for name, r in results.items()})
        for name, _, compare in self.jobs:
            compare(results[name])

    def close(self) -> None:
        with self.lock:
            self.closed = True
            if self.proc is not None and self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.queue.put(None)
        if self.thread is not None:
            self.thread.join()
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)


CPU_REFERENCE = CpuReference()


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


# Phase 3b. The embedding lookup's backward at the training cells' encoder
# lookups: (rows a step, D, vocab, real tokens only) at L 188; the
# Moonlight cell's lookup runs on the real tokens alone (no pad ids).
EMBED_SHAPES = {"lce_b64_base": (512, 768, 32_128, False),
                "lce_b32_large": (256, 1024, 32_128, False),
                "lce_b32_moonlight": (256, 2048, 20_480, True)}
EMBED_L = 188


def _step_ids(g, B: int, L: int, V: int) -> torch.Tensor:
    """A training step's ids: about half of each row pad id 0, four
    template ids at the head of every row (runs of B), the rest uniform."""
    ids = torch.randint(1, V, (B, L), generator=g, device="cuda")
    ids[torch.rand((B, L), generator=g, device="cuda") < 0.5] = 0
    ids[:, :4] = torch.arange(100, 104, device="cuda")
    return ids


def _row_ulps(got: torch.Tensor, ids: torch.Tensor, cot: torch.Tensor,
              V: int) -> float:
    """The largest row error of ``got`` against the fp64 sum, in bf16 ulps
    of that row's largest exact value (0 for an exact zero row)."""
    D = cot.shape[-1]
    exact = torch.zeros((V, D), dtype=torch.float64, device="cuda")
    exact.index_add_(0, ids.reshape(-1), cot.reshape(-1, D).double())
    _, e = torch.frexp(exact.abs().amax(dim=1))
    ulp = torch.ldexp(torch.ones_like(exact[:, 0]), e - 1 - 7)
    err = (got.double() - exact).abs().amax(dim=1)
    return (err / ulp).max().item()


def phase_embed_grad() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, (B, D, V, real) in EMBED_SHAPES.items():
        ids = _step_ids(g, B, EMBED_L, V)
        if real:
            ids = ids[ids != 0]
        N = ids.numel()
        cot = _randn(g, *ids.shape, D)
        before = embedding_lookup.launches
        got = embedding_grad(cot, ids, V)
        again = embedding_grad(cot, ids, V)
        torch.cuda.synchronize()
        assert embedding_lookup.launches == before + 2
        if not torch.equal(got, again):
            raise AssertionError(f"embed_grad {label}: two calls differ")
        untouched = torch.bincount(ids.reshape(-1), minlength=V) == 0
        if not (got[untouched] == 0).all():
            raise AssertionError(f"embed_grad {label}: an untouched row")

        def library():
            return torch.ops.aten.embedding_dense_backward(
                cot, ids, V, -1, False)

        def index_put():
            return torch.zeros((V, D), dtype=cot.dtype,
                               device="cuda").index_put_(
                (ids,), cot, accumulate=True)

        r = check(f"embed_grad_{label}", _row_ulps(got, ids, cot, V), 1.0,
                  unit="bf16 ulps of the row's largest value",
                  shape=[N, D, V], pad_share=(ids == 0).float().mean().item(),
                  bitwise_repeat=True,
                  library_row_ulps=_row_ulps(library(), ids, cot, V),
                  index_put_row_ulps=_row_ulps(index_put(), ids, cot, V))
        op = lambda: embedding_grad(cot, ids, V)  # noqa: E731
        r.update(
            ms=time_ms(op), ms_back_to_back=time_ms_back_to_back(op),
            host_us=_host_us(op),
            plain_ms=time_ms(lambda: embedding_grad_plain(cot, ids, V)),
            library_ms=time_ms(library),
            library_ms_back_to_back=time_ms_back_to_back(library),
            library_note="aten.embedding_dense_backward (the port never "
                         "calls it)",
            index_put_ms=time_ms(index_put, warmup=1, reps=5),
            # g and the int64 ids read once, the table written once
            **bound(N * D * 2 + N * 8 + V * D * 2, N * D, "fp32"))
        emit("embed_grad", case=label, **r)
        out[label] = r
    return out


# Phase 3c. M1, the grouped GEMM of the expert layers, at the Moonlight
# cell's shapes: about 20,000 real tokens a step routed 6 a token over 64
# experts, the 8 held ones computed (gate|up: 2,048 -> 2,816; down:
# 1,408 -> 2,048), forward, dX and dW.
MOE_TOKENS, MOE_EXPERTS, MOE_HELD, MOE_K = 20_000, 64, 8, 6
MOE_D, MOE_F = 2048, 1408


def phase_moe_gemm() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.topk(torch.rand(MOE_TOKENS, MOE_EXPERTS, generator=g,
                                device="cuda"), MOE_K, dim=-1).indices
    plan = moe.dispatch_plan(idx, 0, MOE_HELD)
    offs = plan["offs"]
    end = plan["rows"]
    slots = int(plan["counts"].sum())
    x = _randn(g, MOE_TOKENS, MOE_D)
    xs = moe.dispatch(x, plan, MOE_K)
    out = {}
    for label, K, N in (("gate_up", MOE_D, 2 * MOE_F), ("down", MOE_F, MOE_D)):
        xk = xs if K == MOE_D else _randn(g, end, K)
        w = _randn(g, MOE_HELD, K, N, scale=K ** -0.5)
        dy = _randn(g, end, N)
        wt = w.transpose(1, 2).contiguous()
        cases = {
            "fwd": (lambda: moe.grouped_gemm(xk, w, offs),
                    lambda: moe.grouped_gemm_plain(xk, w, offs),
                    lambda: torch._grouped_mm(xk, w, offs=offs[1:]),
                    2.0 * slots * K * N,
                    2 * (slots * K + MOE_HELD * K * N + slots * N)),
            "dx": (lambda: moe.grouped_gemm(dy, wt, offs),
                   lambda: moe.grouped_gemm_plain(dy, wt, offs),
                   lambda: torch._grouped_mm(dy, wt, offs=offs[1:]),
                   2.0 * slots * K * N,
                   2 * (slots * N + MOE_HELD * K * N + slots * K)),
            "dw": (lambda: moe.grouped_wgrad(xk, dy, offs),
                   lambda: moe.grouped_wgrad_plain(xk, dy, offs),
                   lambda: torch._grouped_mm(xk.t(), dy, offs=offs[1:]),
                   2.0 * slots * K * N,
                   2 * (slots * K + slots * N + MOE_HELD * K * N)),
        }
        for name, (kern, plain, library, flops, nbytes) in cases.items():
            before = (moe.grouped_wgrad if name == "dw"
                      else moe.grouped_gemm).launches
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_gemm {label} {name}: two calls "
                                     "differ")
            assert (moe.grouped_wgrad if name == "dw"
                    else moe.grouped_gemm).launches == before + 2
            want = plain()
            # bf16 out of an fp32 sum in either order: half an ulp each,
            # plus the sums' orders (~1e-6 of the scale)
            err = max_abs(got, want) / want.float().abs().max().item()
            r = check(f"moe_gemm_{label}_{name}", err, 8e-3,
                      unit="of the largest output", shape=[end, K, N],
                      slots=slots)
            try:
                lib = library()
                r["library_err_rel"] = max_abs(
                    lib, got) / got.float().abs().max().item()
                r.update(library_ms=time_ms(library),
                         library_ms_back_to_back=time_ms_back_to_back(library),
                         library_note="torch._grouped_mm (the port never "
                                      "calls it)")
            except (AttributeError, RuntimeError) as e:
                r.update(library_ms=None, library_note=str(e).splitlines()[0]
                         [:200])
            r.update(ms=time_ms(kern), ms_back_to_back=time_ms_back_to_back(
                kern), host_us=_host_us(kern), plain_ms=time_ms(plain),
                **bound(nbytes, flops, "bf16"))
            emit("moe_gemm", case=f"{label}_{name}", **r)
            out[f"{label}_{name}"] = r
    return out


# Phase 3d. The Moonlight cell's model (its widths, as
# benchmarks/configs/moonlight-16b-a3b.json holds them) trained through
# make_train_step on 32 x (1 + 7) rows at phase 5's prompt budget (L 188).
# A step: each of the 8 expert layers runs M1's grouped GEMM twice in the
# forward (gate|up, down) and twice for dX, and its dW pass twice; E1 once
# (one lookup, over the real tokens).
MOONLIGHT = dict(vocab_size=20480, num_hidden_layers=9, experts_held=(0, 8),
                 dtype=torch.bfloat16)
MOONLIGHT_STEPS = 3


def phase_moonlight() -> dict:
    cfg = deepseek_v3.DeepseekV3Config(**MOONLIGHT)
    experts = cfg.num_hidden_layers - cfg.first_k_dense_replace
    per_step = _per_step(grouped_gemm=4 * experts, grouped_wgrad=2 * experts,
                         embed_grad=1)
    pairs, n_neg = 32, 7
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100, seed=42)
    dc = DeviceCorpus.build(store, triples, device="cuda")
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False,
                         ce_scale=(1 + n_neg) * float(np.log(cfg.vocab_size)))
    tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
    step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=n_neg,
                           use_mean=False, rel_id=tok.true_id,
                           nrel_id=tok.false_id)
    state = init_train_state(
        deepseek_v3.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        tx, ctrl.init("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [dc.lce_batch(gen, torch.arange(i * pairs, (i + 1) * pairs,
                                              device="cuda"),
                            torch.tensor(0.5, device="cuda"), n_neg)
               for i in range(MOONLIGHT_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _launches()
    want = {k: v * MOONLIGHT_STEPS for k, v in per_step.items()}
    fields = dict(layers=cfg.num_hidden_layers, experts_held=cfg.experts_held,
                  vocab=cfg.vocab_size, rows=pairs * (1 + n_neg),
                  prompt_len=batches[0]["pos_ids"].shape[1],
                  real_tokens=[int(b["pos_mask"].sum() + b["neg_mask"].sum())
                               for b in batches],
                  steps=MOONLIGHT_STEPS, losses=losses, step_ms=step_ms,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  launches=launches, expected_launches=want,
                  launches_per_step=per_step)
    emit("moonlight", **fields)
    del state, step, dc, batches
    gc.collect()
    torch.cuda.empty_cache()
    if launches != want or not all(np.isfinite(losses)):
        raise AssertionError(f"moonlight: {fields}")
    return fields


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
    # the plain versions (in the background; compared after phase 11)
    q0, d0 = unpacked["q_rows"][:B_SERVE], unpacked["d_rows"][:B_SERVE]
    gpu = rr._score_block(q0, d0, None)

    def compare(ref: dict) -> None:
        cpu = ref["out"]
        err = float(np.abs(gpu - cpu).max())
        same_top = int((np.argsort(-gpu)[:10] == np.argsort(-cpu)[:10]).sum())
        emit("slice", check="first_block_vs_cpu", max_abs_err=err,
             tol=SCORE_ATOL, ok=err <= SCORE_ATOL,
             cpu_seconds=ref["cpu_seconds"], top10_same_positions=same_top)
        if err > SCORE_ATOL:
            raise AssertionError(f"first block: GPU vs CPU max |diff| {err}")

    CPU_REFERENCE.submit(
        "first_block", "serve_block", compare,
        params=t5.tree_map(lambda t: t.cpu(), params), cfg=cfg, store=store,
        corpus=corpus, rel_id=tok.true_id, nrel_id=tok.false_id, q_rows=q0,
        d_rows=d0)

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
    "embed_grad": embedding_lookup,
    "grouped_gemm": moe.grouped_gemm,
    "grouped_wgrad": moe.grouped_wgrad,
}
# E1 a forward and backward: the encoder's lookup and the decoder's, on
# every attention route (the lookup has no plain route on the card)
EMBED = 2


def _launches() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _zero_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def _per_step(**counts) -> dict:
    """Launches expected per optimizer step: the named ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in COUNTED}


def _train_run(smi: str, case: str, preset: dict, per_step: dict,
               once: dict | None = None, out: str | None = None,
               init: dict | None = None, phase: str = "train") -> dict:
    """cli.train.main with ``preset``, counted: launches must be
    ``per_step`` times the steps plus ``once`` (launches outside the
    steps), losses finite and every weight moved from ``init`` (flat
    weights; default the runner's seed-42 initialisation). The run
    directory is ``out`` when given (and kept), else a temporary one. The
    returned fields add the run's metric rows."""
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
    init = init or t5.flatten_params(t5.init_params(
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
    emit(phase, **fields)
    if not (launches == want and finite and changed == len(init)
            and weights_finite):
        raise AssertionError(f"{phase} {case}: {fields}")
    return {**fields, "rows": rows}


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
    ||on - off|| / ||off||. The plain route must launch no kernel but
    the embedding's backward (E1), as often as the kernels' route."""
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
    if not (used_on == want_on
            and used_off == _per_step(embed_grad=want_on["embed_grad"])
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
                         gemm=3 * layers, embed_grad=EMBED)
    # the run directory stays for phase 8's evaluation, its HF export for
    # phase 10
    run = _train_run(smi, "cli.train.main", dict(TRAIN_PRESET,
                                                 export_hf=True), per_step,
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
                               gemm=5 * layers, embed_grad=EMBED)
    default = _train_run(smi, "default_runconfig_dots_nobatch",
                         DEFAULT_PRESET, per_step_remat)
    remat = _remat_ab(smi, "L188", _train_cfg(True), 160, B_TRAIN,
                      N_NEG_TRAIN, REMAT_POLICIES, per_step, per_step_remat)
    # dense attention: no attention kernel runs
    dropout = _train_run(smi, "dropout_multisteps", DROPOUT_PRESET,
                         _per_step(embed_grad=EMBED))
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
                         core_bwd_k2b=layers * MB512,
                         embed_grad=EMBED * MB512)
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
                                core_bwd_k2b=layers * MB512,
                                embed_grad=EMBED * MB512),
                      fwd_bwd=False, microbatches=MB512,
                      grad_accum_dtype="bf16")
    # L 768: K2a (the resident estimate fails the 48 MiB gate), one
    # microbatch: K1 and K2a once per encoder layer a step, K2b never
    per_step768 = _per_step(attention=layers, core_bwd_k2a=layers,
                            embed_grad=EMBED)
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
                         * MB512, gemm=3 * layers * MB512,
                         embed_grad=EMBED * MB512)
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
                         gemm=3 * layers, mips_topk_int8=1,
                         embed_grad=EMBED)
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
    card = {}
    for label, int8_on in (("bf16", False), ("int8", True)):
        params, mcfg, tok, rc = load_run(run_dir, device="cuda")
        store = TokenizedStore.build(corpus, tok,
                                     max_q_tokens=rc.max_q_tokens,
                                     max_d_tokens=rc.max_d_tokens)
        rr = Reranker(params, mcfg, store, corpus, rel_id=tok.true_id,
                      nrel_id=tok.false_id, batch_size=len(q_rows) // 2,
                      int8=int8_on, device="cuda")
        card[label] = rr.score_pairs(q_rows, d_rows)
        del params, rr
    # the same pairs on the CPU (in the background; compared after phase 11)
    checks = {}

    def compare(ref: dict) -> None:
        for label, tol in (("bf16", SCORE_ATOL), ("int8", INT8_SCORE_ATOL)):
            err = float(np.abs(card[label] - ref["out"][label]).max())
            checks[label] = check(f"evaluate_{label}_scores_vs_cpu", err,
                                  tol, pairs=len(q_rows),
                                  cpu_seconds=ref["cpu_seconds"])

    CPU_REFERENCE.submit("evaluate_pairs", "eval_scores", compare,
                         run_dir=run_dir, corpus=corpus, q_rows=q_rows,
                         d_rows=d_rows)
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
                     gemm=3 * layers, embed_grad=EMBED)
    # meta-cheap: four forwards (K3 4 x 12), two backwards (K4 2 x 12; E1
    # for pos and for neg)
    cheap = _per_step(attention=4 * layers, attention_bwd=2 * layers,
                      gemm=8 * layers + 2 * layers, embed_grad=2 * EMBED)
    # meta-std, dense: E1 for pos and for neg in each of its three
    # backwards (the inner gradient, the outer one through the virtual
    # step, the main step's)
    std = _per_step(embed_grad=3 * 2 * EMBED)
    runs = {name: _curriculum_run(smi, name, per) for name, per in (
        ("interp", pair), ("level", pair), ("eta", pair),
        ("contrast", pair), ("meta-cheap", cheap), ("meta-std", std))}
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
                        _per_step(embed_grad=cheap["embed_grad"]))
    # meta-std under RunConfig's default remat (the selective checkpoint
    # saving the projections' products) against remat off, dense
    std_remat = _meta_ab(
        smi, "meta_std_dots_nobatch_vs_remat_off", "std",
        dataclasses.replace(_train_cfg(False), remat=True,
                            remat_policy="dots_nobatch"),
        _train_cfg(False), std, std)
    fd = _meta_std_fd_check(smi)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in COUNTED}
    return {"runs": runs, "step1": step1, "profile": profile,
            "meta_cheap_ab": cheap_ab, "meta_std_remat": std_remat,
            "meta_std_fd": fd, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 10: model-scored negatives, HF checkpoints, SPLADE pools
# ---------------------------------------------------------------------------

# 10a: phase 5's preset with 64 model-scored candidates a pair, at the
# runner's default chunk of 1,024 rows (16 x 64: one scoring call a step);
# then 2 steps scoring through the W8A8 forward with a bf16 stream
SCORED_C, SCORED_STEPS, SCORED_INT8_STEPS = 64, 4, 2
SCORED_PRESET = dict(TRAIN_PRESET, scored_pool=SCORED_C,
                     total_steps=B_TRAIN * SCORED_STEPS)
SCORED_CHECK_PAIRS = 2  # the card against the CPU on 2 x 64 candidates
# 10b: the JAX bench's fused_scored (bench.py:1172-1192, corpus :95-105):
# 256 candidates of pools of 1,000 on a lognormal packed corpus, scored in
# chunks of 256 rows at bucket widths 64/96/128/160 (188 for the longest),
# chunked attention at 192, 4 microbatches, factored moments, bf16 carry
# and residual, no remat; 4 steps a run. Its matched control ref_varlen
# (bench.py:1194-1199, bench_reference_style :253-450): the reference's
# step on the same corpus, every prompt padded to the 188-token budget.
FS_C, FS_POOL, FS_STEPS, FS_MB = 256, 1000, 4, 4
FS_BUCKETS, FS_CHUNK, FS_ATTN_CHUNK = (64, 96, 128, 160), 256, 192
REF_STEPS = 4
# 10c: build_pools --method splade on phase 5's run over phase 8's corpus
SPLADE_TERMS, SPLADE_BATCH, SPLADE_CUTOFF, SPLADE_CHECK_DOCS = 128, 64, 100, 8
# Tolerances. The bf16 forward's bound of the card against the CPU
# (SCORE_ATOL: bf16 rounding flips accumulated over 12 + 12 layers) holds:
# - bucketed against full-width scores on the card: a masked forward is
#   padding-invariant, but at another width the products run at other
#   shapes (cuBLAS and K3 pick other tiles and summation orders);
# - SPLADE activations log1p(relu(h E^T / sqrt(d))), card against CPU: the
#   bf16 encoder output h carries those flips; the fp32 vocab product adds
#   nothing comparable.
# int8_bf16 candidate scores, card against CPU: each side's W8A8 forward
# lies within the int8 scorer's own noise of its bf16 forward (0.03, the
# JAX package's bound, tests/test_quant.py), and the two bf16 forwards
# within SCORE_ATOL of each other. The forward is not continuous (a bf16
# rounding flip in the stream flips int8 codes downstream), so nothing
# tighter holds; a fault (a wrong scale, a transposed weight) moves the
# scores by their spread, O(0.3) at these random weights.
INT8_NOISE = 0.03
INT8_BF16_SCORE_ATOL = SCORE_ATOL + 2 * INT8_NOISE
BUCKET_SCORE_ATOL = SPLADE_ACT_ATOL = SCORE_ATOL


def _scored_per_step(layers: int, scoring_chunks: int = 1,
                     microbatches: int = 1) -> dict:
    """Launches of one scored-pool step on the kernels' route: each scoring
    chunk K3 once per encoder layer (GEMM 2 a layer: q|k|v concatenated at
    its use), each microbatch K3 and K4 once per encoder layer (GEMM 3 a
    layer, E1 2 times); the decoder's attention takes the plain route."""
    return _per_step(attention=layers * (scoring_chunks + microbatches),
                     attention_bwd=layers * microbatches,
                     gemm=layers * (2 * scoring_chunks + 3 * microbatches),
                     embed_grad=EMBED * microbatches)


def _scored_cli(smi: str, layers: int) -> dict:
    """10a through ``cli.train.main``: launches as predicted, finite
    losses, every weight moved, ``neg_scored`` = 16 x (64 + 7) a step."""
    run = _train_run(smi, "scored_pool_64", SCORED_PRESET,
                     _scored_per_step(layers), phase="scored")
    want_neg = B_TRAIN * (SCORED_C + N_NEG_TRAIN)
    neg = [r["neg_scored"] for r in run["rows"] if "neg_scored" in r]
    fields = dict(case="scored_pool_64", neg_scored=neg,
                  expected_neg_scored=want_neg,
                  neg_scored_per_s=want_neg * run["steps_per_s"],
                  pool_score_spread=[r["pool_score_spread"]
                                     for r in run["rows"]
                                     if "pool_score_spread" in r],
                  neg_rank_static=[r["neg_rank_static"] for r in run["rows"]
                                   if "neg_rank_static" in r])
    emit("scored", **fields)
    if neg != [want_neg] * SCORED_STEPS:
        raise AssertionError(f"scored: {fields}")
    # scoring through torch._int_mm: only the train pass launches kernels
    int8 = _train_run(smi, "scored_pool_64_int8_bf16",
                      dict(SCORED_PRESET, scored_pool_dtype="int8_bf16",
                           total_steps=B_TRAIN * SCORED_INT8_STEPS),
                      _scored_per_step(layers, scoring_chunks=0),
                      phase="scored")
    return {"run": {**run, **fields}, "int8_bf16": int8}


def _scored_vs_cpu() -> dict:
    """The first step's candidates of 10a's first pairs (pair rows 0 and 1
    of the unshuffled stream, the runner's seed-42 weights, 64 balanced
    slots of each pool) scored on the card and by the port on the CPU (in
    the background; compared after phase 11): bf16 (K3 on the card, its
    plain version on the CPU) and int8_bf16."""
    tok = HashTokenizer(vocab_size=32128)
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100,
                                     seed=42)
    dc = DeviceCorpus.build(store, triples, device="cuda")
    cfg = _train_cfg(True)
    params = t5.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(42), "cuda")
    pairs = torch.arange(SCORED_CHECK_PAIRS, device="cuda")
    slots = torch.from_numpy(balanced_slots(100, SCORED_C)).cuda().long()
    ids, mask = dc.assemble(dc.query_rows[pairs].repeat_interleave(SCORED_C),
                            dc.pools[pairs][:, slots].reshape(-1))
    kw = dict(rel_id=tok.true_id, nrel_id=tok.false_id)
    card = {label: s.cpu().view(SCORED_CHECK_PAIRS, SCORED_C) for label, s
            in _candidate_scores(params, cfg, ids, mask, **kw).items()}
    out = {}

    def compare(ref: dict) -> None:
        for label, tol in (("bf16", SCORE_ATOL),
                           ("int8_bf16", INT8_BF16_SCORE_ATOL)):
            cpu = ref["out"][label].view(SCORED_CHECK_PAIRS, SCORED_C)
            same_order = int((torch.argsort(card[label], dim=1, stable=True)
                              == torch.argsort(cpu, dim=1, stable=True))
                             .sum())
            out[label] = check(f"scored_candidates_{label}_vs_cpu",
                               max_abs(card[label], cpu), tol,
                               rows=SCORED_CHECK_PAIRS * SCORED_C,
                               same_order_positions=same_order,
                               score_std=card[label].std().item(),
                               cpu_seconds=ref["cpu_seconds"])

    CPU_REFERENCE.submit("scored_candidates", "candidate_scores", compare,
                         params=t5.tree_map(lambda t: t.cpu(), params),
                         cfg=cfg, ids=ids.cpu(), mask=mask.cpu(), **kw)
    # as information: the int8 scorer's own noise on these rows
    out["int8_bf16_vs_bf16_on_card"] = max_abs(card["int8_bf16"],
                                               card["bf16"])
    emit("scored", check="int8_bf16_vs_bf16_on_card",
         max_abs_diff=out["int8_bf16_vs_bf16_on_card"])
    return out


def _lognormal_corpus() -> TextCorpus:
    """The bench's variable-length corpus (bench.py:95-115): doc word
    counts lognormal(4.0, 0.45) clipped to [12, 150], queries of 4-11
    words, from one generator of seed 7."""
    rng = np.random.default_rng(7)
    d_lens = np.clip(rng.lognormal(mean=4.0, sigma=0.45, size=2048)
                     .astype(int), 12, 150)
    words = [f"w{i}" for i in range(500)]
    return TextCorpus(
        [f"d{i}" for i in range(2048)],
        [" ".join(rng.choice(words, size=k)) for k in d_lens],
        [f"q{i}" for i in range(256)],
        [" ".join(rng.choice(words, size=k))
         for k in rng.integers(4, 12, size=256)],
    )


def _fs_cfg(kernels: bool) -> t5.T5Config:
    """fused_scored's model: chunked attention at 192, bf16 residual, no
    remat; with ``kernels`` flash_v3 + fused_qkv (K3 / K4 take the encoder's
    self-attention, the decoder's stays on the plain chunked route)."""
    return dataclasses.replace(
        t5.T5Config.base(), dtype=torch.bfloat16, attention_impl="chunked",
        attention_chunk=FS_ATTN_CHUNK, attn_residual_dtype="bf16",
        flash_v3=kernels, fused_qkv=kernels)


def _bucketed_vs_full(cfg: t5.T5Config, params: dict, dc, tok,
                      pair_idx: torch.Tensor) -> dict:
    """One step's B x 256 candidates scored by ``score_candidates`` at the
    full width and with the buckets, both in chunks of 256 rows: max |diff|
    and how many candidates' places in their pair's order move."""
    slots = torch.from_numpy(balanced_slots(dc.n_neg, FS_C)).cuda().long()
    B = pair_idx.shape[0]
    ids, mask = dc.assemble(dc.query_rows[pair_idx].repeat_interleave(FS_C),
                            dc.pools[pair_idx][:, slots].reshape(-1))
    fn = lambda i, m: score_batch(params, cfg, i, m, rel_id=tok.true_id,
                                  nrel_id=tok.false_id)
    full = score_candidates(fn, ids, mask, chunk_rows=FS_CHUNK).view(B, FS_C)
    bkt = score_candidates(fn, ids, mask, chunk_rows=FS_CHUNK,
                           buckets=FS_BUCKETS, packed=True).view(B, FS_C)
    moved = int((torch.argsort(full, dim=1, stable=True)
                 != torch.argsort(bkt, dim=1, stable=True)).sum())
    # candidate pairs (i, j) of one query that the two orders rank apart
    sf = torch.sign(full[:, :, None] - full[:, None, :])
    sb = torch.sign(bkt[:, :, None] - bkt[:, None, :])
    discordant = int((sf != sb).sum()) // 2
    lengths = torch.sort(mask.sum(dim=1)).values.view(-1, FS_CHUNK)
    longest = lengths.amax(dim=1).tolist()
    ladder = [b for b in FS_BUCKETS if b < ids.shape[1]] + [ids.shape[1]]
    widths = [min(b for b in ladder if b >= n) for n in longest]
    return dict(max_abs_err=max_abs(full, bkt), tol=BUCKET_SCORE_ATOL,
                rows=B * FS_C, order_positions_moved=moved,
                discordant_candidate_pairs=discordant,
                chunk_widths=widths, full_width=ids.shape[1],
                mean_true_prompt_len=mask.sum(dim=1).float().mean().item(),
                score_std=full.std().item())


def _fused_scored_run(smi: str, label: str, kernels: bool, env: tuple,
                      per_step: dict) -> dict:
    """fused_scored through ``make_scored_pool_step`` for FS_STEPS steps on
    the bench's index draws (with the kernels, then one step under
    ``torch.profiler``: device-busy ms, idle share, ``aten`` ops): launches,
    finite losses, every weight moved, ``neg_scored`` = 16 x (256 + 7),
    steps/s, negatives scored/s; then one step's candidates bucketed
    against full width."""
    tok, dc, params = env
    cfg = _fs_cfg(kernels)
    total = FS_STEPS * 3
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=10,
                         total_steps=total,
                         ce_scale=2.0 * float(np.log(cfg.vocab_size)))
    tx = make_optimizer(1e-3, total_steps=total, moments="factored")
    step = make_train_step(cfg, ctrl, tx, loss="lce",
                           n_neg_per_example=N_NEG_TRAIN,
                           rel_id=tok.true_id, nrel_id=tok.false_id,
                           microbatches=FS_MB, grad_accum_dtype="bf16")
    fused = make_scored_pool_step(
        dc, step, ctrl, cfg, n_neg_per_example=N_NEG_TRAIN, candidates=FS_C,
        rel_id=tok.true_id, nrel_id=tok.false_id, score_chunk_rows=FS_CHUNK,
        score_buckets=FS_BUCKETS)
    state = init_train_state(params, tx, ctrl.init("cuda"))
    rng = np.random.default_rng(0)  # the bench's index draws (bench.py:217)
    idx = [torch.from_numpy(rng.integers(0, dc.num_pairs, size=B_TRAIN))
           .cuda() for _ in range(FS_STEPS + 1)]
    torch.cuda.synchronize()
    _zero_launches()
    losses, times, neg = [], [], []
    for i in range(FS_STEPS):
        t0 = time.perf_counter()
        state, metrics = fused(state, idx[i])
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
        neg.append(metrics["neg_scored"].item())
    profiled = {}
    if kernels:
        state, busy, aten = _profiled_step(fused, state, idx[FS_STEPS])
        profiled = dict(busy_ms=busy, aten_ops_per_step=aten,
                        idle_share=1.0 - busy / (statistics.median(times[1:])
                                                 * 1e3))
    torch.cuda.synchronize()
    launches = _launches()
    want = {k: n * (FS_STEPS + bool(profiled)) for k, n in per_step.items()}
    init, final = t5.flatten_params(params), t5.flatten_params(state.params)
    changed = sum(not torch.equal(final[k], init[k]) for k in init)
    finite = bool(np.isfinite(losses).all()) and all(
        torch.isfinite(v).all().item() for v in final.values())
    del state, fused, step
    step_s = statistics.median(times[1:])
    per_neg = B_TRAIN * (FS_C + N_NEG_TRAIN)
    bucketed = _bucketed_vs_full(cfg, params, dc, tok, idx[0])
    fields = dict(
        case=label, kernels=kernels, steps=FS_STEPS, losses=losses,
        step_s=times, steps_per_s=1.0 / step_s,
        neg_scored=neg, expected_neg_scored=per_neg,
        neg_scored_per_s=per_neg / step_s,
        trained_negatives_per_s=B_TRAIN * N_NEG_TRAIN / step_s, **profiled,
        launches=launches, expected_launches=want,
        leaves_changed=changed, leaves=len(init), finite=finite,
        bucketed_vs_full=bucketed, nvidia_smi=smi)
    emit("scored", **fields)
    if not (launches == want and finite and changed == len(init)
            and neg == [per_neg] * FS_STEPS
            and bucketed["max_abs_err"] <= BUCKET_SCORE_ATOL):
        raise AssertionError(f"fused_scored {label}: {fields}")
    return fields


def _ref_varlen(smi: str, tok, corpus, store, triples, params) -> dict:
    """The matched control: the reference's step (bench_reference_style)
    on the lognormal corpus. A host batch a step (the paced binomial PMF,
    one draw per example, the prompt strings tokenized and padded to the
    188-token budget), two no-grad forwards for the eta update, then two
    forwards with gradients, AdamW; the runner's default remat
    (dots_nobatch), dense attention, no hand kernel."""
    import scipy.stats

    from pacednegatives_tpu_torch.curriculum.base import StepSignals
    from pacednegatives_tpu_torch.data.tokenizer import pad_batch
    from pacednegatives_tpu_torch.ops.losses import lce_ce, token_ce
    from pacednegatives_tpu_torch.optim import apply_updates

    cfg = dataclasses.replace(t5.T5Config.base(), dtype=torch.bfloat16,
                              remat=True, remat_policy="dots_nobatch")
    n, B, P, L = N_NEG_TRAIN, B_TRAIN, triples.n_neg, store.prompt_len
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=10,
                         total_steps=REF_STEPS * 3,
                         ce_scale=2.0 * float(np.log(cfg.vocab_size)))
    tx = make_optimizer(1e-3, total_steps=REF_STEPS * 3)
    state = init_train_state(params, tx, ctrl.init("cuda"))
    rng = np.random.default_rng(0)
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.int64)).cuda()
    prompt = lambda q, d: (f"Query: {corpus.query_texts[q]} Document: "
                           f"{corpus.doc_texts[d]} Relevant:")

    def host_batch(difficulty: float) -> dict:
        pair_idx = rng.integers(0, len(triples), size=B)
        pmf = scipy.stats.binom.pmf(np.arange(P), P - 1,
                                    np.clip(difficulty, 1e-10, 1 - 1e-10))
        pmf = pmf / pmf.sum()
        neg = np.stack([triples.pools[i][rng.choice(P, size=n, replace=False,
                                                    p=pmf)]
                        for i in pair_idx])
        q = triples.query_rows[pair_idx]
        enc = lambda qs, ds: pad_batch([tok.encode(prompt(a, b), add_eos=True)
                                        for a, b in zip(qs, ds)], L,
                                       tok.pad_id)
        pos_ids, pos_mask = enc(q, triples.pos_rows[pair_idx])
        neg_ids, neg_mask = enc(np.repeat(q, n), neg.reshape(-1))
        return {"pos_ids": cuda(pos_ids), "pos_mask": cuda(pos_mask),
                "pos_labels": cuda(store.labels(B, True)),
                "neg_ids": cuda(neg_ids), "neg_mask": cuda(neg_mask),
                "neg_labels": cuda(store.labels(B * n, False))}

    def ce(params, side, batch):
        logits = t5.forward_logits(params, cfg, batch[f"{side}_ids"],
                                   batch[f"{side}_labels"],
                                   batch[f"{side}_mask"])
        return token_ce(logits, batch[f"{side}_labels"])

    def one_step(state):
        batch = host_batch(float(ctrl.difficulty(state.curriculum)))
        with torch.no_grad():
            c = lce_ce(ce(state.params, "pos", batch),
                       ce(state.params, "neg", batch), n, True)
        curriculum = ctrl.update(state.curriculum, StepSignals(
            pce=c, nce=c, ce=c, success=torch.zeros_like(c)))
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in t5.flatten_params(state.params).items()}
        with torch.enable_grad():
            p = t5.unflatten_params(leaves)
            loss = lce_ce(ce(p, "pos", batch), ce(p, "neg", batch), n,
                          True).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = tx.update(
            t5.unflatten_params(dict(zip(leaves, grads))), state.opt_state,
            state.params)
        return state._replace(params=apply_updates(state.params, updates),
                              opt_state=opt_state, curriculum=curriculum,
                              step=state.step + 1), loss.item()

    torch.cuda.synchronize()
    _zero_launches()
    state, first = one_step(state)  # warm-up, as the bench's
    t0 = time.perf_counter()
    losses = []
    for _ in range(REF_STEPS):
        state, loss = one_step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    sps = REF_STEPS / (time.perf_counter() - t0)
    launches = _launches()
    # E1 for pos and for neg in each step's backward, the warm-up's too
    want = _per_step(embed_grad=2 * EMBED * (REF_STEPS + 1))
    fields = dict(case="ref_varlen", steps=REF_STEPS, losses=[first, *losses],
                  steps_per_s=sps, neg_scored_per_s=sps * B * n,
                  prompt_len=L, launches=launches,
                  expected_launches=want, nvidia_smi=smi)
    emit("scored", **fields)
    if launches != want or not np.isfinite(fields["losses"]).all():
        raise AssertionError(f"ref_varlen: {fields}")
    return fields


def _fused_scored(smi: str, layers: int) -> dict:
    """10b: fused_scored as the bench runs it (no hand kernel), again with
    flash_v3 + fused_qkv (K3 at the bucket widths), and ref_varlen."""
    tok = HashTokenizer(vocab_size=32128)
    corpus = _lognormal_corpus()
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=FS_POOL,
                                     seed=1)
    dc = DeviceCorpus.build(store, triples, device="cuda", packed=True)
    params = t5.init_params(t5.T5Config.base(),
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    env = (tok, dc, params)
    chunks = B_TRAIN * FS_C // FS_CHUNK
    plain = _fused_scored_run(smi, "fused_scored", False, env,
                              _per_step(embed_grad=EMBED * FS_MB))
    kern = _fused_scored_run(smi, "fused_scored_flash_v3", True, env,
                             _scored_per_step(layers, chunks, FS_MB))
    ref = _ref_varlen(smi, tok, corpus, store, triples, params)
    multiple = {label: r["neg_scored_per_s"] / ref["neg_scored_per_s"]
                for label, r in (("plain", plain), ("flash_v3", kern))}
    # ref_varlen pads every row to the fixed budget, not to each batch's
    # longest row: the multiples are upper bounds
    emit("scored", check="neg_scored_per_s_over_ref_varlen",
         upper_bound=True, **multiple)
    return {"plain": plain, "kernels": kern, "ref_varlen": ref,
            "multiple_upper_bound": multiple}


def _hf_and_splade(smi: str, layers: int, run_dir: str) -> dict:
    """10c: phase 5's ``--export_hf`` directory read back (every leaf equal
    to the final checkpoint's), ``cli.train.main --model <that dir>`` for 2
    steps (ce_scale 1.0), and ``cli.build_pools.main --method splade`` on
    phase 5's run over phase 8's corpus (K3 once per encoder layer per
    batch of 64 docs of L 160; the queries, L 24, sit below the fused
    block's 64-token gate and take the dense route), the first docs'
    activations and top terms against the port on the CPU."""
    export = os.path.join(run_dir, "model")
    params, mcfg, tok, rc = load_run(run_dir, device="cuda")
    hf_params, hf_cfg = load_hf_checkpoint(export, device="cuda")
    trained, read = t5.flatten_params(params), t5.flatten_params(hf_params)
    fields = dict(case="export_hf_read_back", leaves=len(read),
                  equal=set(trained) == set(read) and all(
                      torch.equal(trained[k], read[k]) for k in trained),
                  config_equal=all(getattr(hf_cfg, f) == getattr(mcfg, f)
                                   for f in ("vocab_size", "d_model", "d_kv",
                                             "d_ff", "num_heads",
                                             "num_layers",
                                             "num_decoder_layers",
                                             "tie_word_embeddings",
                                             "gated_ffn")),
                  files=sorted(os.listdir(export)))
    emit("scored", **fields)
    if not (fields["equal"] and fields["config_equal"]):
        raise AssertionError(f"export_hf: {fields}")
    hf_run = _train_run(smi, "from_hf_export",
                        dict(TRAIN_PRESET, model=export,
                             total_steps=B_TRAIN * 2),
                        _per_step(attention=layers, attention_bwd=layers,
                                  gemm=3 * layers, embed_grad=EMBED),
                        init=read, phase="scored")
    ce_scale = [r["ce_scale"] for r in hf_run["rows"] if "ce_scale" in r]
    emit("scored", case="from_hf_export", ce_scale=ce_scale)
    if ce_scale != [1.0]:
        raise AssertionError(f"from_hf_export: ce_scale {ce_scale}")
    del hf_params, read

    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=0,
                                  doc_len=150, query_len=12)
    batches = -(-corpus.num_docs // SPLADE_BATCH)
    want = _per_step(attention=layers * batches, gemm=2 * layers * batches)
    with tempfile.TemporaryDirectory() as tmp:
        docs, queries = (os.path.join(tmp, f) for f in ("docs.tsv",
                                                        "queries.tsv"))
        _write_tsv(docs, corpus.doc_ids, corpus.doc_texts)
        _write_tsv(queries, corpus.query_ids, corpus.query_texts)
        out = os.path.join(tmp, "pools_splade.jsonl")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        build_pools_main(["--method", "splade", "--run", run_dir, "--docs",
                          docs, "--queries", queries, "--out", out,
                          "--cutoff", str(SPLADE_CUTOFF), "--splade_terms",
                          str(SPLADE_TERMS), "--encode_batch",
                          str(SPLADE_BATCH), "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
        with open(out) as f:
            pools = [json.loads(line) for line in f]
    # the first docs' activations, the card against the CPU
    store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                 max_d_tokens=rc.max_d_tokens)
    ids = torch.from_numpy(store.d_tokens[:SPLADE_CHECK_DOCS]).long()
    mask = torch.from_numpy(store.d_mask[:SPLADE_CHECK_DOCS])
    card = splade_activations(params, mcfg, ids.cuda(), mask.cuda()).cpu()
    cpu = splade_activations(t5.tree_map(lambda t: t.cpu(), params), mcfg,
                             ids, mask)
    err = max_abs(card, cpu)
    (cw, ct), (pw, pt) = (topk_stable(a, SPLADE_TERMS) for a in (card, cpu))
    # a term in one top-k and not the other must sit within the tolerance
    # of the other's k-th weight
    outside, same = 0, []
    for r in range(SPLADE_CHECK_DOCS):
        on_card, on_cpu = set(ct[r].tolist()), set(pt[r].tolist())
        outside += sum(int(cpu[r, t] < pw[r, -1] - SPLADE_ACT_ATOL)
                       for t in on_card - on_cpu)
        outside += sum(int(card[r, t] < cw[r, -1] - SPLADE_ACT_ATOL)
                       for t in on_cpu - on_card)
        same.append(len(on_card & on_cpu))
    splade = dict(case="build_pools_splade", seconds=seconds,
                  launches=launches, expected_launches=want,
                  pools=len(pools), queries=corpus.num_queries,
                  cutoff=SPLADE_CUTOFF, terms=SPLADE_TERMS,
                  activations_vs_cpu_max_abs_err=err, tol=SPLADE_ACT_ATOL,
                  topk_terms_shared=same, topk_swaps_beyond_tol=outside,
                  nonzero_terms_per_doc=(card > 0).sum(dim=1).tolist(),
                  nvidia_smi=smi)
    emit("scored", **splade)
    if launches != want or err > SPLADE_ACT_ATOL or outside:
        raise AssertionError(f"build_pools splade: {splade}")
    return {"export": fields, "hf_run": hf_run, "splade": splade}


def phase_scored(smi: str, run_dir: str) -> dict:
    """Phase 10: K3 at the bucket widths and the SPLADE query length; the
    scored pool through ``cli.train.main`` (bf16 and int8_bf16 scoring),
    its candidates against the CPU; the JAX bench's fused_scored with and
    without the kernels beside ref_varlen; the HF export read back and
    trained from; SPLADE pools."""
    layers = t5.T5Config.base().num_layers
    emit("scored", config="t5-base", vocab=32128, dtype="bfloat16",
         candidates=SCORED_C, fused_scored_candidates=FS_C,
         buckets=list(FS_BUCKETS), score_chunk=FS_CHUNK)
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(10)
    k3 = {"W64": _check_k3(g, "bucket_W64", FS_CHUNK, 64),
          "W160": _check_k3(g, "bucket_W160", FS_CHUNK, 160),
          "L24": _check_k3(g, "splade_query_L24", SPLADE_BATCH, 24)}
    cli = _scored_cli(smi, layers)
    vs_cpu = _scored_vs_cpu()
    fs = _fused_scored(smi, layers)
    hf = _hf_and_splade(smi, layers, run_dir)
    emit("scored", seconds=time.perf_counter() - t0)
    return {"k3": k3, "cli": cli, "vs_cpu": vs_cpu, "fused_scored": fs,
            **hf, "launches": {
                "scored": cli["run"]["launches"],
                "scored_int8_bf16": cli["int8_bf16"]["launches"],
                "fused_scored": fs["plain"]["launches"],
                "fused_scored_flash_v3": fs["kernels"]["launches"],
                "ref_varlen": fs["ref_varlen"]["launches"],
                "from_hf_export": hf["hf_run"]["launches"],
                "build_pools_splade": hf["splade"]["launches"]}}


# ---------------------------------------------------------------------------
# Phase 11: distillation
# ---------------------------------------------------------------------------

# phase 8's corpus with the first judged positive of each query (doc d is
# relevant to query d % 256): 256 pairs, one mined negative each, from the
# fused top 1000 of five lexical pipelines
DISTILL_BUDGET = 1000
DISTILL_BATCH, DISTILL_STEPS, DISTILL_CE_STEPS = 16, 6, 2
# the kernel step: DISTILL_STEPS timed, then DISTILL_TRACED under the trace
DISTILL_TRACED = 2
# the hand kernels' CUDA functions a flash_v3 training step runs: K3's two
# GEMMs and its core, K4's GEMM and its two backward passes
DISTILL_TRACE_KERNELS = ("gemm_bf16_kernel", "t5_attention_fwd_kernel",
                         "dq_kernel", "dkdv_kernel")
# Step 1 under MarginMSE, each bf16 route against the dense route in fp32:
# a CPU rehearsal (scripts/torch_distill_step_rehearsal.py: the kernels'
# plain versions, 32 prompts of L 188, random weights) at width 128 / 2 + 2
# layers gave the dense bf16 route per-leaf
# ||bf16 - fp32|| / ||fp32|| of max 0.107 and median 0.052, the kernel
# route 0.142 and 0.066 (1.33x, 1.27x); at width 256 / 4 + 4 layers 0.363
# and 0.103 against 0.413 and 0.112 (1.14x, 1.09x); in fp32 the two routes
# agree to 5e-6. The kernel route may lie within twice the dense route's
# distance, on the worst leaf and the median; a routing or gradient fault
# is O(1) on the leaves it touches. (CE, without the margin's cancellation,
# gave 0.03-0.05 against each other, inside the LCE step's gates.)
DISTILL_MARGIN_NOISE = 2.0


def _distill_files(tmp: str) -> dict:
    """Write phase 8's corpus and the pairs, then mine the triples and score
    them under the lexical teachers through the port's CLIs, twice: host
    code, so the second run must write the same bytes."""
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=0,
                                  doc_len=150, query_len=12)
    files = {k: os.path.join(tmp, f"{k}.tsv")
             for k in ("docs", "queries", "pairs")}
    _write_tsv(files["docs"], corpus.doc_ids, corpus.doc_texts)
    _write_tsv(files["queries"], corpus.query_ids, corpus.query_texts)
    with open(files["pairs"], "w") as f:
        f.writelines(f"q{q}\td{q}\n" for q in range(corpus.num_queries))
    outs, seconds = [], []
    for run in (1, 2):
        triples = os.path.join(tmp, f"triples_{run}.tsv")
        teacher = os.path.join(tmp, f"teacher_{run}.json")
        t0 = time.perf_counter()
        mine_main(["--docs", files["docs"], "--queries", files["queries"],
                   "--pairs", files["pairs"], "--out", triples,
                   "--budget", str(DISTILL_BUDGET)])
        t1 = time.perf_counter()
        teacher_main(["--docs", files["docs"], "--queries", files["queries"],
                      "--triples", triples, "--out", teacher])
        seconds.append({"mine_negatives_s": t1 - t0,
                        "teacher_scores_s": time.perf_counter() - t1})
        with open(triples, "rb") as f1, open(teacher, "rb") as f2:
            outs.append((f1.read(), f2.read()))
    same = outs[0] == outs[1]
    ts = TeacherScores.load(os.path.join(tmp, "teacher_1.json"))
    fields = dict(pairs=corpus.num_queries, budget=DISTILL_BUDGET,
                  triples=outs[0][0].count(b"\n") - 1,
                  teachers=ts.num_teachers, runs=seconds,
                  native_bm25=bm25._lib() is not None, bytes_equal=same)
    emit("distill", check="mine_and_teacher_scores", **fields)
    if not (same and fields["triples"] == corpus.num_queries
            and ts.num_teachers == 6):
        raise AssertionError(f"distill mining / teacher scores: {fields}")
    files.update(triples=os.path.join(tmp, "triples_1.tsv"),
                 teacher=os.path.join(tmp, "teacher_1.json"))
    return fields | {"files": files}


@contextlib.contextmanager
def _timed_distill_steps(times: list, losses: list, shapes: list):
    """Time each step the CLI's ``make_distill_step`` builds (synchronised;
    the step copies its batch to the card); keep its loss and its prompts'
    shape."""
    saved = distill_pkg.make_distill_step

    def make(*args, **kw):
        step = saved(*args, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            shapes.append(tuple(batch["ids"].shape))
            return state, metrics

        return timed

    distill_pkg.make_distill_step = make
    try:
        yield
    finally:
        distill_pkg.make_distill_step = saved


def _distill_cli(smi: str, files: dict, objective: str, steps: int,
                 tmp: str) -> dict:
    """``cli.distill.main`` at t5-base on the card, counted: no hand kernel
    but E1 (its config is dense with remat ``dots``), finite losses, every weight
    moved from the CLI's seed-0 initialisation but those MarginMSE leaves
    no gradient."""
    out = os.path.join(tmp, f"distill_{objective}")
    times, losses, shapes = [], [], []
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    with _timed_distill_steps(times, losses, shapes):
        summary = distill_main([
            "--docs", files["docs"], "--queries", files["queries"],
            "--triples", files["triples"], "--teacher", files["teacher"],
            "--model", "base", "--vocab_size", "32128",
            "--objective", objective, "--batch_size", str(DISTILL_BATCH),
            "--total_steps", str(DISTILL_BATCH * steps), "--out_dir", out,
            "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    final = torch.load(os.path.join(out, "final", CHECKPOINT_FILE),
                       map_location="cuda", weights_only=True)["params"]
    init = t5.flatten_params(t5.init_params(
        t5.T5Config.base(), torch.Generator(device="cuda").manual_seed(0),
        "cuda"))
    unchanged = sorted(k for k in init if torch.equal(final[k], init[k]))
    # MarginMSE reads the first label position alone, which attends to
    # itself alone in the decoder: a softmax over one key, so the decoder
    # self-attention's q, k and rel_bias get an exact zero gradient there
    frozen = sorted(k for k in init if objective == "margin_mse"
                    and k.startswith("decoder.") and ".self_attn." in k
                    and k.rsplit(".", 1)[1] in ("q", "k", "rel_bias"))
    step_ms = statistics.median(times[1:])
    fields = dict(
        case=f"cli_{objective}", steps=summary["steps"], seconds=seconds,
        prompts_per_step=shapes[0][0], prompt_len=shapes[0][1],
        step_ms_all=times, median_step_ms_2_on=step_ms,
        pairs_per_s=DISTILL_BATCH / (step_ms / 1e3), losses=losses,
        launches=launches, leaves_changed=len(init) - len(unchanged),
        leaves=len(init), leaves_unchanged=unchanged,
        expected_unchanged=frozen, nvidia_smi=smi)
    emit("distill", **fields)
    if not (summary["steps"] == steps == len(losses)
            and set(shapes) == {(2 * DISTILL_BATCH, shapes[0][1])}
            and np.isfinite(losses).all() and unchanged == frozen
            and launches == _per_step(embed_grad=EMBED * steps)):
        raise AssertionError(f"distill cli {objective}: {fields}")
    return fields


def _mu_rel(a: dict, b: dict) -> dict:
    """Per leaf ||a - b|| / ||b|| over b's nonzero leaves: max, its leaf,
    median."""
    rel = {k: ((a[k] - b[k]).norm() / b[k].norm()).item()
           for k in b if b[k].norm() > 0}
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "worst_leaf": worst,
            "median": statistics.median(rel.values()), "leaves": len(rel)}


def _distill_ab(smi: str, params: dict, batch: dict, tok, per_step: dict
                ) -> dict:
    """Step 1 of ``make_distill_step`` with the kernels (flash_v3 +
    fused_qkv, bf16) against the dense route (bf16) on the same weights and
    batch, and for MarginMSE both against the dense route in fp32; AdamW's
    first moment after it (0.1 x the clipped gradient, lr(0) = 0) leaf by
    leaf. CE is held to the LCE step's gates. MarginMSE's gradient is a
    difference of two prompts' nearly equal gradients at random weights,
    so bf16 rounding alone moves it by much more (DISTILL_MARGIN_NOISE):
    the kernel route must lie within a factor of the dense bf16 route's own
    distance from fp32."""
    out = {}
    for objective in ("margin_mse", "ce"):
        runs = {}
        cases = [("kernels", _train_cfg(True)), ("dense", _train_cfg(False))]
        if objective == "margin_mse":
            cases.append(("dense_fp32", dataclasses.replace(
                _train_cfg(False), dtype=torch.float32)))
        for label, cfg in cases:
            tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
            step = make_distill_step(cfg, tx, objective, rel_id=tok.true_id,
                                     nrel_id=tok.false_id)
            before = _launches()
            state, metrics = step(init_distill_state(params, tx), batch)
            torch.cuda.synchronize()
            used = {k: v - before[k] for k, v in _launches().items()}
            runs[label] = (metrics["loss"].item(),
                           t5.flatten_params(state.opt_state.mu), used)
            del state
        loss = {label: r[0] for label, r in runs.items()}
        loss_rel = abs(loss["kernels"] - loss["dense"]) / abs(loss["dense"])
        vs_dense = _mu_rel(runs["kernels"][1], runs["dense"][1])
        fields = dict(
            case=f"step1_distill_{objective}_flash_v3_vs_dense",
            losses=loss, loss_rel_err=loss_rel, loss_tol=STEP_LOSS_RTOL,
            grad_rel_l2_max=vs_dense["max"],
            grad_rel_l2_worst_leaf=vs_dense["worst_leaf"],
            grad_rel_l2_median=vs_dense["median"], leaves=vs_dense["leaves"],
            launches={label: r[2] for label, r in runs.items()},
            expected_launches_kernels=per_step, nvidia_smi=smi)
        ok = (runs["kernels"][2] == per_step and loss_rel <= STEP_LOSS_RTOL
              and all(r[2] == _per_step(embed_grad=EMBED)
                      for label, r in runs.items() if label != "kernels"))
        if objective == "ce":
            fields.update(grad_tol=STEP_GRAD_REL_L2,
                          grad_median_tol=STEP_GRAD_REL_L2_MEDIAN)
            ok = ok and (vs_dense["max"] <= STEP_GRAD_REL_L2
                         and vs_dense["median"] <= STEP_GRAD_REL_L2_MEDIAN)
        else:
            ref = runs["dense_fp32"][1]
            kern = _mu_rel(runs["kernels"][1], ref)
            floor = _mu_rel(runs["dense"][1], ref)
            fields.update(kernels_vs_fp32=kern, dense_vs_fp32=floor,
                          noise_factor=DISTILL_MARGIN_NOISE)
            ok = ok and (kern["max"] <= DISTILL_MARGIN_NOISE * floor["max"]
                         and kern["median"]
                         <= DISTILL_MARGIN_NOISE * floor["median"])
        emit("distill", **fields)
        if not ok:
            raise AssertionError(f"distill step 1 {objective}: {fields}")
        out[objective] = fields
    return out


def _distill_kernel_steps(smi: str, params: dict, batcher, tok,
                          per_step: dict, tmp: str) -> dict:
    """The kernel step on the triples' batches in turn: DISTILL_STEPS timed
    (synchronised), then DISTILL_TRACED under ``utils.profiling.trace``,
    whose trace file must name the hand kernels' CUDA functions; launches
    counted over all of them. The idle share is the traced steps' device
    busy time over the untraced steps' median (the profiler slows the
    host several times over)."""
    cfg = _train_cfg(True)
    tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
    step = make_distill_step(cfg, tx, "margin_mse", rel_id=tok.true_id,
                             nrel_id=tok.false_id)
    state = init_distill_state(params, tx)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                batcher.get_batch(i % batcher.num_batches).items()}
               for i in range(DISTILL_STEPS + DISTILL_TRACED)]
    log_dir = os.path.join(tmp, "trace")
    torch.cuda.synchronize()
    _zero_launches()
    times, losses = [], []
    for batch in batches[:DISTILL_STEPS]:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    t0 = time.perf_counter()
    with profiling.trace(log_dir) as prof:
        for batch in batches[DISTILL_STEPS:]:
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3 / DISTILL_TRACED
    launches = _launches()
    steps = DISTILL_STEPS + DISTILL_TRACED
    want = {k: n * steps for k, n in per_step.items()}
    (trace_file,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, trace_file)) as f:
        text = f.read()
    named = {name: name in text for name in DISTILL_TRACE_KERNELS}
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    step_ms = statistics.median(times[1:])
    rows = batches[0]["ids"].shape
    fields = dict(
        case="flash_v3_step", steps=steps, prompts_per_step=rows[0],
        prompt_len=rows[1], step_ms_all=times, median_step_ms_2_on=step_ms,
        pairs_per_s=DISTILL_BATCH / (step_ms / 1e3), losses=losses,
        traced_step_ms=traced_ms, busy_ms=busy / DISTILL_TRACED,
        idle_share=1.0 - busy / DISTILL_TRACED / step_ms,
        trace_file=trace_file, trace_mib=len(text) / 2**20,
        trace_names_kernels=named, launches=launches,
        expected_launches=want, nvidia_smi=smi)
    emit("distill", **fields)
    if not (launches == want and all(named.values())
            and np.isfinite(losses).all()):
        raise AssertionError(f"distill kernel steps: {fields}")
    return fields


def _distill_debug_nans(params: dict, batch: dict, tok) -> dict:
    """``debug_nans`` around a dense step: a clean batch passes, a batch
    with one NaN teacher score raises ``FloatingPointError``."""
    tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
    step = make_distill_step(_train_cfg(False), tx, "margin_mse",
                             rel_id=tok.true_id, nrel_id=tok.false_id)
    t0 = time.perf_counter()
    with profiling.debug_nans():
        _, metrics = step(init_distill_state(params, tx), batch)
    clean_s = time.perf_counter() - t0
    bad = dict(batch, teachers=batch["teachers"].clone())
    bad["teachers"][0, 0] = float("nan")
    raised = None
    with profiling.debug_nans():
        try:
            step(init_distill_state(params, tx), bad)
        except FloatingPointError as e:
            raised = str(e)
    fields = dict(check="debug_nans", clean_loss=metrics["loss"].item(),
                  clean_step_s=clean_s, nan_batch_raised=raised)
    emit("distill", **fields)
    if raised is None or not np.isfinite(fields["clean_loss"]):
        raise AssertionError(f"debug_nans: {fields}")
    return fields


def phase_distill(smi: str) -> dict:
    """Phase 11: mining and teacher scores (host CLIs), ``cli.distill.main``
    at t5-base for MarginMSE and CE, the kernel step against dense, timed
    and traced, ``debug_nans``, ``cost_analysis`` and MFU."""
    layers = t5.T5Config.base().num_layers
    emit("distill", config="t5-base", vocab=32128, dtype="bfloat16",
         batch=DISTILL_BATCH, steps=DISTILL_STEPS, ce_steps=DISTILL_CE_STEPS)
    t_phase = time.perf_counter()
    # the distill step with flash_v3: K3 and K4 once per encoder layer;
    # GEMMs 2 + 1 a layer
    per_step = _per_step(attention=layers, attention_bwd=layers,
                         gemm=3 * layers, embed_grad=EMBED)
    with tempfile.TemporaryDirectory() as tmp:
        mined = _distill_files(tmp)
        files = mined.pop("files")
        cli = {"margin_mse": _distill_cli(smi, files, "margin_mse",
                                          DISTILL_STEPS, tmp),
               "ce": _distill_cli(smi, files, "ce", DISTILL_CE_STEPS, tmp)}
        tok = HashTokenizer(vocab_size=32128)
        corpus = TextCorpus.from_tsv(files["docs"], files["queries"])
        store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                     max_d_tokens=160)
        batcher = TeacherBatcher(load_triples_tsv(files["triples"]), corpus,
                                 store, TeacherScores.load(files["teacher"]),
                                 DISTILL_BATCH)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in batcher.get_batch(0).items()}
        params = t5.init_params(t5.T5Config.base(),
                                torch.Generator(device="cuda").manual_seed(0),
                                "cuda")
        ab = _distill_ab(smi, params, batch, tok, per_step)
        kern = _distill_kernel_steps(smi, params, batcher, tok, per_step,
                                     tmp)
    nans = _distill_debug_nans(params, batch, tok)

    # the dispatched ops' count of one dense forward beside the analytic
    # model FLOPs; MFU of the steps on the card's bf16 peak
    dense = _train_cfg(False)
    n, L = batch["ids"].shape
    with torch.no_grad():
        cost = profiling.cost_analysis(t5.forward_logits, params, dense,
                                       batch["ids"], batch["labels"],
                                       batch["mask"])
    model_fwd = profiling.t5_forward_flops(dense, n, L, 2)
    peak = profiling.device_peak_flops()

    def mfu(r: dict) -> float | None:
        flops = profiling.t5_step_flops(dense, r["prompts_per_step"],
                                        r["prompt_len"], 2)
        return (None if peak is None
                else flops / (r["median_step_ms_2_on"] / 1e3) / peak)

    fields = dict(
        check="cost_and_mfu", forward_counted_flops=cost["flops"],
        forward_bytes_accessed_unfused=cost["bytes_accessed"],
        forward_model_flops=model_fwd,
        counted_over_model=cost["flops"] / model_fwd, peak_flops=peak,
        mfu_flash_v3_step=mfu(kern),
        mfu_cli_margin_mse=mfu(cli["margin_mse"]),
        nvidia_smi=smi)
    emit("distill", **fields)
    emit("distill", seconds=time.perf_counter() - t_phase)
    return {"mined": mined, "cli": cli, "step1": ab, "kernels": kern,
            "debug_nans": nans, "cost": fields, "launches": {
                "distill_cli": {k: cli["margin_mse"]["launches"][k]
                                + cli["ce"]["launches"][k] for k in COUNTED},
                "distill_flash_v3": kern["launches"]}}


# ---------------------------------------------------------------------------
# Phase 12: more than one rank, and the overlapped refresh
# ---------------------------------------------------------------------------

# The ranks' step: phase 5's preset (t5-base, bf16, flash_v3 + fused_qkv)
# on pairs 0..15, every rank drawing the negatives with a generator seeded
# PARALLEL_SEED; held against one process's step at phase 5's gates (the
# split moves bf16 roundings: rows per GEMM, the gradient's sum order).
PARALLEL_SEED = 5
# (b) the ranks share the one card over gloo: 4 for dp2 x seq2 negative
# parallelism, then 2 of them for dp2 and the 2-shard K6 index
RANKS_TIMEOUT_S = 420
# (c) the overlapped refresh over phase 7b's corpus and int8 index: a
# window of OVERLAP_WINDOW_STEPS online steps beside one refresh (serial:
# the steps, then the refresh), and a profiled window of
# OVERLAP_TRACED_STEPS; the loop's swap with a refresh every 2 steps,
# chunks of 1 and a delay of 1 chunk, over OVERLAP_LOOP_STEPS
OVERLAP_WINDOW_STEPS = 8
OVERLAP_TRACED_STEPS = 3
OVERLAP_LOOP_STEPS = 4
# start() enqueues the params' snapshot and hands the encode to a thread:
# its host time is a small part of the refresh's
START_FRACTION_MAX = 0.1
REFRESH_KERNEL = "t5_attention_fwd_kernel"
MAIN_KERNELS = ("t5_attention_fwd_kernel", "dq_kernel", "dkdv_kernel",
                "mips_scores_kernel", "topk_segments_kernel")


def _rank_step(env: tuple, mesh=None, negative_parallel: bool = False):
    """One fused LCE step of phase 5's preset on pairs 0..15, under
    ``mesh`` when given: (loss, flat AdamW first moment, launches)."""
    cfg, tok, dc, params, ctrl = env
    # no clipping: the first moment is then 0.1 x the global gradient, and
    # a gradient off by a factor (the world size) shows in it
    tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1, grad_clip=None)
    step = _make_step(cfg, tok, ctrl, tx, N_NEG_TRAIN)
    fused = make_fused_step(dc, step, ctrl, loss="lce",
                            n_neg_per_example=N_NEG_TRAIN,
                            negative_parallel=negative_parallel)
    state = init_train_state(params, tx, ctrl.init("cuda"),
                             seed=PARALLEL_SEED)
    torch.cuda.synchronize()
    before = _launches()
    with mesh if mesh is not None else contextlib.nullcontext():
        state, metrics = fused(state, torch.arange(B_TRAIN, device="cuda"))
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in _launches().items()}
    return metrics["loss"].item(), t5.flatten_params(state.opt_state.mu), used


def _vs_one_process(got: tuple, ref: tuple) -> dict:
    """Loss relative error and per-leaf ||mu - mu_ref|| / ||mu_ref|| (the
    first moment is 0.1 x the unclipped gradient after step 1)."""
    (loss, mu), (ref_loss, ref_mu) = got, ref
    rel = {k: ((mu[k] - ref_mu[k]).norm() / ref_mu[k].norm()).item()
           for k in ref_mu if ref_mu[k].norm() > 0}
    worst = max(rel, key=rel.get)
    return dict(loss=loss, loss_one_process=ref_loss,
                loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
                grad_rel_l2_median=statistics.median(rel.values()),
                bitwise=loss == ref_loss and all(
                    torch.equal(mu[k], ref_mu[k]) for k in ref_mu))


def _parallel_env() -> tuple:
    cfg = _train_cfg(True)
    tok, dc, params, ctrl, _ = _step_env(cfg, 160, B_TRAIN, N_NEG_TRAIN)
    return cfg, tok, dc, params, ctrl


def _k6_case(seed: int = 7):
    """Phase 7b's K6 call (16 queries, 16,384 unit docs, k 65, blocks of
    4096, k' 32) as fp32 docs for DenseIndex.build and the queries."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, N, D, k, block_n, kpb = K6_ONLINE
    return _unit_rows(g, N, D), _unit_rows(g, B, D)


def _k6_topk(docs, q, mesh=None):
    B, N, D, k, block_n, kpb = K6_ONLINE
    index = DenseIndex.build(docs, method="pallas", mesh=mesh, quantize=True,
                             device="cuda", block_n=block_n, k_per_block=kpb)
    return index.topk(q, k)


def _parallel_rank(work: str, rank: int, backend: str, worlds: list) -> None:
    """One rank of phase 12 (b) / (d), in a process of its own (``python3
    chip_smoke.py --parallel-rank ...``): for each world size in turn (4:
    a dp2 x seq2 mesh; 2: dp2 and the 2-shard K6 index) it
    joins a group of that many ranks and runs its case; rank 0 then runs
    the one-process step and top-k and holds the ranks' results against
    them. Writes ``<work>/rank<rank>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels.library()  # the parent built it: loaded, not rebuilt
    env = _parallel_env()
    out, kept = {"rank": rank, "backend": backend}, {}
    for world in worlds:
        if rank >= world:
            break
        maybe_initialize_distributed(
            f"file://{os.path.join(work, f'rendezvous{world}')}", world,
            rank, backend=backend, device="cuda",
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S // 2))
        try:
            shape = MeshConfig(data=2, seq=2) if world == 4 else MeshConfig(
                data=2)
            mesh = create_mesh(shape, "cuda")
            case = "dp2_seq2_negative_parallel" if world == 4 else "dp2"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, mu, used = _rank_step(env, mesh, world == 4)
            seconds = time.perf_counter() - t0
            sums = torch.stack([v.double().sum() for v in mu.values()]
                               + [torch.tensor(loss, dtype=torch.float64,
                                               device="cuda")])
            every = gather_batch(sums[None], mesh)
            out[case] = dict(
                world=world, launches=used, step_s=seconds,
                same_state_on_every_rank=bool((every == every[0]).all()),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)
            kept[case] = (loss, mu)
            if world == 2:
                docs, q = _k6_case()
                torch.cuda.synchronize()
                before = _launches()
                kept["index"] = _k6_topk(docs, q, mesh)
                torch.cuda.synchronize()
                out["index"] = {"launches": {k: v - before[k] for k, v in
                                             _launches().items()}}
        finally:
            torch.distributed.destroy_process_group()
    if rank == 0:
        loss, mu, _ = _rank_step(env)
        for case in ("dp2_seq2_negative_parallel", "dp2"):
            if case in kept:
                out[case].update(_vs_one_process(kept[case], (loss, mu)))
        if "index" in kept:
            docs, q = _k6_case()
            ref = _k6_topk(docs, q)
            index = quantize_embeddings(docs)
            out["index"].update(_topk_agreement(q, index, kept["index"], ref,
                                                mips_tol(K6_ONLINE[2])))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn_ranks(work: str, backend: str, worlds: list,
                 flag: str = "--parallel-rank") -> list[dict]:
    """Start ``max(worlds)`` rank processes of this script (``flag``:
    phase 12's or phase 13's) and wait for them (killed if they outlive
    RANKS_TIMEOUT_S); their results."""
    here = os.path.dirname(os.path.abspath(__file__))
    n = max(worlds)
    cmd = lambda r: [sys.executable, os.path.abspath(__file__),
                     flag, str(r), work, backend,
                     ",".join(map(str, worlds))]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(cmd(r), cwd=here, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for r, p in enumerate(procs):
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"parallel rank {r} ({backend}) exit "
                                     f"{p.returncode}:\n{err[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _check_ranks(smi: str, label: str, ranks: list[dict]) -> dict:
    """(b) / (d): each case within phase 5's gates of one process, the same
    state on every rank, K3 = K4 = 12 (GEMM 36, E1 2) on every rank, the
    2-shard K6 top-k one process's up to near-tie swaps."""
    per_step = _per_step(attention=12, attention_bwd=12, gemm=36,
                         embed_grad=EMBED)
    fields = {"case": label, "nvidia_smi": smi}
    ok = True
    for case in ("dp2_seq2_negative_parallel", "dp2"):
        if case not in ranks[0]:
            continue
        r0 = ranks[0][case]
        held = [r[case] for r in ranks if case in r]
        fields[case] = {
            **{k: r0[k] for k in ("world", "loss", "loss_one_process",
                                  "loss_rel_err", "grad_rel_l2_max",
                                  "grad_rel_l2_worst_leaf",
                                  "grad_rel_l2_median", "bitwise")},
            "launches_per_rank": [h["launches"] for h in held],
            "peak_mib_per_rank": [h["peak_mib"] for h in held],
            "step_s_per_rank": [h["step_s"] for h in held]}
        ok &= (r0["loss_rel_err"] <= STEP_LOSS_RTOL
               and r0["grad_rel_l2_max"] <= STEP_GRAD_REL_L2
               and r0["grad_rel_l2_median"] <= STEP_GRAD_REL_L2_MEDIAN
               and all(h["same_state_on_every_rank"] for h in held)
               and all(h["launches"] == per_step for h in held))
    index = ranks[0]["index"]
    fields["index_2_shards"] = {
        **index, "launches_per_rank": [r["index"]["launches"]
                                       for r in ranks if "index" in r]}
    tol = mips_tol(K6_ONLINE[2])
    ok &= (index["max_abs_err"] <= tol and index["swap_err"] <= tol
           and all(r["index"]["launches"] == _per_step(mips_topk_int8=1)
                   for r in ranks if "index" in r))
    emit("parallel", **fields)
    if not ok:
        raise AssertionError(f"parallel {label}: {fields}")
    launches = [r[case]["launches"] for r in ranks
                for case in ("dp2_seq2_negative_parallel", "dp2", "index")
                if case in r]
    return {**fields, "launches": {k: sum(u[k] for u in launches)
                                   for k in COUNTED}}


def _overlap_env() -> tuple:
    """Phase 7b's online setting at phase 5's preset: 16,384 synthetic docs,
    an int8 index, pools of 64, encode batches of 128; t5-base weights
    from seed 0; the online step of 16 pairs x (1 + 7)."""
    cfg = _train_cfg(True)
    tok = HashTokenizer(vocab_size=32128)
    corpus = TextCorpus.synthetic(num_docs=K6_ONLINE[1], num_queries=256,
                                  seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100,
                                     seed=42)
    dc = DeviceCorpus.build(store, triples, device="cuda")
    params = t5.init_params(cfg,
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    mining = OnlineMiningConfig(pool_size=K6_ONLINE[3] - 1, encode_batch=128,
                                quantize=True)
    return cfg, tok, dc, params, mining


def _online_step(env: tuple, steps: int):
    cfg, tok, dc, params, mining = env
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=steps, kind="lce",
                         objective="weighted_ce", optimizer="adamw",
                         clamp=False,
                         ce_scale=(1 + N_NEG_TRAIN) * float(np.log(32128)))
    tx = make_optimizer(1e-3, total_steps=steps, warmup_steps=1)
    step = _make_step(cfg, tok, ctrl, tx, N_NEG_TRAIN)
    fused = make_online_fused_step(dc, step, ctrl, cfg, mining, N_NEG_TRAIN)
    return fused, init_train_state(params, tx, ctrl.init("cuda"), seed=3)


def _index_sum(index: tuple) -> float:
    vals, scales = index
    return float(vals.to(torch.int64).sum().item()) + scales.sum().item()


def _swap_at_boundary(env: tuple, refresher) -> dict:
    """OnlineMiningLoop, serial and overlapped (a refresh every 2 steps,
    chunks of 1, delay 1 chunk): the overlapped loop must use the first
    index one step longer and then the serial loop's second index."""
    cfg, tok, dc, params, mining = env
    runs = {}
    for label, overlap in (("serial", None), ("overlapped", refresher)):
        fused, state = _online_step(env, OVERLAP_LOOP_STEPS)

        def counted(carry, idx, corpus):
            carry, m = fused(carry, idx, corpus)
            return carry, {**m, "index_sum": torch.tensor(
                _index_sum(carry[1]))}

        loop = OnlineMiningLoop(
            fused_step=counted, refresh_fn=make_refresh_fn(dc, cfg, mining),
            num_pairs=dc.num_pairs, batch_size=B_TRAIN, chunk_size=1,
            refresh_every=2, log_mode="all", corpus=dc, overlap=overlap,
            overlap_delay_chunks=1)
        writer = MetricWriter(None)
        loop.run(state, OVERLAP_LOOP_STEPS, writer)
        runs[label] = {r["step"]: r["index_sum"] for r in writer.history
                       if "index_sum" in r}
    s, o = runs["serial"], runs["overlapped"]
    ok = (s[1] == s[2] == o[1] == o[2] == o[3] and s[3] != s[2]
          and o[4] == s[3] == s[4])
    return {"index_sum_serial": s, "index_sum_overlapped": o,
            "swap_at_boundary": ok}


def _trace_overlap(log_dir: str) -> dict:
    """From the profiled window's trace: the stream that ran most of the
    refresh kernel (K1, the fused block's core) is the side stream, the
    one that ran K4 the main one; the time during which a side-stream K1
    overlapped a main-stream hand kernel (K3's core, K4, K6)."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    by_stream = {}
    for e in events:
        by_stream.setdefault(e["args"]["stream"], []).append(e)
    count = lambda s, key: sum(key in e["name"] for e in by_stream[s])
    side = max(by_stream, key=lambda s: count(s, REFRESH_KERNEL))
    main = max(by_stream, key=lambda s: count(s, "dq_kernel"))
    spans = lambda s, keys: sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in by_stream[s]
        if any(k in e["name"] for k in keys))
    side_k1 = spans(side, (REFRESH_KERNEL,))
    main_k = spans(main, MAIN_KERNELS)
    overlap_us, j = 0.0, 0
    for a0, a1 in side_k1:
        while j < len(main_k) and main_k[j][1] <= a0:
            j += 1
        for b0, b1 in main_k[j:]:
            if b0 >= a1:
                break
            overlap_us += min(a1, b1) - max(a0, b0)
    busy = lambda s: sum(e["dur"] for e in by_stream[s]) / 1e3
    return {"side_stream": side, "main_stream": main,
            "own_stream": side != main,
            "side_k1_kernels": len(side_k1), "main_hand_kernels": len(main_k),
            "side_k1_ms": sum(b - a for a, b in side_k1) / 1e3,
            "side_busy_ms": busy(side), "main_busy_ms": busy(main),
            "k1_overlapping_main_ms": overlap_us / 1e3}


def _overlap_phase(smi: str, tmp: str) -> dict:
    """(c): the refresh on a side stream of the training card."""
    env = _overlap_env()
    cfg, tok, dc, params, mining = env
    layers = cfg.num_layers
    batches = -(-K6_ONLINE[1] // mining.encode_batch)
    refresh_once = {"attention": layers * batches,
                    "gemm": 2 * layers * batches}
    refresh = make_refresh_fn(dc, cfg, mining)
    refresher = OverlappedRefresher(dc, cfg, mining)
    try:
        # the slices: bit for bit the serial refresh with the same params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = refresh(params)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        _zero_launches()
        t0 = time.perf_counter()
        refresher.start(params)
        got = refresher.collect()
        torch.cuda.synchronize()
        side_s = time.perf_counter() - t0
        refresh_launches = _launches()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, serial))
        del got

        # a window of steps beside one refresh, against the steps then the
        # refresh; steps counted while the refresh thread still launched
        per_step = _per_step(attention=layers, attention_bwd=layers,
                             gemm=3 * layers, mips_topk_int8=1,
                             embed_grad=EMBED)
        idx = [torch.from_numpy(i.astype(np.int64)).cuda() for i, _ in zip(
            pair_index_stream(dc.num_pairs, B_TRAIN, 0),
            range(OVERLAP_WINDOW_STEPS))]
        fused, state = _online_step(env, OVERLAP_WINDOW_STEPS + 2)
        carry = (state, serial)
        carry, _ = fused(carry, idx[0], dc)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in idx:
            carry, _ = fused(carry, i, dc)
        refresh(carry[0].params)
        torch.cuda.synchronize()
        window_serial_s = time.perf_counter() - t0
        _zero_launches()
        t0 = time.perf_counter()
        refresher.start(carry[0].params)
        start_s = time.perf_counter() - t0
        during = 0
        for i in idx:
            carry, m = fused(carry, i, dc)
            during += refresher.launching
        refresher.collect()
        torch.cuda.synchronize()
        window_overlap_s = time.perf_counter() - t0
        window_launches = _launches()
        want = {k: n * OVERLAP_WINDOW_STEPS + refresh_once.get(k, 0)
                for k, n in per_step.items()}

        # one profiled window: does K1 on the side stream run beside the
        # main stream's kernels?
        log_dir = os.path.join(tmp, "overlap_trace")
        with profiling.trace(log_dir):
            refresher.start(carry[0].params)
            for i in idx[:OVERLAP_TRACED_STEPS]:
                carry, _ = fused(carry, i, dc)
            refresher.collect()
            torch.cuda.synchronize()
        traced = _trace_overlap(log_dir)
        swap = _swap_at_boundary(env, refresher)
    finally:
        refresher.close()
    fields = dict(
        case="overlapped_refresh_one_card", docs=K6_ONLINE[1],
        refresh_serial_s=serial_s, refresh_side_stream_s=side_s,
        slices_bitwise=bitwise, refresh_launches=refresh_launches,
        expected_refresh_launches=_per_step(**refresh_once),
        start_s=start_s, start_fraction=start_s / serial_s,
        start_fraction_max=START_FRACTION_MAX,
        window_steps=OVERLAP_WINDOW_STEPS,
        window_serial_s=window_serial_s, window_overlapped_s=window_overlap_s,
        steps_while_refresh_launching=during,
        window_launches=window_launches, expected_window_launches=want,
        trace=traced, **swap, nvidia_smi=smi)
    emit("parallel", **fields)
    if not (bitwise and swap["swap_at_boundary"] and traced["own_stream"]
            and start_s / serial_s <= START_FRACTION_MAX and during >= 1
            and refresh_launches == _per_step(**refresh_once)
            and window_launches == want):
        raise AssertionError(f"parallel overlap: {fields}")
    return {**fields, "launches": {k: refresh_launches[k] + window_launches[k]
                                   for k in COUNTED}}


def _world1_phase(smi: str, tmp: str) -> dict:
    """(a): NCCL at world 1 in this process: the step under a data=1 mesh
    and a one-shard K6 index, each bit for bit without the mesh."""
    maybe_initialize_distributed(f"file://{os.path.join(tmp, 'rdv1')}", 1,
                                 0, device="cuda")
    try:
        mesh = create_mesh(MeshConfig(data=1), "cuda")
        env = _parallel_env()
        plain_loss, plain_mu, _ = _rank_step(env)
        _zero_launches()
        loss, mu, used = _rank_step(env, mesh, negative_parallel=True)
        step = _vs_one_process((loss, mu), (plain_loss, plain_mu))
        docs, q = _k6_case()
        ref = _k6_topk(docs, q)
        torch.cuda.synchronize()
        before = _launches()
        got = _k6_topk(docs, q, mesh)
        torch.cuda.synchronize()
        index_used = {k: v - before[k] for k, v in _launches().items()}
        index_bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    want = _per_step(attention=12, attention_bwd=12, gemm=36,
                     embed_grad=EMBED)
    fields = dict(case="nccl_world1", backend=backend, **step,
                  launches=used, expected_launches=want,
                  index_bitwise=index_bitwise, index_launches=index_used,
                  nvidia_smi=smi)
    emit("parallel", **fields)
    if not (step["bitwise"] and used == want and index_bitwise
            and index_used == _per_step(mips_topk_int8=1)):
        raise AssertionError(f"parallel world 1: {fields}")
    return {**fields, "launches": {k: used[k] + index_used[k]
                                   for k in COUNTED}}


def phase_parallel(smi: str) -> dict:
    emit("parallel", config="t5-base", dtype="bfloat16",
         rows_per_step=ROWS_TRAIN, prompt_len=188)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        world1 = _world1_phase(smi, tmp)
        gloo_dir = os.path.join(tmp, "gloo")
        os.makedirs(gloo_dir)
        ranks = _check_ranks(smi, "gloo_one_card",
                             _spawn_ranks(gloo_dir, "gloo", [4, 2]))
        overlap = _overlap_phase(smi, tmp)
        if torch.cuda.device_count() >= 2:
            nccl_dir = os.path.join(tmp, "nccl")
            os.makedirs(nccl_dir)
            nccl2 = _check_ranks(smi, "nccl_world2",
                                 _spawn_ranks(nccl_dir, "nccl", [2]))
        else:
            nccl2 = "not run: 1 card"
            emit("parallel", nccl_world2=nccl2)
    seconds = time.perf_counter() - t_phase
    emit("parallel", seconds=seconds)
    return {"world1": world1, "ranks": ranks, "overlap": overlap,
            "nccl_world2": nccl2, "seconds": seconds,
            "launches": {"parallel_world1": world1["launches"],
                         "parallel_overlap": overlap["launches"]}}


# ---------------------------------------------------------------------------
# Phase 13: tensor parallelism
# ---------------------------------------------------------------------------

# t5-base split over 2 ranks: each holds 6 of the 12 heads, 1,536 of the
# 3,072 FFN columns and 16,064 of the 32,128 vocab rows. Prompts of 256
# tokens (24 query + 228 doc + 4 template) take the chunked attention
# kernels in 256-key chunks: K1 forward and K2b backward (the route of the
# model's 12 heads at L 256), 12 each a step on each rank.
TENSOR_PAIRS, TENSOR_NEG, TENSOR_STEPS = 8, 3, 2
TENSOR_ROWS = TENSOR_PAIRS * (1 + TENSOR_NEG)
TENSOR_MAX_D, TENSOR_L = 228, 256
TENSOR_HEADS = 6  # a tp2 rank's
# the online step's pools: 32 mined docs a query (K6 over a 1,024-doc
# shard of the 2,048-doc index, one block, 32 candidates a block)
TENSOR_POOL = 31


def _tensor_cfg() -> t5.T5Config:
    return _chunked_cfg(True, chunk=TENSOR_L, residual="fp32")


def _tensor_env() -> tuple:
    cfg = _tensor_cfg()
    tok, dc, params, ctrl, _ = _step_env(cfg, TENSOR_MAX_D, TENSOR_PAIRS,
                                         TENSOR_NEG)
    return cfg, tok, dc, params, ctrl


def _tensor_tx():
    # no clipping: step 1's first moment is 0.1 x the unclipped gradient
    return make_optimizer(1e-3, total_steps=8, warmup_steps=1,
                          grad_clip=None)


def _whole_flat(state, mesh) -> tuple:
    """(the whole state, its flat first moment): gathered over the model
    group under a mesh."""
    whole = state if mesh is None else gather_train_state(mesh, state)
    return whole, {k: v for k, v in
                   t5.flatten_params(whole.opt_state.mu).items()}


def _tensor_steps(env: tuple, mesh=None) -> dict:
    """``TENSOR_STEPS`` fused LCE steps on pairs 0..7 with the state split
    over ``mesh``'s model group: losses, step 1's whole first moment,
    launches and seconds a step, peak MiB, the leaves that moved."""
    cfg, tok, dc, params, ctrl = env
    tx = _tensor_tx()
    step = _make_step(cfg, tok, ctrl, tx, TENSOR_NEG)
    fused = make_fused_step(dc, step, ctrl, loss="lce",
                            n_neg_per_example=TENSOR_NEG)
    pairs = torch.arange(TENSOR_PAIRS, device="cuda")
    out = {"losses": [], "launches": [], "step_s": []}
    with mesh if mesh is not None else contextlib.nullcontext():
        state = init_train_state(params, tx, ctrl.init("cuda"),
                                 seed=PARALLEL_SEED)
        if mesh is not None:
            state = shard_train_state(mesh, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TENSOR_STEPS):
            before = _launches()
            t0 = time.perf_counter()
            state, metrics = fused(state, pairs)
            out["losses"].append(metrics["loss"].item())
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["launches"].append({k: v - before[k]
                                    for k, v in _launches().items()})
            if i == 0:
                _, out["mu1"] = _whole_flat(state, mesh)
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        whole, _ = _whole_flat(state, mesh)
    init = t5.flatten_params(params)
    final = t5.flatten_params(whole.params)
    out["moved"] = sum(not torch.equal(final[k], init[k]) for k in init)
    out["leaves"] = len(init)
    out["final"] = final
    return out


def _tensor_online(env: tuple, mesh=None) -> dict:
    """One online step on pairs 0..7: the int8 index refreshed with whole
    weights (gathered over the model group), then the step (the queries
    embedded split, K6 on this rank's shard, the merge, the split LCE
    step): its loss and launches."""
    cfg, tok, dc, params, ctrl = env
    tx = _tensor_tx()
    mining = OnlineMiningConfig(pool_size=TENSOR_POOL, encode_batch=128,
                                quantize=True)
    step = _make_step(cfg, tok, ctrl, tx, TENSOR_NEG)
    online = make_online_fused_step(dc, step, ctrl, cfg, mining, TENSOR_NEG)
    with mesh if mesh is not None else contextlib.nullcontext():
        state = init_train_state(params, tx, ctrl.init("cuda"),
                                 seed=PARALLEL_SEED)
        if mesh is not None:
            state = shard_train_state(mesh, state)
        index = make_refresh_fn(dc, cfg, mining)(encoder_weights(state, mesh))
        torch.cuda.synchronize()
        before = _launches()
        t0 = time.perf_counter()
        (state, _), metrics = online((state, index),
                                     torch.arange(TENSOR_PAIRS,
                                                  device="cuda"))
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = {k: v - before[k] for k, v in _launches().items()}
        _, mu = _whole_flat(state, mesh)
    return {"loss": loss, "launches": used, "step_s": seconds,
            "index_rows": index[0].shape[0], "mu": mu}


def _checksums(flat: dict, mesh) -> bool:
    """True if every rank of the model group holds the same tensors."""
    sums = torch.stack([v.double().sum() for v in flat.values()])
    every = gather_model(sums[None], 0, mesh)
    return bool((every == every[0]).all())


def _tensor_rank(work: str, rank: int, backend: str, worlds: list) -> None:
    """One rank of phase 13, in a process of its own (``python3
    chip_smoke.py --tensor-rank ...``): world 4, a dp2 x tp2 mesh and the
    online step; world 2, a dp1 x tp2 mesh and the fused steps; rank 0
    then runs both in one process and holds the ranks' results against
    them. Writes ``<work>/rank<rank>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels.library()  # the parent built it: loaded, not rebuilt
    env = _tensor_env()
    out, kept = {"rank": rank, "backend": backend}, {}
    for world in worlds:
        if rank >= world:
            break
        maybe_initialize_distributed(
            f"file://{os.path.join(work, f'rendezvous{world}')}", world,
            rank, backend=backend, device="cuda",
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S // 2))
        try:
            if world == 4:
                mesh = create_mesh(MeshConfig(data=2, model=2), "cuda")
                r = _tensor_online(env, mesh)
                kept["online"] = r
                out["online_dp2_tp2"] = dict(
                    world=world, loss=r["loss"], launches=r["launches"],
                    step_s=r["step_s"], index_rows=r["index_rows"],
                    same_state_on_every_rank=_checksums(r["mu"], mesh))
            else:
                mesh = create_mesh(MeshConfig(data=1, model=2), "cuda")
                r = _tensor_steps(env, mesh)
                kept["tp2"] = r
                out["tp2"] = dict(
                    world=world, losses=r["losses"], launches=r["launches"],
                    step_s=r["step_s"], peak_mib=r["peak_mib"],
                    moved=r["moved"], leaves=r["leaves"],
                    same_state_on_every_rank=_checksums(
                        {**r["final"], **{f"mu1.{k}": v
                                          for k, v in r["mu1"].items()}},
                        mesh))
        finally:
            torch.distributed.destroy_process_group()
    if rank == 0:
        if "tp2" in kept:
            ref = _tensor_steps(env)
            got = kept["tp2"]
            out["tp2"].update(
                _vs_one_process((got["losses"][0], got["mu1"]),
                                (ref["losses"][0], ref["mu1"])),
                losses_one_process=ref["losses"],
                loss2_rel_err=abs(got["losses"][1] - ref["losses"][1])
                / abs(ref["losses"][1]),
                launches_one_process=ref["launches"],
                peak_mib_one_process=ref["peak_mib"],
                step_s_one_process=ref["step_s"])
        if "online" in kept:
            ref = _tensor_online(env)
            got = kept["online"]
            out["online_dp2_tp2"].update(
                loss_one_process=ref["loss"],
                loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                launches_one_process=ref["launches"],
                step_s_one_process=ref["step_s"])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _check_tensor(smi: str, label: str, ranks: list[dict]) -> dict:
    """Each case against the one process (phase 5's gates: step 1's loss
    and per-leaf gradients; step 2's loss), the same state on every rank,
    K1 = K2b = 12 and E1 2 a step a rank (K6 once in the online step),
    every weight moved."""
    per_step = _per_step(attention=12, core_bwd_k2b=12, embed_grad=EMBED)
    fields = {"case": label, "nvidia_smi": smi}
    ok = True
    r0 = ranks[0]
    if "tp2" in r0:
        held = [r["tp2"] for r in ranks if "tp2" in r]
        tp = r0["tp2"]
        fields["tp2"] = {
            **{k: tp[k] for k in (
                "losses", "losses_one_process", "loss_rel_err",
                "loss2_rel_err", "grad_rel_l2_max", "grad_rel_l2_worst_leaf",
                "grad_rel_l2_median", "peak_mib_one_process",
                "step_s_one_process", "launches_one_process")},
            "launches_per_rank": [h["launches"] for h in held],
            "peak_mib_per_rank": [h["peak_mib"] for h in held],
            "step_s_per_rank": [h["step_s"] for h in held],
            "moved": [h["moved"] for h in held], "leaves": tp["leaves"]}
        ok &= (tp["loss_rel_err"] <= STEP_LOSS_RTOL
               and tp["loss2_rel_err"] <= STEP_LOSS_RTOL
               and tp["grad_rel_l2_max"] <= STEP_GRAD_REL_L2
               and tp["grad_rel_l2_median"] <= STEP_GRAD_REL_L2_MEDIAN
               and all(h["same_state_on_every_rank"] for h in held)
               and all(h["moved"] == h["leaves"] for h in held)
               and all(u == per_step for h in held for u in h["launches"])
               and all(u == per_step for u in tp["launches_one_process"]))
    if "online_dp2_tp2" in r0:
        held = [r["online_dp2_tp2"] for r in ranks]
        on = r0["online_dp2_tp2"]
        want = _per_step(attention=12, core_bwd_k2b=12, mips_topk_int8=1,
                         embed_grad=EMBED)
        fields["online_dp2_tp2"] = {
            **{k: on[k] for k in ("loss", "loss_one_process", "loss_rel_err",
                                  "launches_one_process",
                                  "step_s_one_process", "index_rows")},
            "launches_per_rank": [h["launches"] for h in held],
            "step_s_per_rank": [h["step_s"] for h in held]}
        ok &= (on["loss_rel_err"] <= STEP_LOSS_RTOL
               and all(h["same_state_on_every_rank"] for h in held)
               and all(h["launches"] == want for h in held)
               and on["launches_one_process"] == want)
    emit("tensor", **fields)
    if not ok:
        raise AssertionError(f"tensor {label}: {fields}")
    launches = [u for r in ranks for u in (
        r["tp2"]["launches"] if "tp2" in r else [])] + [
        r["online_dp2_tp2"]["launches"] for r in ranks
        if "online_dp2_tp2" in r]
    return {**fields, "launches": {k: sum(u[k] for u in launches)
                                   for k in COUNTED}}


def _check_k1_tensor(g) -> dict:
    """K1 as a tp2 rank calls it in the chunked path: its 6 heads of the
    step's 32 rows at L 256, fp32 output."""
    B, H, L, dk = TENSOR_ROWS, TENSOR_HEADS, TENSOR_L, 64
    q, k, v = (_randn(g, B, H, L, dk) for _ in range(3))
    pos = (torch.randn((H, L, L), generator=g, device="cuda")
           * 0.5).contiguous()
    km = _key_mask(g, B, L)
    ref, rm, rl = flash_attention_forward_plain(q, k, v, pos, km,
                                                torch.float32)
    o, m, l = flash_attention_forward(q, k, v, pos, km, torch.float32)
    check("attention_tp2_rank_m", max_abs(m, rm), 1e-3)
    check("attention_tp2_rank_l_rel", ((l - rl).abs() / rl).max().item(),
          1e-3)
    mask = (pos[None] + km[:, None, None, :]).to(torch.bfloat16)
    launch = lambda: flash_attention_forward(q, k, v, pos, km, torch.float32)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0)
    return check(
        "attention_tp2_rank_out", max_abs(o, ref), 2e-2, shape=[B, H, L, dk],
        ms=time_ms(launch), host_us=_host_us(launch),
        plain_ms=time_ms(lambda: flash_attention_forward_plain(
            q, k, v, pos, km, torch.float32)),
        library_ms=time_ms(library),
        # q, k, v in (bf16), out (fp32); pos, key mask in, (m, l) out
        **bound(3 * B * H * L * dk * 2 + B * H * L * dk * 4
                + H * L * L * 4 + B * L * 4 + 2 * B * H * L * 4,
                4 * B * H * L * L * dk, "bf16"))


def phase_tensor(smi: str) -> dict:
    emit("tensor", config="t5-base", dtype="bfloat16",
         rows_per_step=TENSOR_ROWS, prompt_len=TENSOR_L,
         heads_per_rank=TENSOR_HEADS, steps=TENSOR_STEPS)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(13)
    kernel_checks = {
        "k1": _check_k1_tensor(g),
        "k2b": _check_core_bwd(g, "k2b", TENSOR_ROWS, TENSOR_HEADS,
                               TENSOR_L, TENSOR_L, 64)}
    with tempfile.TemporaryDirectory() as tmp:
        gloo_dir = os.path.join(tmp, "gloo")
        os.makedirs(gloo_dir)
        ranks = _check_tensor(smi, "gloo_one_card", _spawn_ranks(
            gloo_dir, "gloo", [4, 2], flag="--tensor-rank"))
        if torch.cuda.device_count() >= 2:
            nccl_dir = os.path.join(tmp, "nccl")
            os.makedirs(nccl_dir)
            nccl2 = _check_tensor(smi, "nccl_world2", _spawn_ranks(
                nccl_dir, "nccl", [2], flag="--tensor-rank"))
        else:
            nccl2 = "not run: 1 card"
            emit("tensor", nccl_world2=nccl2)
    seconds = time.perf_counter() - t_phase
    emit("tensor", seconds=seconds)
    return {"kernels": kernel_checks, "ranks": ranks, "nccl_world2": nccl2,
            "seconds": seconds}


def _entry(name: str, source: str, replaces: str | None, launches: int,
           r: dict, **extra) -> dict:
    """One kernel of the final line, from its phase-3 or phase-7 check;
    ``replaces`` None for a kernel that no TPU kernel stands behind."""
    return {"name": name, "route": "cuda",
            "source": "pacednegatives_tpu_torch/csrc/" + source,
            "replaces": replaces and "pacednegatives_tpu/" + replaces,
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
    if sys.argv[1:2] == ["--cpu-job"]:
        # a job of the background CPU reference (CpuReference)
        _cpu_job(sys.argv[2])
        return 0
    if sys.argv[1:2] in (["--parallel-rank"], ["--tensor-rank"]):
        # a rank of phase 12 or 13, started by phase_parallel / _tensor
        rank, work, backend, worlds = sys.argv[2:6]
        run = (_parallel_rank if sys.argv[1] == "--parallel-rank"
               else _tensor_rank)
        run(work, int(rank), backend, [int(w) for w in worlds.split(",")])
        return 0
    t_start = time.perf_counter()
    device, smi = phase_device()
    phase_build()
    k = phase_kernels()
    eg = phase_embed_grad()
    mg = phase_moe_gemm()
    mo = phase_moonlight()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            s = phase_slice()
            run_dir = os.path.join(tmp, "run")
            tr = phase_train(smi, run_dir)
            ch = phase_chunked(smi)
            f512 = phase_fused512(smi)
            dn = phase_dense(smi)
            ev = phase_evaluate(smi, run_dir)
            cu = phase_curricula(smi)
            sc = phase_scored(smi, run_dir)
            di = phase_distill(smi)
            CPU_REFERENCE.finish()
    finally:
        CPU_REFERENCE.close()
    pa = phase_parallel(smi)
    te = phase_tensor(smi)
    dk = dn["kernels"]
    paths = {"serving": s["launches"], "train": tr["run"]["launches"],
             "moonlight_train": mo["launches"],
             "train_default_dots_nobatch": tr["default"]["launches"],
             "train_dropout_multisteps": tr["dropout"]["launches"],
             "fused512": f512["run"]["launches"],
             "chunked_512": ch["run"]["launches"],
             "chunked_768": ch["k2a_run"]["launches"],
             "online": dn["online"]["launches"],
             "build_pools": dn["build_pools"]["launches"],
             "evaluate": ev["bf16"]["launches"],
             "evaluate_int8": ev["int8"]["launches"],
             "curricula": cu["launches"], **sc["launches"],
             **di["launches"], **pa["launches"],
             "parallel_gloo_ranks": pa["ranks"]["launches"],
             "tensor_gloo_ranks": te["ranks"]["launches"]}
    if isinstance(pa["nccl_world2"], dict):
        paths["parallel_nccl_world2"] = pa["nccl_world2"]["launches"]
    if isinstance(te["nccl_world2"], dict):
        paths["tensor_nccl_world2"] = te["nccl_world2"]["launches"]
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
               tp2_rank=te["kernels"]["k1"],
               fused_self_attention=k["fused_self_attention"],
               fused_self_attention_bucket_W64=sc["k3"]["W64"],
               fused_self_attention_bucket_W160=sc["k3"]["W160"],
               fused_self_attention_splade_query_L24=sc["k3"]["L24"]),
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
               dk128=k["core_bwd"]["k2b_dk128"],
               tp2_rank=te["kernels"]["k2b"]),
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
        _entry("embed_grad", "embed_grad.cu", None, total["embed_grad"],
               eg["lce_b64_base"],
               replaces_note="no TPU kernel: pacednegatives_tpu/models/"
                             "t5.py:1368's emb[input_ids] is an XLA gather",
               **{key: eg["lce_b64_base"][key] for key in (
                   "unit", "pad_share", "bitwise_repeat", "library_row_ulps",
                   "index_put_ms", "index_put_row_ulps")},
               lce_b32_large=eg["lce_b32_large"],
               lce_b32_moonlight=eg["lce_b32_moonlight"]),
        _entry("moe_gemm", "moe_gemm.cu", None,
               total["grouped_gemm"] + total["grouped_wgrad"],
               mg["gate_up_fwd"],
               moonlight_launches_per_step={
                   key: mo["launches_per_step"][key] for key in (
                       "grouped_gemm", "grouped_wgrad", "embed_grad")},
               replaces_note="no TPU kernel: the JAX package has no expert "
                             "layer",
               **{case: r for case, r in mg.items() if case != "gate_up_fwd"}),
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
        "scored": {
            "cli": {key: sc["cli"]["run"][key] for key in (
                "steps_per_s", "neg_scored_per_s", "trained_negatives_per_s",
                "pool_score_spread")},
            "cli_int8_bf16_steps_per_s": sc["cli"]["int8_bf16"]["steps_per_s"],
            "candidates_vs_cpu_max_abs_err": {
                label: sc["vs_cpu"][label]["max_abs_err"]
                for label in ("bf16", "int8_bf16")},
            "candidates_int8_bf16_vs_bf16_on_card":
                sc["vs_cpu"]["int8_bf16_vs_bf16_on_card"],
            "fused_scored": {
                label: {key: r[key] for key in (
                    "steps_per_s", "neg_scored_per_s", "busy_ms",
                    "idle_share") if key in r}
                for label, r in sc["fused_scored"].items()
                if label != "multiple_upper_bound"},
            "bucketed_vs_full": {
                label: {key: sc["fused_scored"][label]["bucketed_vs_full"][
                    key] for key in ("max_abs_err", "order_positions_moved",
                                     "discordant_candidate_pairs")}
                for label in ("plain", "kernels")},
            "fused_scored_multiple_upper_bound":
                sc["fused_scored"]["multiple_upper_bound"],
            "export_hf_equal": sc["export"]["equal"],
            "splade": {key: sc["splade"][key] for key in (
                "seconds", "pools", "activations_vs_cpu_max_abs_err",
                "topk_terms_shared")}},
        "distill": {
            "mine_and_teacher_s": di["mined"]["runs"][0],
            **{f"cli_{obj}": {key: r[key] for key in (
                "median_step_ms_2_on", "pairs_per_s", "losses")}
               for obj, r in di["cli"].items()},
            "flash_v3_step": {key: di["kernels"][key] for key in (
                "median_step_ms_2_on", "pairs_per_s", "busy_ms",
                "idle_share")},
            **{f"step1_{obj}": {key: r[key] for key in (
                "loss_rel_err", "grad_rel_l2_max", "grad_rel_l2_median",
                "kernels_vs_fp32", "dense_vs_fp32") if key in r}
               for obj, r in di["step1"].items()},
            **{key: di["cost"][key] for key in (
                "counted_over_model", "mfu_flash_v3_step",
                "mfu_cli_margin_mse")}},
        "parallel": {
            "world1_nccl": {key: pa["world1"][key] for key in (
                "bitwise", "index_bitwise", "launches")},
            **{case: {key: pa["ranks"][case][key] for key in (
                "loss_rel_err", "grad_rel_l2_max", "grad_rel_l2_median",
                "peak_mib_per_rank", "step_s_per_rank")}
               for case in ("dp2_seq2_negative_parallel", "dp2")},
            "index_2_shards": {key: pa["ranks"]["index_2_shards"][key]
                               for key in ("max_abs_err", "near_tie_swaps")},
            "overlap": {key: pa["overlap"][key] for key in (
                "slices_bitwise", "swap_at_boundary", "refresh_serial_s",
                "refresh_side_stream_s", "start_fraction",
                "window_serial_s", "window_overlapped_s",
                "steps_while_refresh_launching")},
            "overlap_trace": pa["overlap"]["trace"],
            "nccl_world2": (pa["nccl_world2"]
                            if isinstance(pa["nccl_world2"], str) else
                            {case: pa["nccl_world2"][case]["loss_rel_err"]
                             for case in ("dp2",)}),
            "seconds": pa["seconds"]},
        "tensor": {
            **{case: {key: te["ranks"][case][key] for key in (
                "loss_rel_err", "grad_rel_l2_max", "grad_rel_l2_median",
                "loss2_rel_err", "peak_mib_per_rank", "step_s_per_rank",
                "peak_mib_one_process", "step_s_one_process")
                if key in te["ranks"][case]}
               for case in ("tp2", "online_dp2_tp2")},
            "nccl_world2": (te["nccl_world2"]
                            if isinstance(te["nccl_world2"], str) else
                            te["nccl_world2"]["tp2"]["loss_rel_err"]),
            "seconds": te["seconds"]},
        "seconds": time.perf_counter() - t_start,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

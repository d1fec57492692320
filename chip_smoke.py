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
             tolerance, median kernel and plain times; the fused block's
             backward (K4) also at L 512 / dk 128, and its dpos must be
             bitwise equal across two runs;
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
             weights and batch (loss and per-leaf gradients).

Then a JSON line with one entry per kernel, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
from pacednegatives_tpu_torch.cli.train import main as train_main
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.ops.flash import (
    NEG_INF,
    attention_backward,
    attention_backward_plain,
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
from pacednegatives_tpu_torch.ops.gemm import gemm, gemm_plain
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)
from pacednegatives_tpu_torch.train.loop import CHECKPOINT_FILE

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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, err: float, tol: float, **fields) -> dict:
    """Emit one comparison and fail the run if it is out of tolerance."""
    ok = err <= tol
    emit("kernels", check=name, max_abs_err=err, tol=tol, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{name}: max |diff| {err} > tolerance {tol}")
    return {"max_abs_err": err, **fields}


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

    # GEMM, at the two projections of one layer. Tolerance: both round an
    # fp32 sum to bf16; the sums differ only in order, so a result may
    # differ by one bf16 ulp, at most 2^-7 of |C|max.
    a = _randn(g, M, D)
    gemm_rows = {}
    for label, n, scale in (("qkv", 3 * inner, D**-0.5), ("o", D, inner**-0.5)):
        w = _randn(g, D if label == "qkv" else inner, n, scale=scale)
        ref = gemm_plain(a, w)
        err = max_abs(gemm(a, w), ref)
        tol = BF16_ULP_REL * ref.float().abs().max().item()
        gemm_rows[label] = check(
            f"gemm_{label}", err, tol, shape=[M, a.shape[1], n],
            ms=time_ms(lambda: gemm(a, w)),
            plain_ms=time_ms(lambda: gemm_plain(a, w)),
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
        check(f"attention_{label}_m", max_abs(m, rm), 1e-3)
        check(f"attention_{label}_l_rel",
              ((l - rl).abs() / rl).max().item(), 1e-3)
        # timed as the slice runs it: bf16 out, K3's layout
        out16 = torch.empty((B, L, Hc, d), dtype=torch.bfloat16, device="cuda")
        att[label] = check(
            f"attention_{label}_out", max_abs(o, ref), 2e-2,
            shape=[B, Hc, L, d],
            ms=time_ms(lambda: flash_attention_forward(
                q, k, v, pos, km, out=out16.transpose(1, 2))),
            plain_ms=time_ms(lambda: flash_attention_forward_plain(
                q, k, v, pos, km, out=out16.transpose(1, 2))),
        )
    results["attention"] = att

    # The fused block (K3) at the slice shape, T5-initialised weights and
    # unit-scale activations. Tolerance: y is rounded to bf16 once (one
    # ulp) on top of the attention outputs' own one-ulp flips carried
    # through Wo (~2^-8 relative): 2^-6 of |y|max covers both.
    x = _randn(g, B_SERVE, L_SERVE, D)
    wqkv = torch.cat([_randn(g, D, inner, scale=(D * dk) ** -0.5),
                      _randn(g, D, 2 * inner, scale=D**-0.5)], dim=1)
    wo = _randn(g, inner, D, scale=inner**-0.5)
    rel_bias = torch.randn((32, H), generator=g, device="cuda") * D**-0.5
    pos3 = t5.compute_position_bias(rel_bias, L_SERVE, L_SERVE, True, 32,
                                    128)[0].contiguous()
    km = _key_mask(g, B_SERVE, L_SERVE)
    args = (x, wqkv, wo, pos3, km)
    ref = fused_self_attention_plain(*args)
    results["fused_self_attention"] = check(
        "fused_self_attention", max_abs(fused_self_attention(*args), ref),
        4 * BF16_ULP_REL * ref.float().abs().max().item(),
        shape=[B_SERVE, L_SERVE, D],
        ms=time_ms(lambda: fused_self_attention(*args)),
        plain_ms=time_ms(lambda: fused_self_attention_plain(*args)),
    )
    results["v3_backward"] = {
        label: _check_k4(g, label, *shape)
        for label, shape in (("train", (ROWS_TRAIN, L_SERVE, 12, 64)),
                             ("L512_dk128", (32, 512, 12, 128)))
    }
    return results


def _check_k4(g, label, B, L, H, dk) -> dict:
    """The fused block's backward (K4: GEMM + ``t5_attention_bwd``) against
    ``v3_backward_plain`` on the same bf16 inputs and the same (m, l).

    Tolerances: dqkv and attn are fp32 sums rounded once to bf16 on both
    sides, in another order, from probabilities and ds that may round to
    bf16 one ulp apart: 2 bf16 ulps of each output's largest magnitude.
    dpos is an fp32 sum of ds over the batch rows in another order, each ds
    carrying ~1e-6 relative error from the recomputed scores: 1e-3 of
    |dpos|max. dpos must also be bitwise equal across two runs (fixed
    reduction order, no atomics)."""
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
    dpos_scale = ref[2].abs().max().item()
    check(f"v3_backward_{label}_dpos_rel", max_abs(got[2], ref[2]) / dpos_scale,
          1e-3)
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
    errs = {
        name: check(f"t5_attention_bwd_{label}_{name}", max_abs(a, b),
                    2 * BF16_ULP_REL * b.float().abs().max().item())
        ["max_abs_err"]
        for name, a, b in zip(("dq", "dk", "dv", "attn"), core_got[:4],
                              core_ref[:4])
    }
    errs["dpos_rel"] = check(
        f"t5_attention_bwd_{label}_dpos_rel",
        max_abs(core_got[4], core_ref[4]) / core_ref[4].abs().max().item(),
        1e-3)["max_abs_err"]
    return {
        "shape": [B, L, H, dk], "max_abs_err": max(
            errs[n] for n in ("dq", "dk", "dv", "attn")),
        "errors": errs, "dpos_bitwise_repeat": deterministic,
        "ms": time_ms(lambda: attention_backward(*core)),
        "plain_ms": time_ms(lambda: attention_backward_plain(*core)),
        "k4_ms": time_ms(lambda: v3_backward(*args)),
        "k4_plain_ms": time_ms(lambda: v3_backward_plain(*args)),
    }


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


def _train_cfg(flash_v3: bool) -> t5.T5Config:
    return dataclasses.replace(t5.T5Config.base(), dtype=torch.bfloat16,
                               flash_v3=flash_v3, fused_qkv=True)


def _launches() -> dict:
    return {"gemm": gemm.launches,
            "attention": flash_attention_forward.launches,
            "attention_bwd": attention_backward.launches}


def _zero_launches() -> None:
    gemm.launches = flash_attention_forward.launches = 0
    attention_backward.launches = 0


def _train_run(smi: str) -> dict:
    """cli.train.main for TRAIN_STEPS optimizer steps, counted."""
    layers = _train_cfg(True).num_layers
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        summary = train_main(preset={**TRAIN_PRESET, "out_dir": out},
                             argv=[], device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        final = torch.load(os.path.join(out, "final", CHECKPOINT_FILE),
                           map_location="cuda", weights_only=True)["params"]
    steps = summary["steps"]
    # per step: K3 forward and K4 backward once per encoder layer; GEMMs:
    # the forward's two projections and the backward's qkv recompute
    want = {"attention": layers * steps, "attention_bwd": layers * steps,
            "gemm": 3 * layers * steps}
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
    fields = dict(
        case="cli.train.main", steps=steps, seconds=seconds,
        steps_per_s=1.0 / step_s,
        trained_negatives_per_s=B_TRAIN * N_NEG_TRAIN / step_s,
        nvidia_smi=smi, launches=launches, expected_launches=want,
        losses=losses, losses_finite=finite, leaves_changed=changed,
        leaves=len(init), weights_finite=weights_finite,
    )
    emit("train", **fields)
    if not (launches == want and finite and changed > 0 and weights_finite):
        raise AssertionError(f"train: {fields}")
    return fields


def _step_ab() -> dict:
    """Step 1 with flash_v3 (K3/K4 kernels) against the dense route on the
    same weights and batch. The first update runs at lr(0) = 0, so the
    AdamW first moment after it is 0.1 x the clipped gradient: compared
    leaf by leaf as ||on - off|| / ||off||."""
    tok = HashTokenizer(vocab_size=32128)
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100, seed=42)
    dc = DeviceCorpus.build(store, triples, device="cuda")
    params = t5.init_params(_train_cfg(True),
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False,
                         ce_scale=(1 + N_NEG_TRAIN) * float(np.log(32128)))
    batch = dc.lce_batch(torch.Generator(device="cuda").manual_seed(1),
                         torch.arange(B_TRAIN, device="cuda"),
                         torch.tensor(0.5, device="cuda"), N_NEG_TRAIN)
    runs = {}
    for v3 in (True, False):
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = make_train_step(_train_cfg(v3), ctrl, tx, loss="lce",
                               n_neg_per_example=N_NEG_TRAIN, use_mean=False,
                               rel_id=tok.true_id, nrel_id=tok.false_id)
        before = _launches()
        state, metrics = step(init_train_state(params, tx,
                                               ctrl.init("cuda")), batch)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in _launches().items()}
        runs[v3] = (metrics["loss"].item(), t5.flatten_params(
            state.opt_state.mu), used)
        del state
    (loss_on, mu_on, used_on), (loss_off, mu_off, used_off) = (runs[True],
                                                               runs[False])
    rel = {k: ((mu_on[k] - mu_off[k]).norm() / mu_off[k].norm()).item()
           for k in mu_off if mu_off[k].norm() > 0}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_on - loss_off) / abs(loss_off)
    fields = dict(
        case="step1_flash_v3_vs_dense", loss_flash_v3=loss_on,
        loss_dense=loss_off, loss_rel_err=loss_rel, loss_tol=STEP_LOSS_RTOL,
        grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
        grad_rel_l2_median=statistics.median(rel.values()),
        grad_tol=STEP_GRAD_REL_L2, grad_median_tol=STEP_GRAD_REL_L2_MEDIAN,
        leaves=len(rel),
        launches_flash_v3=used_on, launches_dense=used_off,
    )
    emit("train", **fields)
    layers = _train_cfg(True).num_layers
    routed = (used_on["attention"] == used_on["attention_bwd"] == layers
              and used_off["attention"] == used_off["attention_bwd"] == 0)
    if not (routed and loss_rel <= STEP_LOSS_RTOL
            and rel[worst] <= STEP_GRAD_REL_L2
            and fields["grad_rel_l2_median"] <= STEP_GRAD_REL_L2_MEDIAN):
        raise AssertionError(f"step 1 flash_v3 vs dense: {fields}")
    return fields


def phase_train(smi: str) -> dict:
    emit("train", config="t5-base", vocab=32128, dtype="bfloat16",
         flash_v3=True, fused_qkv=True, batch=B_TRAIN, n=N_NEG_TRAIN,
         rows=ROWS_TRAIN, prompt_len=L_SERVE, steps=TRAIN_STEPS)
    run = _train_run(smi)
    return {"run": run, "step1": _step_ab()}


def main() -> int:
    device, smi = phase_device()
    phase_build()
    k = phase_kernels()
    s = phase_slice()
    tr = phase_train(smi)
    g = k["gemm"]["qkv"]
    a = k["attention"]["slice"]
    b = k["v3_backward"]["train"]
    paths = {"serving": s["launches"], "train": tr["run"]["launches"]}
    total = {name: sum(p.get(name, 0) for p in paths.values())
             for name in ("gemm", "attention", "attention_bwd")}
    print(json.dumps({"kernels": [
        {"name": "gemm_bf16", "route": "cuda",
         "source": "pacednegatives_tpu_torch/csrc/gemm_bf16.cu",
         "replaces": "pacednegatives_tpu/ops/flash_v3.py:147",
         "also_replaces": ["pacednegatives_tpu/ops/flash_v3.py:279"],
         "launches": total["gemm"], "max_abs_err": g["max_abs_err"],
         "ms": g["ms"], "plain_ms": g["plain_ms"],
         "shape": g["shape"], "o_projection": k["gemm"]["o"]},
        {"name": "t5_attention_fwd", "route": "cuda",
         "source": "pacednegatives_tpu_torch/csrc/t5_attention_fwd.cu",
         "replaces": "pacednegatives_tpu/ops/flash.py:121",
         "also_replaces": ["pacednegatives_tpu/ops/flash.py:498",
                           "pacednegatives_tpu/ops/flash_v3.py:147"],
         "launches": total["attention"],
         "max_abs_err": a["max_abs_err"], "ms": a["ms"],
         "plain_ms": a["plain_ms"], "shape": a["shape"]},
        {"name": "t5_attention_bwd", "route": "cuda",
         "source": "pacednegatives_tpu_torch/csrc/t5_attention_bwd.cu",
         "replaces": "pacednegatives_tpu/ops/flash_v3.py:279",
         "launches": total["attention_bwd"],
         "max_abs_err": b["max_abs_err"], "ms": b["ms"],
         "plain_ms": b["plain_ms"], "shape": b["shape"],
         "k4_ms": b["k4_ms"], "k4_plain_ms": b["k4_plain_ms"],
         "L512_dk128": k["v3_backward"]["L512_dk128"]},
    ], "launches_by_path": paths,
        "fused_self_attention": k["fused_self_attention"],
        "docs_per_s": {"unpacked": s["unpacked"]["docs_per_s"],
                       "packed_bucketed": s["packed"]["docs_per_s"]},
        "train": {"steps_per_s": tr["run"]["steps_per_s"],
                  "trained_negatives_per_s":
                      tr["run"]["trained_negatives_per_s"],
                  "step1_loss_rel_err": tr["step1"]["loss_rel_err"],
                  "step1_grad_rel_l2_max": tr["step1"]["grad_rel_l2_max"]},
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

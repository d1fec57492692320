#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):

1. device  - require CUDA, print the card's name and power limit as
             nvidia-smi reports them, turn TF32 off;
2. build   - compile the CUDA kernels from pacednegatives_tpu_torch/csrc;
3. kernels - each kernel against its plain PyTorch version on the card at
             the serving shapes: max |diff| against the stated tolerance,
             median kernel and plain times;
4. slice   - monoT5 rerank at t5-base width (random weights from a seed,
             flash_v3 on, bf16) through ``Reranker.rerank``: unpacked, then
             packed with length buckets. Launch counts must equal the
             routing's prediction, scores must be finite, and the first
             block's scores must agree with the port run on the CPU.

Then a JSON line with one entry per kernel, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pacednegatives_tpu_torch import kernels
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.ops.flash import (
    NEG_INF,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from pacednegatives_tpu_torch.ops.flash_v3 import (
    fused_self_attention,
    fused_self_attention_plain,
)
from pacednegatives_tpu_torch.ops.gemm import gemm, gemm_plain

BF16_ULP_REL = 2.0**-7  # one bf16 ulp, relative to the largest magnitude
B_SERVE, L_SERVE = 256, 188  # Reranker batch and t5-base prompt length
N_QUERIES, N_CANDIDATES = 64, 100
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


def phase_device() -> dict:
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
    return device


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
    return results


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
    gemm.launches = flash_attention_forward.launches = 0
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


def main() -> int:
    device = phase_device()
    phase_build()
    k = phase_kernels()
    s = phase_slice()
    g = k["gemm"]["qkv"]
    a = k["attention"]["slice"]
    print(json.dumps({"kernels": [
        {"name": "gemm_bf16", "route": "cuda",
         "source": "pacednegatives_tpu_torch/csrc/gemm_bf16.cu",
         "replaces": "pacednegatives_tpu/ops/flash_v3.py:147",
         "launches": s["launches"]["gemm"], "max_abs_err": g["max_abs_err"],
         "ms": g["ms"], "plain_ms": g["plain_ms"],
         "shape": g["shape"], "o_projection": k["gemm"]["o"]},
        {"name": "t5_attention_fwd", "route": "cuda",
         "source": "pacednegatives_tpu_torch/csrc/t5_attention_fwd.cu",
         "replaces": "pacednegatives_tpu/ops/flash.py:121",
         "also_replaces": ["pacednegatives_tpu/ops/flash.py:498",
                           "pacednegatives_tpu/ops/flash_v3.py:147"],
         "launches": s["launches"]["attention"],
         "max_abs_err": a["max_abs_err"], "ms": a["ms"],
         "plain_ms": a["plain_ms"], "shape": a["shape"]},
    ], "fused_self_attention": k["fused_self_attention"],
        "docs_per_s": {"unpacked": s["unpacked"]["docs_per_s"],
                       "packed_bucketed": s["packed"]["docs_per_s"]}}),
        flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

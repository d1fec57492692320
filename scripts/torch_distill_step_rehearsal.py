#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's distillation step-1 check: one
``make_distill_step`` step with the encoder on the fused block (flash_v3 +
fused_qkv) against the dense route, each in bf16 and fp32, on the same
weights and batch, without a card.

    python3 scripts/torch_distill_step_rehearsal.py [--width 128] [--layers 2]

On the CPU the fused block runs K3's and K4's plain versions, which round
where the kernels round. 16 triples (32 prompts of 24 + 160 + 4 = 188
tokens) of a 64-doc synthetic corpus with six random teacher scores per
prompt; random weights from seed 0 at ``--width`` (heads of 64, FFN twice
the width) and ``--layers`` encoder and decoder layers; lr 0 at step 1, so
AdamW's first moment is 0.1 x the clipped gradient. For MarginMSE and CE,
prints one JSON line a comparison: the relative loss difference and
||a - b|| / ||b|| per leaf (max, its leaf, median) of the kernel route
against the dense route in fp32 and in bf16, and of each bf16 route
against the dense route in fp32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pacednegatives_tpu_torch.data import (  # noqa: E402
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.distill import (  # noqa: E402
    TeacherBatcher,
    TeacherScores,
)
from pacednegatives_tpu_torch.distill.train import (  # noqa: E402
    init_distill_state,
    make_distill_step,
)
from pacednegatives_tpu_torch.models import t5  # noqa: E402
from pacednegatives_tpu_torch.train import make_optimizer  # noqa: E402


def _batch(tok) -> dict:
    corpus = TextCorpus.synthetic(num_docs=64, num_queries=16, seed=0,
                                  doc_len=150, query_len=12)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=160)
    rng = np.random.default_rng(0)
    triples = [{"qid": f"q{i}", "doc_id_a": f"d{i}",
                "doc_id_b": f"d{i + 16}"} for i in range(16)]
    teacher = TeacherScores({str(t): {
        r["qid"]: {r["doc_id_a"]: float(rng.random()),
                   r["doc_id_b"]: float(rng.random())} for r in triples}
        for t in range(6)})
    return {k: torch.from_numpy(v) for k, v in TeacherBatcher(
        triples, corpus, store, teacher, 16).get_batch(0).items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    tok = HashTokenizer(vocab_size=32128)
    batch = _batch(tok)
    base = t5.T5Config(vocab_size=32128, d_model=args.width, d_kv=64,
                       d_ff=2 * args.width, num_heads=args.width // 64,
                       num_layers=args.layers,
                       num_decoder_layers=args.layers)
    params = t5.init_params(base, torch.Generator().manual_seed(0))

    def run(dtype, flash_v3: bool, objective: str):
        cfg = dataclasses.replace(base, dtype=dtype, flash_v3=flash_v3,
                                  fused_qkv=True)
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = make_distill_step(cfg, tx, objective, rel_id=tok.true_id,
                                 nrel_id=tok.false_id)
        state, metrics = step(init_distill_state(params, tx), batch)
        return metrics["loss"].item(), t5.flatten_params(state.opt_state.mu)

    def compare(a, b) -> dict:
        rel = {k: ((a[1][k] - b[1][k]).norm() / b[1][k].norm()).item()
               for k in b[1] if b[1][k].norm() > 0}
        worst = max(rel, key=rel.get)
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
                "grad_rel_l2_max": rel[worst], "worst_leaf": worst,
                "grad_rel_l2_median": statistics.median(rel.values())}

    for objective in ("margin_mse", "ce"):
        fp32 = run(torch.float32, False, objective)
        runs = {"fp32_kernels": run(torch.float32, True, objective),
                "bf16_kernels": run(torch.bfloat16, True, objective),
                "bf16_dense": run(torch.bfloat16, False, objective)}
        for a, b in (("fp32_kernels", None), ("bf16_kernels", "bf16_dense"),
                     ("bf16_kernels", None), ("bf16_dense", None)):
            ref = fp32 if b is None else runs[b]
            print(json.dumps({"width": args.width, "layers": args.layers,
                              "objective": objective, "a": a,
                              "b": b or "fp32_dense",
                              **compare(runs[a], ref)}), flush=True)


if __name__ == "__main__":
    main()

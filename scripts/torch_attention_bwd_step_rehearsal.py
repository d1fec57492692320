#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's step-1 check at L 768: the chunked
kernel route (K1 forward, K2a backward) against the plain chunked route, on
the same t5-base weights and batch, without a card.

    python3 scripts/torch_attention_bwd_step_rehearsal.py [--pairs 1] [--n 1]

On the CPU the wrappers run their kernels' plain versions. The kernel
route is modelled with the arithmetic of the kernels on the card: the
forward as the plain route's online softmax over 64-key chunks (K1 rounds
the unnormalised probabilities to bf16 against the running max of its
64-key tiles), the backward as ``flash_attention_backward_plain`` (K2a:
fp32 operands, which the kernel's three-term split keeps). The plain route
is the one chip_smoke.py runs beside it: 256-key chunks, bf16 operands in
its backward. Both bf16, fp32 residual and carry, one microbatch,
24 + 740 + 4 = 768 tokens, the step chip_smoke.py's ``_step_ab`` takes (lr
0 at step 1, so AdamW's first moment is 0.1 x the clipped gradient).
Prints one JSON line: the loss of each route, their relative difference,
and ||on - off|| / ||off|| per leaf (max, median, the worst leaf). chip_smoke
runs 2 pairs x (1 + 3 negatives) = 8 rows; fewer rows keep this small and
are noisier, not quieter.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--n", type=int, default=1, help="negatives per pair")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    cfg = dataclasses.replace(
        t5.T5Config.base(), dtype=torch.bfloat16, fused_qkv=True,
        attention_impl="chunked", attention_chunk=256,
        attn_residual_dtype="fp32")
    tok = HashTokenizer(vocab_size=32128)
    corpus = TextCorpus.synthetic(num_docs=2048, num_queries=256, seed=42)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=24,
                                 max_d_tokens=740)
    triples = TripletStore.synthetic(corpus, n_pairs=1024, n_neg=100, seed=42)
    dc = DeviceCorpus.build(store, triples, device="cpu")
    params = t5.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False,
                         ce_scale=(1 + args.n) * float(np.log(32128)))
    batch = dc.lce_batch(torch.Generator().manual_seed(1),
                         torch.arange(args.pairs), torch.tensor(0.5), args.n)

    # the kernel route's gate without its CUDA condition, and K1's 64-key
    # tiles for its forward
    gate, fwd = t5.pallas_flash_eligible, t5._pallas_forward
    kernel_gate = lambda Lq, Lk, dk, device: (
        Lq % 128 == 0 and Lk % 128 == 0 and dk in (64, 128))
    k1_tiles = lambda q, k, v, shared, per_batch: t5._flash_forward(
        64, q, k, v, shared, per_batch)

    runs = {}
    for on in (True, False):
        t5.pallas_flash_eligible = kernel_gate if on else gate
        t5._pallas_forward = k1_tiles if on else fwd
        tx = make_optimizer(1e-3, total_steps=8, warmup_steps=1)
        step = make_train_step(dataclasses.replace(cfg, flash_kernel=on),
                               ctrl, tx, loss="lce", n_neg_per_example=args.n,
                               use_mean=False, rel_id=tok.true_id,
                               nrel_id=tok.false_id, microbatches=1,
                               grad_accum_dtype="fp32")
        t0 = time.perf_counter()
        state, metrics = step(init_train_state(params, tx, ctrl.init("cpu")),
                              batch)
        runs[on] = (metrics["loss"].item(),
                    t5.flatten_params(state.opt_state.mu),
                    time.perf_counter() - t0)
    t5.pallas_flash_eligible, t5._pallas_forward = gate, fwd

    (loss_on, mu_on, s_on), (loss_off, mu_off, s_off) = runs[True], runs[False]
    rel = {k: ((mu_on[k] - mu_off[k]).norm() / mu_off[k].norm()).item()
           for k in mu_off if mu_off[k].norm() > 0}
    worst = max(rel, key=rel.get)
    print(json.dumps(dict(
        rows=args.pairs * (1 + args.n), prompt_len=store.prompt_len,
        loss_kernel_route=loss_on, loss_plain_route=loss_off,
        loss_rel_err=abs(loss_on - loss_off) / abs(loss_off),
        grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
        grad_rel_l2_median=statistics.median(rel.values()), leaves=len(rel),
        seconds=[s_on, s_off])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

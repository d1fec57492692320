"""SPLADE-style learned-sparse encoder over the T5 encoder stack: the port
of models/splade.py (reference utilities/compute_all_splade.py:28-30 builds
negative pools with a SPLADE query encoder over a PISA quantized index).

Every encoder position is projected to vocabulary space through the (tied)
embedding, the LM head's product, and aggregated as

    w_v = max over real positions of log(1 + relu(logit_{pos, v})).

The (B, L, V) logits never exist whole: positions go in chunks of
``pos_chunk`` with a running per-term max in fp32, started at +0. The
product is a plain ``torch.matmul`` on fp32 operands (the compute dtype's
values, products exact, fp32 sums), as the JAX package computes it outside
any Pallas kernel with an fp32 result. ``relu`` here returns +0 for every
non-positive logit, as ``jax.nn.relu`` does (``torch.relu(-0.0)`` is -0.0),
and the accumulator starts at +0, so no activation is ever -0: the top-k
(``topk_stable``, ``lax.top_k``'s order) sees the zeros the JAX package
sees. Most activations tie at exactly 0, so the tie order matters.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.ops.mips import topk_stable


@torch.no_grad()
def splade_activations(params: dict, cfg: t5.T5Config,
                       input_ids: torch.Tensor,
                       attention_mask: torch.Tensor | None = None,
                       pos_chunk: int = 32) -> torch.Tensor:
    """(B, L) token ids -> (B, V) fp32 sparse term activations."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    h = t5.encode(params, cfg, input_ids, attention_mask)  # (B, L, D)
    emb = (params["shared"]["embedding"] if cfg.tie_word_embeddings
           else params["lm_head"]["embedding"]).to(cfg.dtype).float()
    scale = cfg.d_model**-0.5 if cfg.tie_word_embeddings else 1.0
    B, L, _ = h.shape
    C = min(pos_chunk, L)
    acc = torch.zeros((B, emb.shape[0]), dtype=torch.float32,
                      device=h.device)
    for s in range(0, L, C):
        logits = torch.matmul((h[:, s:s + C] * scale).float(), emb.t())
        act = torch.log1p(torch.where(logits > 0, logits, 0.0))
        # padded positions contribute 0
        act = act * attention_mask[:, s:s + C, None].float()
        acc = torch.maximum(acc, act.amax(dim=1))
    return acc


def splade_topk(params: dict, cfg: t5.T5Config, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None, k: int = 128,
                pos_chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights (B, k) fp32 descending, term ids (B, k) int64), ties to
    the lower term id. Entries of weight 0 are inactive terms (callers
    treat them as absent)."""
    act = splade_activations(params, cfg, input_ids, attention_mask,
                             pos_chunk)
    return topk_stable(act, k)


def encode_corpus_sparse(params: dict, cfg: t5.T5Config,
                         tokens: torch.Tensor, mask: torch.Tensor,
                         k: int = 128, batch_size: int = 64,
                         pos_chunk: int = 32):
    """Encode a (N, L) token matrix to top-k sparse vectors, ``batch_size``
    rows at a time -> (weights (N, k), term ids (N, k))."""
    parts = [splade_topk(params, cfg, tokens[s:s + batch_size].long(),
                         mask[s:s + batch_size], k=k, pos_chunk=pos_chunk)
             for s in range(0, tokens.shape[0], batch_size)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([i for _, i in parts]))

"""Dual-encoder embeddings from the T5 encoder stack: the port of
models/dual_encoder.py.

The reranker's own encoder with masked mean pooling: it shares weights with
the model being trained, so mined pools track the current model, and
refreshing the index is re-encoding. Both functions run under
``torch.no_grad()`` (the JAX package mines under ``stop_gradient``), on
whatever weights they are given: the online loop passes the fp32 master
weights, which ``t5.encode`` casts to ``cfg.dtype`` at each use, as the
JAX ``encode`` does.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch.models import t5


@torch.no_grad()
def embed(params: dict, cfg: t5.T5Config, input_ids: torch.Tensor,
          attention_mask: torch.Tensor | None = None,
          normalize: bool = True) -> torch.Tensor:
    """(B, L) token ids -> (B, D) pooled embeddings (fp32)."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    h = t5.encode(params, cfg, input_ids, attention_mask)  # (B, L, D)
    m = attention_mask[..., None].to(h.dtype)
    pooled = (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    pooled = pooled.float()
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-6)
    return pooled


@torch.no_grad()
def encode_corpus(params: dict, cfg: t5.T5Config, tokens: torch.Tensor,
                  mask: torch.Tensor | None, batch_size: int = 256,
                  normalize: bool = True,
                  pad_id: int | None = None) -> torch.Tensor:
    """Encode a (N, L) token matrix in fixed batches of ``batch_size`` (the
    last one padded with pad rows, as the JAX scan pads) into one (N, D)
    fp32 tensor. With mask=None each batch's mask is derived from its
    tokens (!= pad_id), so no (N, L) mask matrix ever exists."""
    N, L = tokens.shape
    pad_tok = cfg.pad_token_id if pad_id is None else pad_id
    out = None
    for s in range(0, N, batch_size):
        e = min(s + batch_size, N)
        t = tokens[s:e].long()
        m = None if mask is None else mask[s:e]
        if e - s < batch_size:
            fill = batch_size - (e - s)
            t = torch.cat([t, t.new_zeros((fill, L))])
            if m is not None:
                m = torch.cat([m, m.new_zeros((fill, L))])
        if m is None:
            m = (t != pad_tok).to(torch.int32)
        emb = embed(params, cfg, t, m, normalize)[: e - s]
        if out is None:
            out = emb.new_empty((N, emb.shape[1]))
        out[s:e] = emb
    return out

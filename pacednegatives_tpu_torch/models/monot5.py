"""monoT5 relevance scoring head: the port of models/monot5.py.

score = log_softmax over the (true, false) verbalizer-token logits at the
first decoder position, taking the 'true' component.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.parallel.collectives import reduce_from_model
from pacednegatives_tpu_torch.parallel.mesh import model_split
from pacednegatives_tpu_torch.utils.profiling import host_sync

# t5 sentencepiece: tokenizer.encode('true')[0] == 1176, 'false' -> 6136.
VERBALIZER_TRUE = 1176
VERBALIZER_FALSE = 6136

# leaves that only ever enter a matmul in cfg.dtype: casting them once is
# the same as the per-use casts (norm scales and rel_bias stay fp32)
_MATMUL_LEAVES = {"q", "k", "v", "o", "qkv", "kv", "wi", "wo", "wi_0", "wi_1",
                  "embedding"}


def serving_params(params: dict, cfg: t5.T5Config,
                   device: torch.device) -> dict:
    """Frozen serving weights on ``device`` (the ``Reranker``'s copy):
    q|k|v and k|v fused once (the JAX Reranker re-concatenates per call,
    t5.py:464-479; same numbers) and matmul weights cast to the compute
    dtype once."""
    fused = t5.fuse_attention_params(params)
    flat = {
        k: v.to(device=device,
                dtype=cfg.dtype if k.rsplit(".", 1)[-1] in _MATMUL_LEAVES
                else v.dtype)
        for k, v in t5.flatten_params(fused).items()
    }
    return t5.unflatten_params(flat)


def _pair(first_token_logits: torch.Tensor, rel_id: int, nrel_id: int,
          vocab_size: int | None = None) -> torch.Tensor:
    """Columns [rel_id, nrel_id] of the full logits (monot5.py:31). With
    ``vocab_size`` and narrower logits (a tensor-parallel rank's vocab
    columns), each column comes from the rank that owns it: the others
    put 0 there, and the pair is summed over the model group."""
    if vocab_size is None or first_token_logits.shape[-1] == vocab_size:
        with host_sync("monot5.pair"):  # the index list goes to the device
            return first_token_logits[:, [rel_id, nrel_id]]
    width = first_token_logits.shape[-1]
    mesh = model_split(width, vocab_size)
    cols = (torch.tensor([rel_id, nrel_id], device=first_token_logits.device)
            - mesh.model_rank * width)
    inside = (cols >= 0) & (cols < width)
    pair = first_token_logits[:, cols.clamp(0, width - 1)]
    return reduce_from_model(torch.where(inside, pair, 0.0), mesh)


def relevance_log_probs(first_token_logits: torch.Tensor,
                        rel_id: int = VERBALIZER_TRUE,
                        nrel_id: int = VERBALIZER_FALSE,
                        vocab_size: int | None = None) -> torch.Tensor:
    """(B, vocab) first-position logits -> (B,) log P(true | {true,false})
    (``vocab_size``: see ``_pair``)."""
    return torch.log_softmax(_pair(first_token_logits, rel_id, nrel_id,
                                   vocab_size), dim=-1)[:, 0]


def relevance_probs(first_token_logits: torch.Tensor,
                    rel_id: int = VERBALIZER_TRUE,
                    nrel_id: int = VERBALIZER_FALSE,
                    vocab_size: int | None = None) -> torch.Tensor:
    """(B,) P(true) (``vocab_size``: see ``_pair``)."""
    return torch.softmax(_pair(first_token_logits, rel_id, nrel_id,
                               vocab_size), dim=-1)[:, 0]


def score_batch(params: dict, cfg: t5.T5Config, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rel_id: int = VERBALIZER_TRUE,
                nrel_id: int = VERBALIZER_FALSE) -> torch.Tensor:
    """Score (B, L) 'Query: .. Document: .. Relevant:' prompts -> (B,)
    scores: one encoder pass and one decode step from the start token."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    enc = t5.encode(params, cfg, input_ids, attention_mask)
    B = input_ids.shape[0]
    dec_in = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                        device=input_ids.device)
    logits = t5.decode(params, cfg, dec_in, enc, attention_mask)
    return relevance_log_probs(logits[:, 0, :], rel_id, nrel_id,
                               cfg.vocab_size)

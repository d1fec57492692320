"""monoT5 reranking of a first-stage run: the port of eval/rerank.py.

Takes a first-stage run {qid: [doc_id, ...]}, scores every (query, doc)
prompt with the model in fixed-size batches on ``device`` (default cuda),
and returns each query's candidates ordered by score (``int8=True``: the
W8A8 forward of models/quant.py, T5 only). The model is reached through
``models.interface.for_config(cfg)``: monoT5 for a ``T5Config``, the
decoder-only reranker for a ``DeepseekV3Config``. Host-side prompt assembly, padding,
packing and length bucketing are the JAX ``Reranker``'s, line for line, so
the two packages batch the same pairs at the same lengths.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.data.pipeline import TokenizedStore
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.interface import T5Model, for_config
from pacednegatives_tpu_torch.models.monot5 import serving_params  # noqa: F401
from pacednegatives_tpu_torch.models.quant import (
    quantize_scoring_params,
    score_batch_int8,
)
from pacednegatives_tpu_torch.utils.profiling import (
    count,
    host_sync,
    recording,
    span,
)

@dataclasses.dataclass
class Reranker:
    params: dict
    cfg: t5.T5Config  # or a DeepseekV3Config
    store: TokenizedStore
    corpus: TextCorpus
    rel_id: int
    nrel_id: int
    batch_size: int = 64
    # packed=True serves contiguous prompts (pads only at the tail,
    # TokenizedStore.assemble_host_packed); it enables bucketing.
    packed: bool = False
    # With packed=True, score each batch at the smallest of these lengths
    # that fits its longest pair (pairs sorted by true length first).
    # None = always the full prompt length.
    bucket_lens: tuple[int, ...] | None = None
    # int8=True serves with the W8A8 dynamic-quant forward
    # (models/quant.py); the weights are quantized once, here, on
    # ``device``. Composes with packed / bucketed serving.
    int8: bool = False
    # the card unless the caller asks for the CPU; there is no fallback
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._requests = 0  # the id of the next request's span
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Reranker(device='cuda'): torch.cuda.is_available() is "
                "false; pass device='cpu' to score on the CPU")
        model = for_config(self.cfg)
        if self.int8:
            if not isinstance(model, T5Model):
                raise NotImplementedError("int8 serving is monoT5's")
            # from the weights as given (fp32 in a checkpoint), as the JAX
            # Reranker quantizes them, not from the bf16 serving copy; the
            # fused layout's per-column codes and scales are the separate
            # layout's, and its q|k|v take one product
            with torch.inference_mode():
                self.params = quantize_scoring_params(
                    t5.fuse_attention_params(t5.tree_map(
                        lambda a: a.to(self.device), self.params)),
                    self.cfg)
            self._score_fn = score_batch_int8
        else:
            self.params = model.serving_params(self.params, self.device)
            self._score_fn = (
                lambda params, cfg, ids, mask, rel_id, nrel_id:
                model.score_batch(params, ids, mask, rel_id, nrel_id))

    def _score(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            with host_sync("rerank.upload", 2):
                ids_d = torch.from_numpy(ids).to(self.device)
                mask_d = torch.from_numpy(mask).to(self.device)
            s = self._score_fn(self.params, self.cfg, ids_d, mask_d,
                               rel_id=self.rel_id, nrel_id=self.nrel_id)
            with host_sync("rerank.scores"):
                return s.float().cpu().numpy()

    def _score_block(self, qs: np.ndarray, ds: np.ndarray,
                     out_len: int | None) -> np.ndarray:
        """Score one <=batch_size block, padded to the fixed batch shape by
        repeating its last row (rerank.py:78-81). Counts the block's real
        tokens (``rerank.tokens_real``) and the positions it runs
        (``rerank.tokens_run``: rows x width, the padding rows included)."""
        with span("pnt.rerank.block"):
            m = len(qs)
            B = self.batch_size
            with span("pnt.rerank.assemble"):
                if m < B:
                    padn = B - m
                    qs = np.concatenate([qs, np.repeat(qs[-1:], padn)])
                    ds = np.concatenate([ds, np.repeat(ds[-1:], padn)])
                if self.packed:
                    ids, mask = self.store.assemble_host_packed(qs, ds,
                                                                out_len)
                else:
                    ids, mask = self.store.assemble_host(qs, ds)
                if recording():
                    count("rerank.tokens_real", int(mask[:m].sum()))
                    count("rerank.tokens_run", mask.size)
            with span("pnt.rerank.forward"):
                return self._score(ids, mask)[:m]

    def _bucket_plan(self, q_rows: np.ndarray,
                     d_rows: np.ndarray) -> list[tuple[np.ndarray, int]]:
        """Sort pairs by true length into length-homogeneous <=batch_size
        blocks; give each the smallest bucket that fits its longest pair
        (the full prompt length is always the fallback bucket)."""
        B = self.batch_size
        L = self.store.prompt_len
        lens = self.store.pair_lengths(q_rows, d_rows)
        order = np.argsort(lens, kind="stable")
        buckets = sorted({min(b, L) for b in self.bucket_lens} | {L})
        plan = []
        for s in range(0, len(q_rows), B):
            blk = order[s : s + B]
            need = int(lens[blk].max())
            plan.append((blk, next(b for b in buckets if b >= need)))
        return plan

    def warm(self, q_rows: np.ndarray, d_rows: np.ndarray) -> list[int]:
        """Run one block per distinct bucket this pair set needs, so the
        first timed block pays no one-time cost (kernel build and load,
        allocator growth). Each warm block is a row permutation of a
        planned block. Returns the distinct bucket lengths run."""
        perm = np.random.default_rng(0x5EED).permutation
        if self.packed and self.bucket_lens:
            seen: dict[int, np.ndarray] = {}
            for blk, out_len in self._bucket_plan(q_rows, d_rows):
                seen.setdefault(out_len, blk)
            for out_len, blk in seen.items():
                p = perm(len(blk))
                self._score_block(q_rows[blk][p], d_rows[blk][p], out_len)
            return sorted(seen)
        B = min(self.batch_size, len(q_rows))
        p = perm(B)
        self._score_block(q_rows[:B][p], d_rows[:B][p], None)
        return [self.store.prompt_len]

    def score_pairs(self, q_rows: np.ndarray,
                    d_rows: np.ndarray) -> np.ndarray:
        """(M,) query rows x (M,) doc rows -> (M,) relevance log-probs."""
        M = len(q_rows)
        B = self.batch_size
        out = np.zeros(M, np.float32)
        if self.packed and self.bucket_lens:
            with span("pnt.rerank.plan"):
                plan = self._bucket_plan(q_rows, d_rows)
            for blk, out_len in plan:
                out[blk] = self._score_block(q_rows[blk], d_rows[blk], out_len)
            return out
        for s in range(0, M, B):
            e = min(s + B, M)
            out[s:e] = self._score_block(q_rows[s:e], d_rows[s:e], None)
        return out

    def rerank(self, run: Mapping[str, Sequence[str]],
               depth: int | None = None) -> dict[str, list[str]]:
        """Rerank each query's candidate list by model score (desc)."""
        self._requests += 1
        with span("pnt.rerank.request", self._requests - 1):
            with span("pnt.rerank.plan"):
                q_rows, d_rows = [], []
                items: list[tuple[str, list[str]]] = []
                for qid, docs in run.items():
                    docs = list(docs)[: depth or len(docs)]
                    items.append((qid, docs))
                    for d in docs:
                        q_rows.append(self.corpus.query_index[qid])
                        d_rows.append(self.corpus.doc_index[d])
                q_rows = np.asarray(q_rows, np.int64)
                d_rows = np.asarray(d_rows, np.int64)
            scores = self.score_pairs(q_rows, d_rows)
            with span("pnt.rerank.order"):
                out: dict[str, list[str]] = {}
                pos = 0
                for qid, docs in items:
                    s = scores[pos : pos + len(docs)]
                    pos += len(docs)
                    order = np.argsort(-s, kind="stable")
                    out[qid] = [docs[i] for i in order]
            return out

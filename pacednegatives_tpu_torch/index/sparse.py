"""Quantized impact index for learned-sparse (SPLADE) retrieval.

The reference builds SPLADE pools against a PISA *quantized* index
(utilities/compute_all_splade.py:28-30 ``PisaIndex(..., 'quantized')``):
term weights are quantized to small integer "impacts" and scoring is an
integer dot product over posting lists. This is the in-repo equivalent:

- build: top-k sparse vectors (term_ids, weights) per doc -> term-major CSR
  postings with uint8 impacts (global linear scale, PISA-style).
- search: accumulate qw * impact over each query term's posting list
  (vectorized np.add.at) -> top-k docs, deterministic tie-break by doc id.

Host-side NumPy by design: pool building is offline (the reference runs it
as a CLI over PISA); the hot training path uses the dense HBM index
(index/dense.py + ops/mips.py) instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SparseIndex:
    term_start: np.ndarray  # (V+1,) int64 CSR offsets
    post_docs: np.ndarray   # (nnz,) int32 doc rows, term-major
    post_imps: np.ndarray   # (nnz,) uint8 quantized impacts (or fp32 raw)
    scale: float            # impact * scale ~= original weight
    num_docs: int

    @classmethod
    def build(
        cls,
        term_ids: np.ndarray,  # (N, k) int32
        weights: np.ndarray,   # (N, k) fp32, 0 = inactive slot
        num_terms: int,
        quantize: bool = True,
    ) -> "SparseIndex":
        term_ids = np.asarray(term_ids)
        weights = np.asarray(weights, np.float32)
        N, k = term_ids.shape
        docs = np.repeat(np.arange(N, dtype=np.int32), k)
        t = term_ids.reshape(-1)
        w = weights.reshape(-1)
        keep = w > 0
        docs, t, w = docs[keep], t[keep], w[keep]

        # ONE (term, doc)-major sort serves both the CSR layout and the
        # duplicate merge: lax.top_k output never produces duplicates, but
        # build() is a public API over arbitrary (term_ids, weights) — and
        # search()'s fancy-index += relies on per-term doc rows being
        # unique. The previous np.unique + separate argsort paid the
        # O(nnz log nnz) sort twice on every build (multi-second at MS
        # MARCO scale) even when no duplicates exist.
        key = t.astype(np.int64) * N + docs
        order = np.argsort(key, kind="stable")
        key = key[order]
        docs, t, w = docs[order], t[order], w[order]
        if len(key) and np.any(key[1:] == key[:-1]):
            # merge duplicate (doc, term) entries by summing their weights
            starts = np.concatenate(
                [[0], np.nonzero(key[1:] != key[:-1])[0] + 1]
            )
            w = np.add.reduceat(w, starts).astype(np.float32)
            docs, t = docs[starts], t[starts]
        term_start = np.zeros(num_terms + 1, np.int64)
        np.add.at(term_start, t + 1, 1)
        np.cumsum(term_start, out=term_start)

        if quantize:
            scale = float(w.max()) / 255.0 if len(w) else 1.0
            imps = np.clip(np.rint(w / max(scale, 1e-12)), 1, 255).astype(
                np.uint8
            )
        else:
            scale = 1.0
            imps = w
        return cls(
            term_start=term_start, post_docs=docs, post_imps=imps,
            scale=scale, num_docs=N,
        )

    @property
    def nnz(self) -> int:
        return len(self.post_docs)

    def search(
        self,
        q_terms: np.ndarray,   # (kq,) int32
        q_weights: np.ndarray,  # (kq,) fp32, 0 = inactive
        k: int = 1000,
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (doc rows best-first, scores), <= k entries, score > 0 only."""
        acc = np.zeros(self.num_docs, np.float32)
        for t, qw in zip(np.asarray(q_terms), np.asarray(q_weights)):
            if qw <= 0:
                continue
            s, e = self.term_start[t], self.term_start[t + 1]
            if s == e:
                continue
            # doc rows are unique within one term's postings (build() merges
            # duplicate (doc, term) entries), so fancy-index += is exact and
            # much faster than np.add.at
            acc[self.post_docs[s:e]] += (
                qw * self.scale * self.post_imps[s:e].astype(np.float32)
            )
        cand = np.nonzero(acc > 0)[0]
        if len(cand) > k:
            part = np.argpartition(-acc[cand], k - 1)[:k]
            cand = cand[part]
        order = cand[np.lexsort((cand, -acc[cand]))]
        return order.astype(np.int32), acc[order]

    def search_batch(self, q_terms, q_weights, k: int = 1000):
        return [
            self.search(t, w, k) for t, w in zip(q_terms, q_weights)
        ]

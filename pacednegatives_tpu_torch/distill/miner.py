"""Ensemble negative miner: reciprocal-rank fusion over lexical pipelines.

Parity with the reference's EnsembleScorer (mine_negatives.py:19-117): five
retrieval pipelines (tuned BM25 k1=0.45 b=0.55 x {Bo1, KL, RM3} expansion,
DPH x {Bo1, KL}), fused by mean reciprocal rank ``1/(C + rank + 1)`` over the
union of candidates (docs missing from a pipeline get rank 10000 —
EnsembleScorer.DEFAULT), then ONE negative is sampled uniformly from each
query's top-1000 fused candidates (get_sample, mine_negatives.py:114-117).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.distill.teacher import DEFAULT_TEACHERS
from pacednegatives_tpu_torch.index.bm25 import LexicalIndex

_MISSING_RANK = 10_000  # EnsembleScorer.DEFAULT (mine_negatives.py:20)


@dataclasses.dataclass
class EnsembleMiner:
    index: LexicalIndex
    pipelines: Sequence[tuple[int, int]] = DEFAULT_TEACHERS
    C: float = 0.0
    budget: int = 1000
    k1: float = 0.45
    b: float = 0.55

    @classmethod
    def build(cls, corpus: TextCorpus, **kw) -> "EnsembleMiner":
        return cls(index=LexicalIndex.build(corpus.doc_texts), **kw)

    def fused_ranking(self, query_text: str) -> tuple[np.ndarray, np.ndarray]:
        """-> (doc rows, fused scores) best-first over the candidate union."""
        ranks: list[dict[int, int]] = []
        for model, qe in self.pipelines:
            ids, _ = self.index.search(
                query_text, k=self.budget, model=model,
                k1=self.k1, b=self.b, qe=qe,
            )
            ranks.append({int(d): r for r, d in enumerate(ids)})

        candidates = sorted(set().union(*[set(r) for r in ranks]))
        if not candidates:
            return np.zeros(0, np.int32), np.zeros(0)
        scores = np.array(
            [
                np.mean(
                    [1.0 / (self.C + r.get(d, _MISSING_RANK) + 1) for r in ranks]
                )
                for d in candidates
            ]
        )
        order = np.argsort(-scores, kind="stable")
        return np.asarray(candidates, np.int32)[order], scores[order]

    def sample_negative(
        self, query_text: str, rng: np.random.Generator,
        exclude: set[int] | None = None,
    ) -> int:
        """One uniform sample from the fused top-``budget`` candidates."""
        ids, _ = self.fused_ranking(query_text)
        pool = ids[: self.budget]
        if exclude:
            pool = np.asarray([d for d in pool if int(d) not in exclude], np.int32)
        if len(pool) == 0:
            raise ValueError("no candidates to sample from")
        return int(rng.choice(pool))

    def mine_triples(
        self,
        corpus: TextCorpus,
        pairs: Sequence[tuple[str, str]],  # (qid, positive doc_id)
        seed: int = 0,
    ) -> list[dict]:
        """-> [{qid, doc_id_a, doc_id_b}] — the reference's TSV triple schema
        (mine_negatives.py:104-121)."""
        rng = np.random.default_rng(seed)
        out = []
        for qid, pos in pairs:
            neg_row = self.sample_negative(
                corpus.query_text(qid), rng, exclude={corpus.doc_index[pos]}
            )
            out.append(
                {
                    "qid": qid,
                    "doc_id_a": pos,
                    "doc_id_b": corpus.doc_ids[neg_row],
                }
            )
        return out

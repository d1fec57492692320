"""Teacher-score production and storage for MarginMSE distillation.

Parity with the reference's get_teacher_scores.py: each (query, doc) pair in
a triples file is scored under five lexical teachers (BM25 x {Bo1, KL, RM3},
DPH x {Bo1, KL} — mine_negatives.py:69-77 pipeline set, here applied as
pair scorers like get_teacher_scores.py:31-37), min-max normalized PER QUERY
(get_teacher_scores.py:63-68), plus a binary ground-truth channel at key
``len(models)+1`` (pos=1, neg=0 — get_teacher_scores.py:77-81).

Storage schema (distill/loader.py:30-31 parity):
    {model_idx(str): {qid: {doc_id: score}}}
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Sequence

import numpy as np

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.index.bm25 import (
    MODEL_BM25,
    MODEL_DPH,
    QE_BO1,
    QE_KL,
    QE_RM3,
    LexicalIndex,
)

# (model, qe) pipelines — the reference's tuned BM25 (k1=0.45, b=0.55,
# mine_negatives.py:72) with three expansions + DPH with two.
DEFAULT_TEACHERS: tuple[tuple[int, int], ...] = (
    (MODEL_BM25, QE_BO1),
    (MODEL_BM25, QE_KL),
    (MODEL_BM25, QE_RM3),
    (MODEL_DPH, QE_BO1),
    (MODEL_DPH, QE_KL),
)


@dataclasses.dataclass
class TeacherScores:
    """scores[model_idx][qid][doc_id] -> float"""

    scores: dict[str, dict[str, dict[str, float]]]

    @property
    def num_teachers(self) -> int:
        return len(self.scores)

    def lookup(self, qid: str, doc_id: str, neg: bool) -> np.ndarray:
        """Per-teacher score vector; missing defaults 1. (pos) / 0. (neg) —
        reference distill/loader.py:44-48."""
        default = 0.0 if neg else 1.0
        # numeric key order: lexicographic sorting scrambles 10+ channels
        # ('0','1','10','11','2',...) against the teacher margin pairing
        key = lambda kv: (0, int(kv[0])) if kv[0].isdigit() else (1, kv[0])
        out = []
        for _, table in sorted(self.scores.items(), key=key):
            out.append(table.get(str(qid), {}).get(str(doc_id), default))
        return np.asarray(out, np.float32)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.scores, f)

    @classmethod
    def load(cls, path: str) -> "TeacherScores":
        with open(path) as f:
            return cls(json.load(f))


def _minmax_per_query(rows: dict[str, dict[str, float]]) -> None:
    for qid, docs in rows.items():
        vals = np.asarray(list(docs.values()))
        lo, hi = vals.min(), vals.max()
        span = hi - lo
        for d in docs:
            docs[d] = float((docs[d] - lo) / span) if span > 0 else 0.0


def score_teachers(
    corpus: TextCorpus,
    triples: Sequence[dict],  # {qid, doc_id_a, doc_id_b(str)}
    teachers: Sequence[tuple[int, int]] = DEFAULT_TEACHERS,
    index: LexicalIndex | None = None,
    include_ground_truth: bool = True,
) -> TeacherScores:
    ix = index or LexicalIndex.build(corpus.doc_texts)
    if not ix.native:
        raise RuntimeError("teacher scoring needs the native lexical library")

    main: dict[str, dict[str, dict[str, float]]] = {}
    for ti, (model, _qe) in enumerate(teachers):
        # NOTE: pair scorers don't apply query expansion (the reference's
        # pt.text.scorer over just the 2 candidate docs cannot either — the
        # background statistics come from the full index).
        rows: dict[str, dict[str, float]] = defaultdict(dict)
        for r in triples:
            q = corpus.query_text(r["qid"])
            for key in ("doc_id_a", "doc_id_b"):
                doc_id = r[key]
                rows[r["qid"]][doc_id] = ix.score_pair(
                    q, corpus.doc_index[doc_id], model=model, k1=0.45, b=0.55
                )
        _minmax_per_query(rows)
        main[str(ti)] = {q: dict(d) for q, d in rows.items()}

    if include_ground_truth:
        gt: dict[str, dict[str, float]] = defaultdict(dict)
        for r in triples:
            gt[r["qid"]][r["doc_id_a"]] = 1.0
            gt[r["qid"]][r["doc_id_b"]] = 0.0
        main[str(len(teachers) + 1)] = {q: dict(d) for q, d in gt.items()}

    return TeacherScores(main)


def score_teachers_retrieval(
    corpus: TextCorpus,
    query_ids: Sequence[str],
    teachers: Sequence[tuple[int, int]] = DEFAULT_TEACHERS,
    index: LexicalIndex | None = None,
    k: int = 100,
) -> TeacherScores:
    """Retrieval-variant teacher scoring (reference get_all_scores.py:20-97):
    instead of scoring fixed triple pairs, each teacher RETRIEVES its own
    top-k per query (with its query-expansion pipeline) and the retrieved
    scores are min-max normalized per query."""
    ix = index or LexicalIndex.build(corpus.doc_texts)
    if not ix.native:
        raise RuntimeError("teacher scoring needs the native lexical library")

    main: dict[str, dict[str, dict[str, float]]] = {}
    for ti, (model, qe) in enumerate(teachers):
        rows: dict[str, dict[str, float]] = defaultdict(dict)
        for qid in query_ids:
            ids, scores = ix.search(
                corpus.query_text(qid), k=k, model=model,
                k1=0.45, b=0.55, qe=qe,
            )
            for d, s in zip(ids, scores):
                rows[qid][corpus.doc_ids[int(d)]] = float(s)
        _minmax_per_query(rows)
        main[str(ti)] = {q: dict(d) for q, d in rows.items()}
    return TeacherScores(main)

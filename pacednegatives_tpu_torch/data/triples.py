"""Triples with difficulty-ordered negative pools.

Canonical data contract (reference SURVEY.md §1): records of
``{query_id: str, doc_id_a: str, doc_id_b: [str, ...]}`` where doc_id_b is
the ordered negative pool. Canonical order is EASIEST FIRST (index 0 =
lowest retrieval rank), fixing the reference's inconsistency between
compute_all_bm25.py:44 (easy-first) and pisa_build_dataset.py:42
(hard-first): pass ``order="hard_first"`` to flip legacy files on load.

Both JSON layouts the reference emits are supported: an array of records
(pd.to_json orient='records', read at lceT5.py:58-59) and JSONL
(train/eta.py:44 lines=True).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Sequence

import numpy as np

from pacednegatives_tpu_torch.data.corpus import TextCorpus


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def load_triples(path: str) -> list[dict]:
    """Load triples from JSON (records array) or JSONL, autodetected."""
    with _open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            records = json.load(f)
        else:
            records = [json.loads(line) for line in f if line.strip()]
    out = []
    for i, r in enumerate(records):
        qid = r.get("query_id", r.get("qid"))
        if qid is None:
            raise KeyError(
                f"record {i} has no 'query_id'/'qid' key (keys: {sorted(r)})"
            )
        out.append(
            {
                "query_id": str(qid),
                "doc_id_a": str(r["doc_id_a"]),
                "doc_id_b": [str(d) for d in r["doc_id_b"]],
            }
        )
    return out


@dataclasses.dataclass
class TripletStore:
    """Integer-indexed triples: row i is (query row, positive doc row,
    pool of negative doc rows ordered easiest -> hardest)."""

    query_rows: np.ndarray  # (N,) int32 into corpus queries
    pos_rows: np.ndarray  # (N,) int32 into corpus docs
    pools: np.ndarray  # (N, n_neg) int32 into corpus docs

    def __len__(self) -> int:
        return len(self.query_rows)

    @property
    def n_neg(self) -> int:
        return self.pools.shape[1]

    @classmethod
    def from_records(
        cls,
        records: Sequence[dict],
        corpus: TextCorpus,
        n_neg: int | None = None,
        order: str = "easy_first",
    ) -> "TripletStore":
        """Normalize ragged pools to a fixed (N, n_neg) matrix.

        Pools shorter than n_neg are balanced-upsampled (evenly spaced
        repeats — reference util.py:34-40 get_balanced_idx); longer pools are
        balanced-subsampled the same way so the difficulty axis keeps full
        range.
        """
        if order not in ("easy_first", "hard_first"):
            raise ValueError(order)
        for r in records:
            if not r["doc_id_b"]:
                raise ValueError(
                    f"query {r['query_id']!r} has an empty negative pool"
                )
        if n_neg is None:
            n_neg = min(len(r["doc_id_b"]) for r in records)

        q_rows, p_rows, pools = [], [], []
        for r in records:
            pool = r["doc_id_b"]
            if order == "hard_first":
                pool = pool[::-1]
            rows = np.array([corpus.doc_index[d] for d in pool], np.int32)
            if len(rows) != n_neg:
                spacing = np.linspace(
                    0, len(rows) - 1, n_neg, endpoint=True, dtype=int
                )
                rows = rows[spacing]
            q_rows.append(corpus.query_index[r["query_id"]])
            p_rows.append(corpus.doc_index[r["doc_id_a"]])
            pools.append(rows)

        return cls(
            query_rows=np.asarray(q_rows, np.int32),
            pos_rows=np.asarray(p_rows, np.int32),
            pools=np.stack(pools).astype(np.int32),
        )

    @classmethod
    def synthetic(
        cls, corpus: TextCorpus, n_pairs: int, n_neg: int = 32, seed: int = 0
    ) -> "TripletStore":
        """Random pools over the synthetic corpus; positive = the planted
        relevant doc for each query (corpus.synthetic topic structure)."""
        rng = np.random.default_rng(seed)
        nq, nd = corpus.num_queries, corpus.num_docs
        q_rows = np.arange(n_pairs, dtype=np.int32) % nq
        pos_rows = q_rows % nd  # doc d is relevant to query d % nq
        pools = rng.integers(0, nd, size=(n_pairs, n_neg)).astype(np.int32)
        # avoid sampling the positive itself
        clash = pools == pos_rows[:, None]
        pools = np.where(clash, (pools + 1) % nd, pools)
        return cls(q_rows, pos_rows, pools)

    def save_jsonl(self, path: str, corpus: TextCorpus) -> None:
        with open(path, "w") as f:
            for i in range(len(self)):
                rec = {
                    "query_id": corpus.query_ids[self.query_rows[i]],
                    "doc_id_a": corpus.doc_ids[self.pos_rows[i]],
                    "doc_id_b": [corpus.doc_ids[d] for d in self.pools[i]],
                }
                f.write(json.dumps(rec) + "\n")

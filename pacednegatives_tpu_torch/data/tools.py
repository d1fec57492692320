"""Offline dataset tools (reference util.py + utilities/* parity), pandas-free.

- collapse_triples: group raw (q, d+, d-) triples into pooled records and
  order each pool by a scorer (reference util.py:20-27 + adhocRestructure
  util.py:9-18; scorer scores DESC = hardest-first there, so we reverse to
  the canonical easiest-first).
- take_subset / take_balanced_subset: pool truncation (util.py:29-44).
- collate_pools: join a pairs file with a pools file on query_id
  (utilities/collate_dataset.py:4-15).
- subsample: uniform record subsample (utilities/dataset_subset.py:4-7).
- clean_text: (util.py:5-7).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Sequence

import numpy as np


def clean_text(text: str) -> str:
    text = re.sub(r"[^A-Za-z0-9 ]+", "", text)
    return text.strip()


def collapse_triples(
    triples: Sequence[dict],  # {query_id, doc_id_a, doc_id_b(str)}
    score_fn: Callable[[str, str], float] | None = None,
) -> list[dict]:
    """Group by (query_id, doc_id_a) -> pooled doc_id_b list; if a scorer is
    given, order the pool easiest -> hardest by score(query_id, doc_id)."""
    groups: dict[tuple[str, str], list[str]] = defaultdict(list)
    for t in triples:
        groups[(t["query_id"], t["doc_id_a"])].append(t["doc_id_b"])
    out = []
    for (qid, pos), pool in groups.items():
        if score_fn is not None:
            pool = sorted(pool, key=lambda d: score_fn(qid, d))  # ascending = easy first
        out.append({"query_id": qid, "doc_id_a": pos, "doc_id_b": pool})
    return out


def take_subset(records: Sequence[dict], num_docs: int = 10) -> list[dict]:
    return [
        {**r, "doc_id_b": list(r["doc_id_b"])[:num_docs]} for r in records
    ]


def get_balanced_idx(vals: Sequence, num_docs: int) -> list:
    """Evenly-spaced subsample keeping both endpoints (util.py:34-40; the
    reference's short-pool branch crashes on a len/int division — here short
    pools repeat elements to reach num_docs)."""
    vals = list(vals)
    if len(vals) < num_docs:
        reps = int(np.ceil(num_docs / len(vals)))
        vals = list(np.repeat(vals, reps))
        return vals[:num_docs]
    spacing = np.linspace(0, len(vals) - 1, num_docs, endpoint=True, dtype=int)
    return [vals[i] for i in spacing]


def take_balanced_subset(records: Sequence[dict], num_docs: int = 10) -> list[dict]:
    return [
        {**r, "doc_id_b": get_balanced_idx(r["doc_id_b"], num_docs)}
        for r in records
    ]


def collate_pools(
    pairs: Sequence[dict],  # {query_id, doc_id_a}
    pools: Sequence[dict],  # {query_id|qid, doc_id_b: [...]}
) -> list[dict]:
    """Inner-join pairs with negative pools on query_id."""
    by_q = {
        str(p.get("query_id", p.get("qid"))): p["doc_id_b"] for p in pools
    }
    out = []
    for p in pairs:
        qid = str(p["query_id"])
        if qid in by_q:
            out.append(
                {"query_id": qid, "doc_id_a": p["doc_id_a"], "doc_id_b": by_q[qid]}
            )
    return out


def subsample(records: Sequence[dict], n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(records), size=min(n, len(records)), replace=False)
    return [records[i] for i in sorted(idx)]

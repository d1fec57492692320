"""IR evaluation metrics (trec_eval-compatible definitions).

Replaces the reference's PyTerrier/JVM evaluation (eval.py:26
``pt.Experiment(eval_metrics=["map", "ndcg_cut_10", "recip_rank"])``) with
in-repo numpy. Definitions follow trec_eval, which is what PyTerrier calls
underneath:

- recip_rank: 1/rank of the first relevant (rel > 0) document.
- ndcg_cut_k: DCG with LINEAR gain rel / log2(rank+1) (trec_eval's
  ndcg_cut uses linear gain, not the 2^rel - 1 form some toolkits default
  to), normalized by the ideal DCG at the same cutoff.
- map: mean of precision at each relevant retrieved position, divided by
  TOTAL relevant (not just retrieved).

A "run" is {qid: [doc_id, ...]} ranked best-first; "qrels" is
{qid: {doc_id: rel}}. Queries without qrels are skipped (trec_eval
behavior).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

Run = Mapping[str, Sequence[str]]
Qrels = Mapping[str, Mapping[str, int]]


def reciprocal_rank(ranked: Sequence[str], rels: Mapping[str, int]) -> float:
    for i, d in enumerate(ranked):
        if rels.get(d, 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def precision_at_k(ranked, rels, k: int, min_rel: int = 1) -> float:
    hits = sum(1 for d in ranked[:k] if rels.get(d, 0) >= min_rel)
    return hits / k


def recall_at_k(ranked, rels, k: int, min_rel: int = 1) -> float:
    total = sum(1 for r in rels.values() if r >= min_rel)
    if total == 0:
        return 0.0
    hits = sum(1 for d in ranked[:k] if rels.get(d, 0) >= min_rel)
    return hits / total


def dcg_at_k(gains: Sequence[int], k: int) -> float:
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains[:k]))


def ndcg_at_k(ranked, rels, k: int) -> float:
    gains = [rels.get(d, 0) for d in ranked]
    ideal = sorted(rels.values(), reverse=True)
    idcg = dcg_at_k(ideal, k)
    if idcg == 0:
        return 0.0
    return dcg_at_k(gains, k) / idcg


def average_precision(ranked, rels, min_rel: int = 1) -> float:
    total = sum(1 for r in rels.values() if r >= min_rel)
    if total == 0:
        return 0.0
    hits = 0
    s = 0.0
    for i, d in enumerate(ranked):
        if rels.get(d, 0) >= min_rel:
            hits += 1
            s += hits / (i + 1)
    return s / total


_METRICS = {
    "recip_rank": lambda r, q: reciprocal_rank(r, q),
    "map": lambda r, q: average_precision(r, q),
}


def _parse(metric: str):
    if metric in _METRICS:
        return _METRICS[metric]
    # graded-relevance variants: map_rel2 / P_rel2_10 (notebooks use
    # AP(rel=2) and P(rel=2)@k on TREC DL — scoring.ipynb cell 11)
    if metric.startswith("map_rel"):
        min_rel = int(metric[7:])
        return lambda r, q, m=min_rel: average_precision(r, q, min_rel=m)
    if metric.startswith("P_rel"):
        rel_s, k_s = metric[5:].split("_")
        return lambda r, q, m=int(rel_s), k=int(k_s): precision_at_k(r, q, k, m)
    for prefix, fn in (
        ("ndcg_cut_", ndcg_at_k),
        ("ndcg_cut.", ndcg_at_k),
        ("recall_", recall_at_k),
        ("P_", precision_at_k),
        ("recip_rank_", None),
    ):
        if metric.startswith(prefix):
            k = int(metric[len(prefix):])
            if prefix.startswith("recip_rank"):
                return lambda r, q, k=k: reciprocal_rank(r[:k], q)
            return lambda r, q, fn=fn, k=k: fn(r, q, k)
    if metric.startswith("mrr@"):
        k = int(metric[4:])
        return lambda r, q, k=k: reciprocal_rank(r[:k], q)
    raise ValueError(f"unknown metric {metric}")


def evaluate_run(
    run: Run, qrels: Qrels, metrics: Sequence[str]
) -> dict[str, dict[str, float]]:
    """Per-query metric values: {metric: {qid: value}}."""
    fns = {m: _parse(m) for m in metrics}
    out: dict[str, dict[str, float]] = {m: {} for m in metrics}
    for qid, ranked in run.items():
        rels = qrels.get(qid)
        if not rels:
            continue
        for m, fn in fns.items():
            out[m][qid] = fn(list(ranked), rels)
    return out

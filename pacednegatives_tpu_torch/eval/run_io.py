"""TREC run file I/O.

The reference's ecosystem exchanges ranked lists as TREC run files (the
notebooks dump per-pipeline run CSVs, and pt.Experiment consumes
trec_eval-style runs). Standard 6-column format:

    qid Q0 doc_id rank score tag
"""

from __future__ import annotations

from typing import Mapping, Sequence


def write_trec_run(
    path: str,
    run: Mapping[str, Sequence[str]],
    tag: str = "pacednegatives_tpu",
    scores: Mapping[str, Sequence[float]] | None = None,
) -> None:
    """Write {qid: [doc_id...]} (best-first) as a TREC run. When ``scores``
    is absent, descending pseudo-scores preserve the ranking."""
    with open(path, "w") as f:
        for qid, docs in run.items():
            ss = scores.get(qid) if scores else None
            for rank, doc in enumerate(docs):
                score = ss[rank] if ss is not None else float(len(docs) - rank)
                f.write(f"{qid} Q0 {doc} {rank + 1} {score:.6f} {tag}\n")


def read_trec_run(path: str) -> tuple[dict, dict]:
    """-> (run {qid: [doc_id...]} best-first, scores {qid: [float...]})."""
    rows: dict[str, list[tuple[float, str]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, doc, _, score, _ = parts[:6]
            rows.setdefault(qid, []).append((float(score), doc))
    run: dict[str, list[str]] = {}
    scores: dict[str, list[float]] = {}
    for qid, items in rows.items():
        items.sort(key=lambda x: -x[0])
        run[qid] = [d for _, d in items]
        scores[qid] = [s for s, _ in items]
    return run, scores

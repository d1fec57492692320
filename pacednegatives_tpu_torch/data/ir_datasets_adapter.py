"""ir_datasets -> TSV interchange adapter.

The reference ingests MS MARCO directly through ``ir_datasets``
(dataloader.py:20-21: corpus.docs_iter()/queries_iter() into pandas dicts;
train/eta.py:53-62). This environment does not ship ir_datasets, so the core
framework reads a plain TSV/JSONL interchange instead; this adapter produces
that interchange FROM ir_datasets when the package is available (e.g. on a
user's machine), closing the workflow gap without making the core depend on
it.

Output layout (what every cli.train*/cli.build_pools flag expects):
  docs.tsv     doc_id \t text
  queries.tsv  query_id \t text
  qrels.tsv    query_id \t doc_id \t relevance      (for eval)
  pairs.tsv    query_id \t doc_id_a                 (docpairs positives)
"""

from __future__ import annotations

import os


def _clean(text: str) -> str:
    """Mirror of data.tools.clean_text (reference util.py:5-7): TSV-safe."""
    return " ".join(str(text).split())


def export_ir_dataset(
    dataset_id: str,
    out_dir: str,
    max_docs: int | None = None,
    max_queries: int | None = None,
) -> dict:
    """Export an ir_datasets dataset to the TSV interchange. Returns the
    file paths written. Raises ImportError with a clear message when
    ir_datasets is not installed."""
    try:
        import ir_datasets
    except ImportError as e:  # pragma: no cover - exercised only when absent
        raise ImportError(
            "ir_datasets is not installed in this environment; install it or "
            "provide docs.tsv/queries.tsv directly (see module docstring)"
        ) from e

    ds = ir_datasets.load(dataset_id)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    docs_path = os.path.join(out_dir, "docs.tsv")
    with open(docs_path, "w") as f:
        for i, doc in enumerate(ds.docs_iter()):
            if max_docs is not None and i >= max_docs:
                break
            f.write(f"{doc.doc_id}\t{_clean(doc.text)}\n")
    paths["docs"] = docs_path

    queries_path = os.path.join(out_dir, "queries.tsv")
    with open(queries_path, "w") as f:
        for i, q in enumerate(ds.queries_iter()):
            if max_queries is not None and i >= max_queries:
                break
            f.write(f"{q.query_id}\t{_clean(q.text)}\n")
    paths["queries"] = queries_path

    if ds.has_qrels():
        qrels_path = os.path.join(out_dir, "qrels.tsv")
        with open(qrels_path, "w") as f:
            for qrel in ds.qrels_iter():
                f.write(f"{qrel.query_id}\t{qrel.doc_id}\t{qrel.relevance}\n")
        paths["qrels"] = qrels_path

    if ds.has_docpairs():
        pairs_path = os.path.join(out_dir, "pairs.tsv")
        with open(pairs_path, "w") as f:
            for pair in ds.docpairs_iter():
                f.write(f"{pair.query_id}\t{pair.doc_id_a}\n")
        paths["pairs"] = pairs_path

    return paths

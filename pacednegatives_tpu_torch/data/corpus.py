"""Text corpus: doc/query id -> text stores.

Replaces the reference's per-trainer pandas materialization of the whole
ir_datasets corpus into Python dicts (dataloader.py:20-21 — done once per
TripletDataset instance, i.e. repeatedly). Here the corpus is loaded once,
and downstream stages consume integer row indices instead of string ids.
"""

from __future__ import annotations

import dataclasses
import gzip
import json

import numpy as np


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


@dataclasses.dataclass
class TextCorpus:
    doc_ids: list[str]
    doc_texts: list[str]
    query_ids: list[str]
    query_texts: list[str]

    def __post_init__(self):
        self.doc_index = {d: i for i, d in enumerate(self.doc_ids)}
        self.query_index = {q: i for i, q in enumerate(self.query_ids)}

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_queries(self) -> int:
        return len(self.query_ids)

    def doc_text(self, doc_id: str) -> str:
        return self.doc_texts[self.doc_index[doc_id]]

    def query_text(self, query_id: str) -> str:
        return self.query_texts[self.query_index[query_id]]

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_tsv(cls, docs_path: str, queries_path: str) -> "TextCorpus":
        """TSV files with ``id<TAB>text`` rows (MS MARCO collection format)."""

        def read(path):
            ids, texts = [], []
            with _open(path) as f:
                for line in f:
                    i, _, t = line.rstrip("\n").partition("\t")
                    ids.append(i)
                    texts.append(t)
            return ids, texts

        d_ids, d_texts = read(docs_path)
        q_ids, q_texts = read(queries_path)
        return cls(d_ids, d_texts, q_ids, q_texts)

    @classmethod
    def from_jsonl(cls, docs_path: str, queries_path: str) -> "TextCorpus":
        """JSONL with {"doc_id"|"query_id": ..., "text": ...} rows."""

        def read(path, key):
            ids, texts = [], []
            with _open(path) as f:
                for line in f:
                    r = json.loads(line)
                    ids.append(str(r[key]))
                    texts.append(r["text"])
            return ids, texts

        d_ids, d_texts = read(docs_path, "doc_id")
        q_ids, q_texts = read(queries_path, "query_id")
        return cls(d_ids, d_texts, q_ids, q_texts)

    @classmethod
    def synthetic(
        cls,
        num_docs: int = 256,
        num_queries: int = 32,
        seed: int = 0,
        doc_len: int = 24,
        query_len: int = 5,
    ) -> "TextCorpus":
        """Deterministic word-salad corpus for tests and benchmarks, with a
        planted relevance signal: query q shares its topic words with docs
        whose index % num_queries == q."""
        rng = np.random.default_rng(seed)
        vocab = [f"w{i}" for i in range(500)]
        topics = [
            [f"topic{q}_{j}" for j in range(3)] for q in range(num_queries)
        ]
        doc_ids, doc_texts = [], []
        for d in range(num_docs):
            topic = topics[d % num_queries]
            words = list(rng.choice(vocab, size=doc_len)) + list(topic)
            rng.shuffle(words)
            doc_ids.append(f"d{d}")
            doc_texts.append(" ".join(words))
        query_ids, query_texts = [], []
        for q in range(num_queries):
            words = list(rng.choice(vocab, size=query_len)) + topics[q][:2]
            query_ids.append(f"q{q}")
            query_texts.append(" ".join(words))
        return cls(doc_ids, doc_texts, query_ids, query_texts)

"""Distillation batcher: interleaved (pos, neg) prompts + teacher scores.

Parity with the reference TeacherLoader (distill/loader.py:6-69): batch i
yields 2*B prompts in interleaved (pos, neg, pos, neg, ...) order and a
(2B, T) matrix of per-teacher scores; missing scores default to 1. for
positives / 0. for negatives.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.data.pipeline import TokenizedStore
from pacednegatives_tpu_torch.distill.teacher import TeacherScores


def load_triples_tsv(path: str) -> list[dict]:
    """qid<TAB>doc_id_a<TAB>doc_id_b rows with a header (reference
    mine_negatives.py output format)."""
    out = []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        cols = {c: i for i, c in enumerate(header)}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            out.append(
                {
                    "qid": parts[cols["qid"]],
                    "doc_id_a": parts[cols["doc_id_a"]],
                    "doc_id_b": parts[cols["doc_id_b"]],
                }
            )
    return out


@dataclasses.dataclass
class TeacherBatcher:
    triples: Sequence[dict]  # {qid, doc_id_a, doc_id_b}
    corpus: TextCorpus
    store: TokenizedStore
    teacher: TeacherScores
    batch_size: int = 16

    def __len__(self) -> int:
        return len(self.triples)

    @property
    def num_batches(self) -> int:
        return len(self.triples) // self.batch_size

    def get_batch(self, batch_idx: int):
        """-> dict(ids (2B, L), mask, labels (2B, 2) true/false alternating,
        teachers (2B, T))."""
        s = batch_idx * self.batch_size
        rows = self.triples[s : s + self.batch_size]
        B = len(rows)

        q_rows = np.empty(2 * B, np.int64)
        d_rows = np.empty(2 * B, np.int64)
        scores = np.empty((2 * B, self.teacher.num_teachers), np.float32)
        for i, r in enumerate(rows):
            q = self.corpus.query_index[r["qid"]]
            q_rows[2 * i] = q_rows[2 * i + 1] = q
            d_rows[2 * i] = self.corpus.doc_index[r["doc_id_a"]]
            d_rows[2 * i + 1] = self.corpus.doc_index[r["doc_id_b"]]
            scores[2 * i] = self.teacher.lookup(r["qid"], r["doc_id_a"], neg=False)
            scores[2 * i + 1] = self.teacher.lookup(r["qid"], r["doc_id_b"], neg=True)

        ids, mask = self.store.assemble_host(q_rows, d_rows)
        # alternating true/false labels (reference wrapper.py gen_labels)
        labels = np.empty((2 * B, 2), np.int32)
        labels[0::2] = self.store.labels(B, True)
        labels[1::2] = self.store.labels(B, False)
        return {
            "ids": ids,
            "mask": mask,
            "labels": labels,
            "teachers": scores,
        }

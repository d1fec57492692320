"""Evaluation: monoT5 reranking on the device (``Reranker``) and the host
copies of the JAX package's ``eval/{metrics,run_io,experiment}.py``, with
only their import lines rewritten."""

from pacednegatives_tpu_torch.eval.metrics import (
    average_precision,
    ndcg_at_k,
    reciprocal_rank,
    recall_at_k,
    precision_at_k,
    evaluate_run,
)
from pacednegatives_tpu_torch.eval.experiment import experiment
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.eval.run_io import read_trec_run, write_trec_run

__all__ = [
    "average_precision",
    "ndcg_at_k",
    "reciprocal_rank",
    "recall_at_k",
    "precision_at_k",
    "evaluate_run",
    "experiment",
    "Reranker",
    "read_trec_run",
    "write_trec_run",
]

from pacednegatives_tpu_torch.eval.rerank import Reranker

__all__ = ["Reranker"]

"""Retrieval indexes (the port of index/): the dense index on one device."""

from pacednegatives_tpu_torch.index.dense import DenseIndex

__all__ = ["DenseIndex"]

"""Retrieval indexes (the port of index/): the dense index (on one device,
or sharded over a mesh's ranks);
``index/sparse.py`` (the quantized impact index of SPLADE pools) is a host
copy of the JAX package's numpy module."""

from pacednegatives_tpu_torch.index.dense import DenseIndex

__all__ = ["DenseIndex"]

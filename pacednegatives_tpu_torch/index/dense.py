"""Dense retrieval index: the port of index/dense.py.

Embeddings live on the device; queries are answered by MIPS top-k (K5, or
K6 over an int8 index) or by the exact path. Pools are EASIEST FIRST, as
data/triples.py orders them: top-k returns hardest first (highest score =
most query-similar = hardest negative; the reference's
compute_all_bm25.py:43-44 reverses exactly like this), so pools are the
reversed top-k.

With a mesh (``mesh=``, dense.py:119-185) each rank keeps its contiguous
shard of the rows, over the mesh's rows (data x seq: the JAX index shards
over data and replicates over seq, with the same top-k), and answers a
query with the top min(k, shard rows) of its shard (K5, K6 or the exact
path, as without a mesh), its doc indices offset to global ones, then an
all-gather of every shard's candidates and one merge
(parallel/collectives.merge_topk): every rank gets the global top-k.
``method="approx"`` (``lax.approx_max_k``) is not carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from pacednegatives_tpu_torch.ops.mips import (
    mips_topk_approx,
    mips_topk_exact,
    mips_topk_pallas,
    mips_topk_pallas_quantized,
    mips_topk_quantized_streaming,
    quantize_embeddings,
)
from pacednegatives_tpu_torch.parallel.collectives import merge_topk
from pacednegatives_tpu_torch.parallel.mesh import shard_range


def _topk(method: str, queries, docs, k, **kw):
    if method == "pallas":
        return mips_topk_pallas(queries, docs, k, **kw)
    if method == "exact":
        return mips_topk_exact(queries, docs, k)
    if method == "approx":
        return mips_topk_approx(queries, docs, k, **kw)
    raise ValueError(method)


@dataclasses.dataclass
class DenseIndex:
    """embeddings: (N, D) fp32 / bf16 tensor on one device (with a mesh,
    this rank's (N / ranks, D) shard). With ``quantize=True`` the index
    holds int8 values + fp32 per-row scales (4x less device memory;
    dequantisation fused into K6 with ``method="pallas"``, or streamed a
    slab at a time with "exact")."""

    embeddings: torch.Tensor
    method: str = "exact"  # "pallas" | "exact"
    mesh: object | None = None  # parallel.mesh.Mesh: sharded over its rows
    method_kwargs: dict = dataclasses.field(default_factory=dict)
    scales: torch.Tensor | None = None  # set when quantized (int8 values)

    @property
    def shard_docs(self) -> int:
        return self.embeddings.shape[0]

    @property
    def num_docs(self) -> int:
        ranks = 1 if self.mesh is None else self.mesh.row_size
        return self.shard_docs * ranks

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @classmethod
    def build(cls, embeddings: torch.Tensor, method: str = "exact",
              mesh=None, quantize: bool = False,
              device: torch.device | str = "cuda",
              **method_kwargs) -> "DenseIndex":
        """Put ``embeddings`` (all N rows) on ``device``, quantised there
        when asked; with a ``mesh``, only this rank's shard (N must
        divide). The default is the card; pass ``device="cpu"`` for the
        CPU (there is no fallback)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DenseIndex.build(device='cuda'): torch.cuda.is_available() "
                "is false; pass device='cpu' to index on the CPU")
        lo, hi = shard_range(embeddings.shape[0], mesh)
        embeddings = embeddings[lo:hi].to(device)
        scales = None
        if quantize:
            embeddings, scales = quantize_embeddings(embeddings)
        return cls(embeddings, method, mesh, method_kwargs, scales)

    def _docs_fp(self) -> torch.Tensor:
        if not self.quantized:
            return self.embeddings
        return self.embeddings.float() * self.scales[:, None]

    # -- queries --------------------------------------------------------------

    def topk(self, queries: torch.Tensor, k: int):
        """(B, D) queries -> (scores (B, k) fp32, int64 doc indices (B, k)),
        descending, with the dispatch of dense.py:95-117; with a mesh, the
        same on every rank (the queries must be too)."""
        queries = queries.to(self.embeddings.device)
        if self.mesh is None:
            return self._shard_topk(queries, k)
        # a shard can give at most its row count of candidates; the merge
        # still yields the global top-k for any k <= num_docs
        v, i = self._shard_topk(queries, min(k, self.shard_docs))
        return merge_topk(v, i + self.mesh.row_rank * self.shard_docs, k,
                          self.mesh)

    def _shard_topk(self, queries: torch.Tensor, k: int):
        if self.quantized and self.method == "pallas":
            return mips_topk_pallas_quantized(
                queries, self.embeddings, self.scales, k, **self.method_kwargs)
        if self.quantized and self.method == "exact":
            # streaming dequantise: an O(slab) fp32 transient instead of a
            # full-index copy
            return mips_topk_quantized_streaming(
                queries, self.embeddings, self.scales, k)
        return _topk(self.method, queries, self._docs_fp(), k,
                     **self.method_kwargs)

    def mine_pools(self, queries: torch.Tensor, pool_size: int):
        """(B, D) queries -> (B, pool_size) doc indices ordered EASIEST
        FIRST (the reversed top-k, compute_all_bm25.py:44 parity)."""
        _, idx = self.topk(queries, pool_size)
        return idx.flip(1)

    # -- refresh ----------------------------------------------------------------

    def refreshed(self, new_embeddings: torch.Tensor) -> "DenseIndex":
        """A new index over ``new_embeddings`` on this index's device; the
        old one stays valid until dropped. A quantised index is
        re-quantised (stale per-row scales would corrupt every score). With
        a mesh, ``new_embeddings`` is this rank's shard, as
        train/online.make_refresh_fn and train/overlap produce it."""
        if new_embeddings.shape[0] != self.shard_docs:
            raise ValueError(
                f"refreshed takes this index's {self.shard_docs} rows (a "
                f"rank's shard under a mesh), got {new_embeddings.shape[0]}")
        new_embeddings = new_embeddings.to(self.embeddings.device)
        scales = None
        if self.quantized:
            new_embeddings, scales = quantize_embeddings(new_embeddings)
        return dataclasses.replace(self, embeddings=new_embeddings,
                                   scales=scales)

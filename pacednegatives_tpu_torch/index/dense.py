"""Dense retrieval index on one device: the port of index/dense.py.

Embeddings live on the device; queries are answered by MIPS top-k (K5, or
K6 over an int8 index) or by the exact path. Pools are EASIEST FIRST, as
data/triples.py orders them: top-k returns hardest first (highest score =
most query-similar = hardest negative; the reference's
compute_all_bm25.py:43-44 reverses exactly like this), so pools are the
reversed top-k.

The sharded index (``mesh=``, dense.py:119-185: shards over the mesh's
data axis, per-shard top-k, all-gather merge) is not ported yet: it waits
for ``parallel/*`` (ROADMAP.md slice R). ``method="approx"``
(``lax.approx_max_k``) is not carried over.
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


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "DenseIndex(mesh=...) (the sharded index) is not ported yet "
            "(ROADMAP.md slice R, with parallel/*); build it on one device")


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
    """embeddings: (N, D) fp32 / bf16 tensor on one device. With
    ``quantize=True`` the index holds int8 values + fp32 per-row scales (4x
    less device memory; dequantisation fused into K6 with
    ``method="pallas"``, or streamed a slab at a time with "exact")."""

    embeddings: torch.Tensor
    method: str = "exact"  # "pallas" | "exact"
    mesh: object | None = None  # not ported: must stay None
    method_kwargs: dict = dataclasses.field(default_factory=dict)
    scales: torch.Tensor | None = None  # set when quantized (int8 values)

    def __post_init__(self):
        _check_mesh(self.mesh)

    @property
    def num_docs(self) -> int:
        return self.embeddings.shape[0]

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @classmethod
    def build(cls, embeddings: torch.Tensor, method: str = "exact",
              mesh=None, quantize: bool = False,
              device: torch.device | str = "cuda",
              **method_kwargs) -> "DenseIndex":
        """Put ``embeddings`` on ``device`` (quantised there when asked).
        The default is the card; pass ``device="cpu"`` for the CPU (there
        is no fallback)."""
        _check_mesh(mesh)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DenseIndex.build(device='cuda'): torch.cuda.is_available() "
                "is false; pass device='cpu' to index on the CPU")
        embeddings = embeddings.to(device)
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
        descending, with the dispatch of dense.py:95-117."""
        queries = queries.to(self.embeddings.device)
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
        re-quantised (stale per-row scales would corrupt every score)."""
        new_embeddings = new_embeddings.to(self.embeddings.device)
        scales = None
        if self.quantized:
            new_embeddings, scales = quantize_embeddings(new_embeddings)
        return dataclasses.replace(self, embeddings=new_embeddings,
                                   scales=scales)

"""MIPS (maximum inner product search) top-k: the port of ops/mips.py.

``mips_topk_pallas`` (K5) and ``mips_topk_pallas_quantized`` (K6) compute
the TPU kernels' blockwise function: the docs are cut into blocks of
``block_n`` rows; each block yields the top-k' inner products of every
query (ties to the lower doc index); a merge over the (num_blocks * k')
candidates gives the top-k, descending, ties again to the lower candidate
position (block-major, then rank), which is the lower doc index. With
k' = k that is the exact top-k; with k' < k it is near-exact (it differs
only where more than k' of the true top-k fall in one block), and it
depends on ``block_n`` and k', as the JAX function does.

On a CUDA tensor each wrapper launches the hand-written kernels in
``csrc/mips_topk.cu`` or raises: fp32 docs (K5's ``build_pools`` use), bf16
docs and int8 docs (K6) go through tensor-core scores (3xTF32 for fp32; int8
widened to bf16 in registers, times the row's scale) and a radix select of
each (query, segment)'s top keys as a set (segments = the blocks when
k' < k; when k' >= k the function is the exact top-k and the segments are a
few long runs of rows). On a CPU tensor it runs the plain PyTorch version,
which computes the per-block top-k' with a stable sort.

The merge of the candidates packs each (value, doc index) into one int64
key whose signed order is (value descending, lower index first): the
value's bits with the magnitude flipped for negatives in the high word (so
-0 sorts below +0, as ``lax.top_k`` orders them), the complemented index in
the low word. The keys are unique, so ``torch.topk`` on them is exact and
needs no tie rule: it returns what a stable sort of the candidates by value
in (block, rank) order returns, without sorting them, on both devices.

Indices are returned as int64 (the JAX functions return int32).

Score arithmetic, as in the TPU kernels (mips.py:76-81, 154-159): fp32 docs
multiply fp32 queries in fp32 (the kernel: 3xTF32, ~2^-21 relative a
product; single-pass TF32 would change which docs win);
bf16 docs multiply the queries rounded to bf16, with fp32 sums; int8 docs
(``quantize_embeddings``) multiply the queries rounded fp32 -> bf16 as bf16
values, with fp32 sums times the row's fp32 scale.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch import kernels

# Docs dequantised or scored per plain-version slab: the fp32 transient is
# O(slab) (~200 MB at D 768), never the full index (27 GB at 8.8M x 768).
_PLAIN_SLAB_ROWS = 65536
# Keys a (query, segment) keeps, at most: the bound of the kernels before
# the set selection, kept so that the wrappers take the same arguments.
KERNEL_MAX_K_PER_BLOCK = 1024
# An H100's SMs: the selection's long segments aim at two CTAs each.
SM_COUNT = 132
_DOC_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, descending, ties to the lower position and
    -0 below +0: ``lax.top_k``'s order. A stable ``torch.sort`` holds -0
    and +0 equal, and ``torch.topk`` promises no tie order on CUDA, so the
    values and positions go through the merge's unique packed keys."""
    pos = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
    top = torch.topk(pack_keys(x, pos), k, dim=-1, sorted=True).values
    v, pos = unpack_keys(top)
    return v.to(x.dtype), pos


def _k_per_block(k: int, num_docs: int, block_n: int,
                 k_per_block: int | None) -> tuple[int, int]:
    """(num_blocks, k') exactly as mips.py:102-109 derives them."""
    if num_docs % block_n:
        raise ValueError(f"N={num_docs} not a multiple of block_n={block_n}")
    num_blocks = num_docs // block_n
    if k_per_block is None:
        k_per_block = min(k, block_n)
    # the merge needs num_blocks * k' >= k candidates
    k_per_block = max(k_per_block, -(-k // num_blocks))
    return num_blocks, min(k_per_block, block_n)


def pack_keys(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """int64 merge keys of (fp32 value, index < 2^31) pairs: signed order is
    value descending (-0 below +0), then the lower index."""
    bits = values.float().contiguous().view(torch.int32).long()
    high = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (high << 32) | (0xFFFFFFFF - indices.long())


def unpack_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fp32 values, int64 indices) of ``pack_keys``' keys."""
    high = keys >> 32
    bits = torch.where(high < 0, high ^ 0x7FFFFFFF, high).to(torch.int32)
    return bits.view(torch.float32), 0xFFFFFFFF - (keys & 0xFFFFFFFF)


def _merge_keys(keys: torch.Tensor, k: int):
    """(B, C) candidate keys -> the (B, k) top-k (values, indices),
    descending. On the card the unpack is one launch of
    ``pnt_mips_unpack_keys`` (``unpack_keys`` is a handful)."""
    top = torch.topk(keys, k, dim=1, sorted=True).values
    if top.device.type != "cuda":
        return unpack_keys(top)
    values = torch.empty(top.shape, dtype=torch.float32, device=top.device)
    indices = torch.empty(top.shape, dtype=torch.int64, device=top.device)
    rc = kernels.library().pnt_mips_unpack_keys(
        top.data_ptr(), values.data_ptr(), indices.data_ptr(), top.numel(),
        _device_index(top.device), torch.cuda.current_stream(top.device)
        .cuda_stream)
    kernels.check(rc, "mips_unpack_keys")
    return values, indices


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """(num_blocks, B, k') per-block candidates -> global (B, k) top-k
    (mips.py:64-70), with the int64 doc indices."""
    num_blocks, B, kpb = cand_v.shape
    keys = pack_keys(cand_v, cand_i).transpose(0, 1)
    return _merge_keys(keys.reshape(B, num_blocks * kpb), k)


def _query_operand(queries: torch.Tensor, doc_dtype: torch.dtype):
    """The queries as the kernels multiply them: fp32 for fp32 docs, else
    rounded to bf16 (int8 docs: fp32 first, as mips.py:208 then :155)."""
    if doc_dtype == torch.float32:
        return queries.float()
    return queries.float().to(torch.bfloat16)


def block_scores(queries: torch.Tensor, docs: torch.Tensor,
                 scales: torch.Tensor | None = None) -> torch.Tensor:
    """(B, rows) fp32 scores of some doc rows in the kernels' arithmetic
    (the queries rounded as ``docs.dtype`` asks): the bf16 / int8 values
    are exact in fp32, so an fp32 product of them is the bf16 product with
    fp32 sums. int8 rows need their ``scales``."""
    q_op = _query_operand(queries, docs.dtype)
    s = torch.matmul(q_op.float(), docs.float().t())
    return s if scales is None else s * scales.float()[None, :]


def _blockwise_plain(queries, docs, scales, k, block_n, k_per_block):
    num_blocks, kpb = _k_per_block(k, docs.shape[0], block_n, k_per_block)
    B = queries.shape[0]
    per = max(1, _PLAIN_SLAB_ROWS // block_n)
    cand_v, cand_i = [], []
    for b0 in range(0, num_blocks, per):
        nbs = min(per, num_blocks - b0)
        r0, r1 = b0 * block_n, (b0 + nbs) * block_n
        s = block_scores(queries, docs[r0:r1],
                         None if scales is None else scales[r0:r1])
        v, pos = topk_stable(s.view(B, nbs, block_n).transpose(0, 1), kpb)
        base = torch.arange(b0, b0 + nbs, device=docs.device) * block_n
        cand_v.append(v)
        cand_i.append(pos + base[:, None, None])
    return _merge_candidates(torch.cat(cand_v), torch.cat(cand_i), k)


def mips_topk_pallas_plain(queries: torch.Tensor, docs: torch.Tensor, k: int,
                           block_n: int = 1024,
                           k_per_block: int | None = None):
    """Plain PyTorch version of ``mips_topk_pallas`` (K5): the same
    per-block top-k' and merge, a slab of blocks at a time."""
    return _blockwise_plain(queries, docs, None, k, block_n, k_per_block)


def mips_topk_pallas_quantized_plain(queries: torch.Tensor,
                                     d_values: torch.Tensor,
                                     d_scales: torch.Tensor, k: int,
                                     block_n: int = 1024,
                                     k_per_block: int | None = None):
    """Plain PyTorch version of ``mips_topk_pallas_quantized`` (K6). One
    slab of blocks is dequantised at a time: no fp32 copy of the index."""
    return _blockwise_plain(queries, d_values, d_scales, k, block_n,
                            k_per_block)


def _launch(queries, docs, scales, k, block_n, k_per_block, name):
    """Check the operands, launch the kernels and merge their candidates."""
    return _merge_keys(
        _kernel_candidates(queries, docs, scales, k, block_n, k_per_block,
                           name), k)


def set_segments(B: int, N: int, block_n: int, k: int, kpb: int,
                 fold: bool | None = None) -> tuple[int, int, int]:
    """(rows a segment, segments, keys kept a segment) of the kernels'
    selection. k' < k: the blocks, k' each. k' >= k (or ``fold``):
    the blockwise function is the exact top-k, so the rows are cut into a
    few long runs, about two CTAs an SM over the B queries, each at least k
    rows (a multiple of 4, for 16-byte loads), and each keeps k."""
    if fold is None:
        fold = kpb >= k
    if not fold:
        return block_n, N // block_n, kpb
    parts = max(1, min(-(-2 * SM_COUNT // B), N // k))
    seg = -(-N // parts)
    seg = min(N, -(-seg // 4) * 4)
    return seg, -(-N // seg), k


def _kernel_candidates(queries, docs, scales, k, block_n, k_per_block, name,
                       fold: bool | None = None):
    """Check the operands and launch the kernels once: the (B, C) candidate
    keys before the merge. ``fold`` forces the segments:
    the blocks (False) or long runs of rows (True); None picks by k' >= k."""
    dev = queries.device
    if dev.type != "cuda" or docs.device != dev or (
            scales is not None and scales.device != dev):
        raise ValueError(f"{name}: operands must share one CUDA device")
    if docs.dtype not in _DOC_TYPES:
        raise TypeError(f"{name}: docs must be fp32, bf16 or int8, "
                        f"got {docs.dtype}")
    if queries.dim() != 2 or docs.dim() != 2 or (
            queries.shape[1] != docs.shape[1]):
        raise ValueError(f"{name}: queries (B, D) and docs (N, D), got "
                         f"{tuple(queries.shape)} and {tuple(docs.shape)}")
    B, D = queries.shape
    N = docs.shape[0]
    num_blocks, kpb = _k_per_block(k, N, block_n, k_per_block)
    if D % 16 or B == 0 or kpb > KERNEL_MAX_K_PER_BLOCK or N >= 2**31:
        raise ValueError(
            f"{name}: the kernel needs D % 16 == 0, B > 0, "
            f"k' <= {KERNEL_MAX_K_PER_BLOCK} and N < 2^31 "
            f"(D={D}, B={B}, k'={kpb}, N={N})")
    if k > N:
        raise ValueError(f"{name}: k={k} > N={N}")
    if B > 65535:
        raise ValueError(f"{name}: the kernel takes B <= 65535")
    docs = docs.contiguous()
    q = queries.float().contiguous()
    # scratch for the queries as the score kernel reads them (fp32: tf32
    # high parts and residuals; bf16; int8: bf16, padded to 128 columns)
    fp32 = docs.dtype == torch.float32
    qcols = -(-D // 128) * 128 if docs.dtype == torch.int8 else D
    q_hi = torch.empty((B, qcols), dtype=q.dtype if fp32 else torch.bfloat16,
                       device=dev)
    q_lo = torch.empty_like(q) if fp32 else None
    if scales is not None:
        scales = scales.float().contiguous()
    seg, nseg, kk = set_segments(B, N, block_n, k, kpb, fold)
    scores = torch.empty((B, N), dtype=torch.float32, device=dev)
    cand = torch.empty((B, nseg, kk), dtype=torch.int64, device=dev)
    rc = kernels.library().pnt_mips_topk_sets(
        q.data_ptr(), q_hi.data_ptr(),
        q_lo.data_ptr() if q_lo is not None else None, docs.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        scores.data_ptr(), cand.data_ptr(), B, N, D, seg, nseg, kk,
        _DOC_TYPES[docs.dtype], _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, name)
    return cand.view(B, nseg * kk)


def mips_topk_pallas(queries: torch.Tensor, docs: torch.Tensor, k: int,
                     block_n: int = 1024, k_per_block: int | None = None):
    """Top-k inner products of each query against all docs (K5).

    queries (B, D); docs (N, D) fp32 or bf16, N a multiple of block_n
    (pad docs with zero rows if needed). Returns (scores (B, k) fp32,
    int64 indices (B, k)), descending. CPU: the plain version; CUDA: the
    kernel (fp32 docs need D % 16 == 0 too, and k' <= 1024)."""
    if queries.device.type == "cpu":
        return mips_topk_pallas_plain(queries, docs, k, block_n, k_per_block)
    if docs.dtype == torch.int8:
        raise TypeError("mips_topk_pallas: int8 docs go through "
                        "mips_topk_pallas_quantized (they need scales)")
    out = _launch(queries, docs, None, k, block_n, k_per_block,
                  "mips_topk_pallas")
    mips_topk_pallas.launches += 1
    return out


mips_topk_pallas.launches = 0  # kernel launches; the CPU route not counted


def mips_topk_pallas_quantized(queries: torch.Tensor, d_values: torch.Tensor,
                               d_scales: torch.Tensor, k: int,
                               block_n: int = 1024,
                               k_per_block: int | None = None):
    """Top-k over an int8-quantised index (K6): (N, D) int8 values and
    (N,) fp32 scales from ``quantize_embeddings``, dequantisation fused
    into the scores (never an fp32 or bf16 copy of the index)."""
    if queries.device.type == "cpu":
        return mips_topk_pallas_quantized_plain(queries, d_values, d_scales,
                                                k, block_n, k_per_block)
    if d_values.dtype != torch.int8:
        raise TypeError(f"mips_topk_pallas_quantized: values must be int8, "
                        f"got {d_values.dtype}")
    if d_scales.shape != (d_values.shape[0],):
        raise ValueError("mips_topk_pallas_quantized: one scale per row")
    out = _launch(queries, d_values, d_scales, k, block_n, k_per_block,
                  "mips_topk_pallas_quantized")
    mips_topk_pallas_quantized.launches += 1
    return out


mips_topk_pallas_quantized.launches = 0  # the CPU route not counted


def quantize_embeddings(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation (mips.py:141-148): (N, D) ->
    (int8 values, fp32 scales (N,)). ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    x = emb.float()
    scale = x.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.round(x / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def mips_topk_quantized_streaming(queries: torch.Tensor,
                                  d_values: torch.Tensor,
                                  d_scales: torch.Tensor, k: int,
                                  block_rows: int = 65536):
    """Exact top-k over an int8 index without an fp32 copy of it
    (mips.py:213-270): one ``block_rows`` slab is dequantised and scored at
    a time (an O(slab) fp32 transient), each slab keeps its top
    min(k, slab), then one merge. Rows past the last full slab are one
    direct ragged slab. Exact; any N."""
    B, _ = queries.shape
    N = d_values.shape[0]
    q = queries.float()
    bs = min(block_rows, N)
    main = (N // bs) * bs
    cand_v, cand_i = [], []
    for r0 in range(0, N, bs):
        r1 = r0 + bs if r0 < main else N
        docs = d_values[r0:r1].float() * d_scales[r0:r1].float()[:, None]
        v, pos = topk_stable(torch.matmul(q, docs.t()), min(k, r1 - r0))
        cand_v.append(v)
        cand_i.append(pos + r0)
        if r1 == N:
            break
    v, pos = topk_stable(torch.cat(cand_v, dim=1), k)
    return v, torch.gather(torch.cat(cand_i, dim=1), 1, pos).long()


def mips_topk_exact(queries: torch.Tensor, docs: torch.Tensor, k: int):
    """Full fp32 scores + exact top-k (mips.py:273-278; jnp.einsum promotes
    bf16 docs against fp32 queries to fp32)."""
    scores = torch.matmul(queries.float(), docs.float().t())
    v, i = topk_stable(scores, k)
    return v, i.long()


def mips_topk_approx(queries, docs, k, recall_target: float = 0.95):
    """``lax.approx_max_k`` is TPU-native and not carried over."""
    raise NotImplementedError(
        "mips_topk_approx (lax.approx_max_k) is not carried over to the "
        "PyTorch package (ROADMAP.md 'Not carried over'); use method "
        "'pallas' or 'exact'")

"""The port's MIPS top-k (pacednegatives_tpu_torch/ops/mips.py) against the
JAX package's, on the CPU: the plain versions of K5 and K6 against the
Pallas kernels in interpret mode (as tests/test_index.py runs them), the
tie order on duplicate doc rows, and the non-kernel paths.

Each Pallas call in interpret mode costs ~1.3 s, so the six cases below are
the only ones, each computed once and shared by the tests of this file.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import mips as jmips
from pacednegatives_tpu_torch.ops import mips

N, D, B, BLOCK, K = 1024, 64, 8, 256, 16
# tolerance: fp32 sums of 64 products in another order (and XLA's dot
# against torch's), far below 1e-5 of the largest score
VAL_RTOL = 1e-5


@functools.cache
def _data():
    """Gaussian docs and queries with planted duplicate rows: doc ``a``
    (block 1) is query 0 itself, its best match by far (|q|^2 ~ 64 against
    gaussian scores of std 8), copied to a + 7 (same block) and into blocks
    0 and 3, so four docs tie at the top of query 0's list."""
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    a = BLOCK + 50
    copies = (37, a + 7, 3 * BLOCK + 100)
    for c in (a, *copies):
        docs[c] = q[0]
    return q, docs, tuple(sorted((a, *copies)))


def _docs(dtype: str) -> np.ndarray:
    _, docs, _ = _data()
    if dtype == "bf16":  # values exactly representable in bf16 on both sides
        return np.array(jnp.asarray(docs, jnp.bfloat16).astype(jnp.float32))
    return docs


@functools.cache
def _jax_k5(dtype: str, kpb: int):
    q, _, _ = _data()
    jd = jnp.asarray(_docs(dtype),
                     jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    v, i = jmips.mips_topk_pallas(jnp.asarray(q), jd, K, block_n=BLOCK,
                                  k_per_block=kpb, interpret=True)
    return np.asarray(v), np.asarray(i)


@functools.cache
def _jax_k6(kpb: int):
    q, docs, _ = _data()
    vals, scales = jmips.quantize_embeddings(jnp.asarray(docs))
    v, i = jmips.mips_topk_pallas_quantized(
        jnp.asarray(q), vals, scales, K, block_n=BLOCK, k_per_block=kpb,
        interpret=True)
    return np.asarray(v), np.asarray(i), np.array(vals), np.array(scales)


def _torch_k5(dtype: str, kpb: int):
    q, _, _ = _data()
    td = torch.from_numpy(_docs(dtype))
    if dtype == "bf16":
        td = td.to(torch.bfloat16)
    before = mips.mips_topk_pallas.launches
    v, i = mips.mips_topk_pallas(torch.from_numpy(q), td, K, block_n=BLOCK,
                                 k_per_block=kpb)
    assert mips.mips_topk_pallas.launches == before  # the CPU runs plain
    return v.numpy(), i.numpy()


def _torch_k6(kpb: int, vals: np.ndarray, scales: np.ndarray):
    q, _, _ = _data()
    v, i = mips.mips_topk_pallas_quantized(
        torch.from_numpy(q), torch.from_numpy(vals), torch.from_numpy(scales),
        K, block_n=BLOCK, k_per_block=kpb)
    return v.numpy(), i.numpy()


def _assert_same(got, want):
    (v, i), (jv, ji) = got, want
    assert i.dtype == np.int64 and v.shape == jv.shape == (B, K)
    np.testing.assert_allclose(v, jv, rtol=0,
                               atol=VAL_RTOL * np.abs(jv).max())
    np.testing.assert_array_equal(i, ji)


# k' = K is exact; k' = 5 < K is the near-exact blockwise function
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kpb", [K, 5])
def test_k5_plain_matches_pallas(dtype, kpb):
    _assert_same(_torch_k5(dtype, kpb), _jax_k5(dtype, kpb))


@pytest.mark.parametrize("kpb", [K, 5])
def test_k6_plain_matches_pallas(kpb):
    jv, ji, vals, scales = _jax_k6(kpb)
    _assert_same(_torch_k6(kpb, vals, scales), (jv, ji))


@pytest.mark.parametrize("kernel", ["k5_fp32", "k5_bf16", "k6"])
def test_duplicate_rows_lower_index_first(kernel):
    """Four copies of one doc (two in one block, two in other blocks) tie
    exactly; both packages list them first, in ascending index order."""
    _, _, dup = _data()
    if kernel == "k6":
        jv, ji, vals, scales = _jax_k6(5)
        tv, ti = _torch_k6(5, vals, scales)
    else:
        dtype = kernel.split("_")[1]
        (jv, ji), (tv, ti) = _jax_k5(dtype, 5), _torch_k5(dtype, 5)
    for v, i in ((jv, ji), (tv, ti)):
        assert tuple(i[0, :4]) == dup
        assert len(set(v[0, :4].tolist())) == 1 and v[0, 4] < v[0, 0]


def test_topk_stable_ties_to_lower_position():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = mips.topk_stable(x, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3, 3, 3, 2]]


def test_quantize_embeddings_bitwise_equal_to_jax():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(300, 48)).astype(np.float32)
    emb[7] = 0.0  # an all-zero row takes the 1e-8 floor
    jv, js = jmips.quantize_embeddings(jnp.asarray(emb))
    tv, ts = mips.quantize_embeddings(torch.from_numpy(emb))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_streaming_and_exact_match_jax():
    rng = np.random.default_rng(11)
    n, d, b, k = 1000 + 37, 32, 5, 20  # 1037 % 256 != 0: the ragged tail
    docs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    jvals, jscales = jmips.quantize_embeddings(jnp.asarray(docs))
    jv, ji = jmips.mips_topk_quantized_streaming(jnp.asarray(q), jvals,
                                                 jscales, k, block_rows=256)
    tv, ti = mips.mips_topk_quantized_streaming(
        torch.from_numpy(q), torch.from_numpy(np.array(jvals)),
        torch.from_numpy(np.array(jscales)), k, block_rows=256)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jd = jnp.asarray(docs, dt)
        ev, ei = jmips.mips_topk_exact(jnp.asarray(q), jd, k)
        td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(tdt)
        tv, ti = mips.mips_topk_exact(torch.from_numpy(q), td, k)
        np.testing.assert_allclose(tv.numpy(), np.asarray(ev), rtol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ei))


@pytest.mark.parametrize("fn", ["k5", "k6"])
def test_wrappers_reject_unaligned_rows(fn):
    q = torch.zeros((2, 16))
    if fn == "k5":
        with pytest.raises(ValueError, match="multiple of block_n"):
            mips.mips_topk_pallas(q, torch.zeros((1000, 16)), 8,
                                  block_n=256)
    else:
        with pytest.raises(ValueError, match="multiple of block_n"):
            mips.mips_topk_pallas_quantized(
                q, torch.zeros((1000, 16), dtype=torch.int8),
                torch.ones(1000), 8, block_n=256)


def test_k_per_block_raised_for_the_merge():
    """One 256-row block with k 40 > k' 8: k' is raised to ceil(k / nb) =
    40 so the merge has k candidates (mips.py:107-109)."""
    rng = np.random.default_rng(5)
    docs = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    v, i = mips.mips_topk_pallas(q, docs, 40, block_n=256, k_per_block=8)
    ev, ei = mips.mips_topk_exact(q, docs, 40)
    assert torch.equal(i, ei) and torch.equal(v, ev)


def test_approx_is_not_carried_over():
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        mips.mips_topk_approx(torch.zeros((1, 4)), torch.zeros((8, 4)), 2)


# ---------------------------------------------------------------------------
# The merge on packed int64 keys
# ---------------------------------------------------------------------------

MERGE_NB, MERGE_BN, MERGE_B = 4, 64, 3


def _candidates(feature: str, kpb: int, seed: int = 0):
    """(num_blocks, B, k') candidates as the per-block stage emits them:
    distinct doc indices of each block, ordered by value (descending, -0
    and +0 equal, as the TPU kernel's == compares them) and then by the
    lower index. Values on a coarse grid, so exact ties fall inside and
    across blocks; ``feature`` adds signed zeros or -inf."""
    rng = np.random.default_rng(seed)
    cv = np.empty((MERGE_NB, MERGE_B, kpb), np.float32)
    ci = np.empty((MERGE_NB, MERGE_B, kpb), np.int32)
    for b in range(MERGE_NB):
        for r in range(MERGE_B):
            idx = rng.choice(MERGE_BN, kpb, replace=False) + b * MERGE_BN
            val = (rng.integers(-3, 4, kpb) / 4).astype(np.float32)
            if feature == "signed_zero":
                val[rng.random(kpb) < 0.5] = 0.0
                val[rng.random(kpb) < 0.5] *= -1  # -0 beside +0
            elif feature == "neg_inf":
                val[rng.random(kpb) < 0.3] = -np.inf
            order = np.lexsort((idx, -val))
            cv[b, r], ci[b, r] = val[order], idx[order]
    return cv, ci


def _stable_sort_merge(cv, ci, k):
    """The merge before packed keys: a stable sort of the candidates in
    (block, rank) order."""
    nb, B, kpb = cv.shape
    v, pos = torch.sort(
        torch.from_numpy(cv).transpose(0, 1).reshape(B, nb * kpb), dim=-1,
        descending=True, stable=True)
    v, pos = v[:, :k], pos[:, :k]
    i = torch.gather(torch.from_numpy(ci).transpose(0, 1).reshape(
        B, nb * kpb), 1, pos)
    return v.numpy(), i.long().numpy()


@pytest.mark.parametrize("feature", ["ties", "signed_zero", "neg_inf"])
@pytest.mark.parametrize("kpb,k", [(12, 12), (5, 12)])
def test_packed_key_merge_matches_jax_and_stable_sort(feature, kpb, k):
    """The packed-key merge, fed each block's candidates in a shuffled
    order (the fp32 kernel emits sets), equals JAX's ``_merge_candidates``
    on the ordered candidates, bit for bit (the sign of zero included), and
    equals the stable-sort merge except where -0 and +0 meet: torch.sort
    holds them equal, lax.top_k (the reference) puts -0 below +0."""
    cv, ci = _candidates(feature, kpb)
    jv, ji = jmips._merge_candidates(jnp.asarray(cv), jnp.asarray(ci), k)
    jv, ji = np.asarray(jv), np.asarray(ji)
    perm = np.random.default_rng(1).permuted(
        np.broadcast_to(np.arange(kpb), cv.shape), axis=2)
    sv = np.take_along_axis(cv, perm, axis=2)
    si = np.take_along_axis(ci, perm, axis=2)
    v, i = mips._merge_candidates(torch.from_numpy(sv), torch.from_numpy(si),
                                  k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(i.numpy(), ji)
    ov, oi = _stable_sort_merge(cv, ci, k)
    np.testing.assert_array_equal(ov, jv)  # -0 == +0 here
    if feature != "signed_zero":
        np.testing.assert_array_equal(oi, ji)


def test_pack_keys_round_trip_and_order():
    v = torch.tensor([1.5, -0.0, 0.0, -np.inf, np.inf, -2.0, 1.5, 3e-38])
    i = torch.tensor([7, 3, 9, 0, 2**31 - 1, 5, 2, 11])
    keys = mips.pack_keys(v, i)
    rv, ri = mips.unpack_keys(keys)
    assert torch.equal(rv.view(torch.int32), v.view(torch.int32))
    assert torch.equal(ri, i)
    # signed order: value descending (-0 below +0), then the lower index
    order = torch.argsort(keys, descending=True).tolist()
    assert order == [4, 6, 0, 7, 2, 1, 5, 3]


@pytest.mark.parametrize("B,N,block_n,k,kpb", [
    (64, 1_003_520, 1024, 1000, 1000), (64, 2048, 1024, 1000, 1000),
    (3, 1024, 256, 40, 40), (5, 2048, 1024, 1000, 1000),
    (16, 4096, 256, 129, 32),
])
def test_set_segments_cover_the_rows(B, N, block_n, k, kpb):
    """The fp32 / bf16 selection's segments: the blocks at k' < k; at
    k' >= k a few runs of at least k rows (a multiple of 4) that cover
    [0, N)."""
    seg, nseg, kk = mips.set_segments(B, N, block_n, k, kpb)
    assert seg * (nseg - 1) < N <= seg * nseg
    if kpb < k:
        assert (seg, nseg, kk) == (block_n, N // block_n, kpb)
    else:
        assert kk == k and seg >= k and (seg % 4 == 0 or seg == N)
        assert B * nseg <= 2 * mips.SM_COUNT + B


# ---------------------------------------------------------------------------
# K6's route on the card, host side: the int8 docs go through the score +
# set-selection kernels with the blocks as segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,block_n,k,kpb", [
    (16, 16_384, 4096, 65, 32), (16, 8_806_400, 4096, 129, 32),
    (B, N, BLOCK, K, 5),
])
def test_int8_segment_plan_is_the_blocks(B, N, block_n, k, kpb):
    """k' < k: one segment per block, k' keys each (the online step's and
    the MS MARCO-scale shapes, and this file's)."""
    assert mips.set_segments(B, N, block_n, k, kpb) == (block_n,
                                                         N // block_n, kpb)


def test_int8_set_merge_matches_pallas():
    """Each block's top-k' taken as an unordered set of packed keys (what
    the selection kernel writes), from the plain per-block selection, then
    the packed-key merge: the result of JAX's mips_topk_pallas_quantized
    (interpret mode), values and indices."""
    q, _, _ = _data()
    jv, ji, vals, scales = _jax_k6(5)
    s = mips.block_scores(torch.from_numpy(q), torch.from_numpy(vals),
                          torch.from_numpy(scales))
    nb = N // BLOCK
    v, pos = mips.topk_stable(s.view(B, nb, BLOCK), 5)
    idx = pos + torch.arange(nb)[None, :, None] * BLOCK
    keys = mips.pack_keys(v, idx)
    perm = torch.from_numpy(np.random.default_rng(2).permuted(
        np.broadcast_to(np.arange(5), keys.shape), axis=2).copy())
    keys = torch.gather(keys, 2, perm).reshape(B, nb * 5)
    tv, ti = mips._merge_keys(keys, K)
    _assert_same((tv.numpy(), ti.numpy()), (jv, ji))

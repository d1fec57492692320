"""Port of the SPLADE pools (slice R): ``models/splade.py``,
``index/sparse.py`` (a host copy, held by tests/test_torch_host_copies.py)
and ``build_pools --method splade`` against the JAX package on the same
numpy weights and inputs, in fp32 on the CPU; and ``topk_stable``, which
ranks the activations, against ``lax.top_k`` at ties and signed zeros.

Most activations are exactly 0 (relu gates a term off), so the top-k's
tie order decides which zero terms fill a row: the term ids must equal
``lax.top_k``'s there, not only the weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.index.sparse import SparseIndex as JSparseIndex
from pacednegatives_tpu.models import splade as jsplade
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.cli import build_pools
from pacednegatives_tpu_torch.data import TextCorpus, TokenizedStore
from pacednegatives_tpu_torch.models import splade as tsplade
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import params_from_jax
from pacednegatives_tpu_torch.ops.mips import topk_stable
from pacednegatives_tpu_torch.train.runner import RunConfig, load_run, run

# activations: the encoder (fp32, 2 layers) and the vocab product summed in
# other orders; log1p and max add no error of their own
ACT_ATOL = 2e-5
V = 256


@pytest.fixture(scope="module")
def model():
    cfg = jt5.T5Config.tiny(vocab_size=V)
    params = jax.tree_util.tree_map(np.asarray,
                                    jt5.init_params(jax.random.key(0), cfg))
    return cfg, params, tt5.T5Config.tiny(vocab_size=V), params_from_jax(
        params)


def _ids(shape, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, V, size=shape).astype(np.int32)
    mask = np.ones(shape, np.int32)
    mask[:, shape[1] // 2 + 1:] = 0
    mask[0] = 1  # one row with no padding
    ids[mask == 0] = 0
    return ids, mask


def _signed_zeros(x: np.ndarray) -> int:
    return int(np.sum((x == 0) & np.signbit(x)))


def test_activations_match_jax_with_a_padded_chunk(model):
    """pos_chunk 8 over 18 positions: the JAX package pads the last chunk
    to 8, the port runs it short; activations equal within ACT_ATOL, the
    zero terms the same, and no -0 anywhere (relu's +0 and the +0
    accumulator)."""
    jcfg, jparams, tcfg, tparams = model
    ids, mask = _ids((4, 18))
    j = np.asarray(jsplade.splade_activations(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), pos_chunk=8))
    t = tsplade.splade_activations(tparams, tcfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask), pos_chunk=8)
    assert t.dtype == torch.float32 and t.shape == (4, V)
    t = t.numpy()
    np.testing.assert_allclose(t, j, atol=ACT_ATOL, rtol=0)
    np.testing.assert_array_equal(t == 0, j == 0)
    assert (t == 0).mean() > 0.01  # zero ties (the JAX test_splade.py bound)
    assert _signed_zeros(t) == _signed_zeros(j) == 0
    # padded positions do not count: the same rows cut to their real tokens
    short = tsplade.splade_activations(
        tparams, tcfg, torch.from_numpy(ids[1:, :10]),
        torch.from_numpy(mask[1:, :10]), pos_chunk=8).numpy()
    np.testing.assert_allclose(short, t[1:], atol=ACT_ATOL, rtol=0)


@pytest.mark.parametrize("k", [64, V])
def test_topk_term_ids_match_jax_at_zero_ties(model, k):
    """splade_topk's (weights, term ids) against JAX's; at k = V every zero
    term of a row is ranked, ties to the lower term id."""
    jcfg, jparams, tcfg, tparams = model
    ids, mask = _ids((3, 12), seed=2)
    jw, jt = jsplade.splade_topk(jparams, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), k=k)
    tw, tt = tsplade.splade_topk(tparams, tcfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask), k=k)
    jw, jt = np.asarray(jw), np.asarray(jt)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ACT_ATOL, rtol=0)
    if k == V:
        assert (jw == 0).any()
    # ranks whose weight stands apart from its neighbours' by more than
    # the tolerance hold the same term; the zero terms all do
    gap = np.minimum(np.abs(np.diff(jw, prepend=np.inf)),
                     np.abs(np.diff(jw, append=-np.inf)))
    firm = (gap > 2 * ACT_ATOL) | (jw == 0)
    np.testing.assert_array_equal(tt.numpy()[firm], jt[firm])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_topk_stable_matches_lax_top_k_at_ties_and_signed_zeros(dtype):
    """``topk_stable`` against ``lax.top_k`` on rows full of ties, -0 and
    +0 (which ``torch.sort`` holds equal and ``lax.top_k`` orders -0 below
    +0), and infinities: values bit for bit, positions equal."""
    rng = np.random.default_rng(0)
    x = rng.choice(np.array([0.0, -0.0, 0.5, -0.5, 1.0, np.inf, -np.inf],
                            np.float32), size=(6, 40))
    x[0] = [0.0, -0.0] * 20
    x[1] = [-0.0, 0.0] * 20
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    for k in (1, 7, 40):
        jv, ji = jax.lax.top_k(xj, k)
        tv, ti = topk_stable(xt, k)
        assert tv.dtype == xt.dtype
        np.testing.assert_array_equal(
            tv.float().numpy().view(np.int32),
            np.asarray(jv.astype(jnp.float32)).view(np.int32))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_encode_corpus_sparse_in_batches(model):
    """Batches of 3 over 10 rows (the last one short) against one call,
    and against JAX's ``encode_corpus_sparse`` (batches of 4, padded)."""
    jcfg, jparams, tcfg, tparams = model
    ids, mask = _ids((10, 8), seed=5)
    tw, tt = tsplade.encode_corpus_sparse(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), k=16,
        batch_size=3)
    assert tw.shape == tt.shape == (10, 16)
    ow, ot = tsplade.splade_topk(tparams, tcfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask), k=16)
    np.testing.assert_allclose(tw.numpy(), ow.numpy(), atol=ACT_ATOL)
    jw, _ = jsplade.encode_corpus_sparse(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg, jnp.asarray(ids),
        jnp.asarray(mask), k=16, batch_size=4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ACT_ATOL)


def test_build_pools_splade_matches_jax_pipeline(tmp_path):
    """``build_pools --method splade`` on a trained run's weights against
    the JAX package's pipeline on the same weights (JAX activations, its
    sparse index, its search): the same queries written, and each pool
    equal but for near-tie swaps, where the two docs' scores differ by no
    more than one impact quantum of the largest query weight."""
    out = tmp_path / "run"
    run(RunConfig(model="tiny", vocab_size=512, bf16=False, remat=False,
                  total_steps=8, batch_size=4, chunk_size=1,
                  synthetic_docs=24, synthetic_queries=8, synthetic_pairs=12,
                  synthetic_pool=8, max_q_tokens=8, max_d_tokens=24,
                  warmup_steps=4, out_dir=str(out)), device="cpu")
    corpus = TextCorpus.synthetic(num_docs=40, num_queries=6, seed=7)
    docs, queries = tmp_path / "docs.tsv", tmp_path / "queries.tsv"
    docs.write_text("".join(f"{i}\t{t}\n" for i, t in
                            zip(corpus.doc_ids, corpus.doc_texts)))
    queries.write_text("".join(f"{i}\t{t}\n" for i, t in
                               zip(corpus.query_ids, corpus.query_texts)))
    cutoff, terms = 10, 32
    pools = tmp_path / "pools.jsonl"
    build_pools.main(["--method", "splade", "--run", str(out), "--docs",
                      str(docs), "--queries", str(queries), "--out",
                      str(pools), "--cutoff", str(cutoff), "--splade_terms",
                      str(terms), "--encode_batch", "16", "--device", "cpu"])
    recs = [json.loads(line) for line in pools.read_text().splitlines()]

    params, mcfg, tok, rc = load_run(str(out), device="cpu")
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=mcfg.vocab_size),
                               dtype=jnp.float32)
    jparams = tt5.unflatten_params(
        {k: jnp.asarray(v.numpy())
         for k, v in tt5.flatten_params(params).items()})
    store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                 max_d_tokens=rc.max_d_tokens)
    enc = lambda t, m: [np.asarray(a) for a in jsplade.encode_corpus_sparse(
        jparams, jcfg, jnp.asarray(t), jnp.asarray(m), k=terms,
        batch_size=16)]
    d_w, d_t = enc(store.d_tokens, store.d_mask)
    q_w, q_t = enc(store.q_tokens, store.q_mask)
    index = JSparseIndex.build(d_t, d_w, num_terms=jcfg.vocab_size)
    want = {}
    for row, qid in enumerate(corpus.query_ids):
        ids, scores = index.search(q_t[row], q_w[row], k=corpus.num_docs)
        quantum = index.scale * float(q_w[row].max())
        want[qid] = (ids, dict(zip(ids.tolist(), scores.tolist())), quantum)
    full = [q for q, (ids, _, _) in want.items() if len(ids) >= cutoff]
    assert [r["query_id"] for r in recs] == full and full
    swaps = 0
    for r in recs:
        ids, score, quantum = want[r["query_id"]]
        got = [corpus.doc_index[d] for d in r["doc_id_b"][::-1]]
        for a, b in zip(got, ids[:cutoff].tolist()):
            if a != b:
                swaps += 1
                assert abs(score.get(a, 0.0) - score[b]) <= quantum, (a, b)
    assert swaps <= len(recs)  # near-ties are rare

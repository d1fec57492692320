"""The serving slice as a whole: the port's ``Reranker`` against the JAX
package's, same weights and corpus, at fp32 on the CPU, with flash_v3 on
(JAX in interpret mode, the port through its plain versions). Unpacked
serving, and packed serving with length buckets, where blocks shorter than
64 take the dense path and the rest the fused block."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pacednegatives_tpu.data import corpus as jcorpus
from pacednegatives_tpu.data import pipeline as jpipeline
from pacednegatives_tpu.data.tokenizer import HashTokenizer as JTok
from pacednegatives_tpu.eval.rerank import Reranker as JReranker
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.data import corpus as tcorpus
from pacednegatives_tpu_torch.data import pipeline as tpipeline
from pacednegatives_tpu_torch.data.tokenizer import HashTokenizer as TTok
from pacednegatives_tpu_torch.eval.rerank import Reranker, serving_params
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)

# Scores are log-probs of order 1 after 2 + 2 fp32 layers; the packages
# differ only in summation order (~1e-6), so 1e-4 leaves a wide margin
# while any routing, masking or cast difference shows up far above it.
SCORE_ATOL = 1e-4

JCFG = jt5.T5Config(
    vocab_size=512, d_model=128, d_kv=64, d_ff=256, num_heads=2,
    num_layers=2, num_decoder_layers=2, flash_v3=True,
    flash_v3_interpret=True,
)
B = 16


def _variable_corpus(mod):
    """Clipped-lognormal doc lengths, as the JAX bench's packed rerank arm
    builds its corpus (bench.py:488-516), at a small scale."""
    rng = np.random.default_rng(7)
    d_lens = np.clip(rng.lognormal(mean=3.4, sigma=0.6, size=48).astype(int),
                     5, 70)
    words = [f"w{i}" for i in range(200)]
    docs = [" ".join(rng.choice(words, size=n)) for n in d_lens]
    queries = [" ".join(rng.choice(words, size=n))
               for n in rng.integers(2, 7, size=8)]
    return mod.TextCorpus([f"d{i}" for i in range(len(docs))], docs,
                          [f"q{i}" for i in range(len(queries))], queries)


def _synthetic_corpus(mod):
    return mod.TextCorpus.synthetic(num_docs=48, num_queries=8, seed=0,
                                    doc_len=64, query_len=5)


def _run():
    rng = np.random.default_rng(1)
    return {f"q{q}": [f"d{i}" for i in rng.choice(48, size=10, replace=False)]
            for q in range(6)}


@pytest.fixture(scope="module")
def jparams():
    return jt5.init_params(jax.random.key(0), JCFG)


def _pair(jparams, corpus_fn, **kw):
    jc, tc = corpus_fn(jcorpus), corpus_fn(tcorpus)
    js = jpipeline.TokenizedStore.build(jc, JTok(512), max_q_tokens=8,
                                        max_d_tokens=72)
    ts = tpipeline.TokenizedStore.build(tc, TTok(512), max_q_tokens=8,
                                        max_d_tokens=72)
    jr = JReranker(jparams, JCFG, js, jc, rel_id=3, nrel_id=4,
                   batch_size=B, **kw)
    tr = Reranker(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                  config_from_jax(JCFG), ts, tc, rel_id=3, nrel_id=4,
                  batch_size=B, device="cpu", **kw)
    return jr, tr


def _rows(r, run):
    q = [r.corpus.query_index[qid] for qid, docs in run.items() for _ in docs]
    d = [r.corpus.doc_index[doc] for docs in run.values() for doc in docs]
    return np.asarray(q, np.int64), np.asarray(d, np.int64)


def _count_fused(monkeypatch):
    calls = []
    real = tt5.fused_self_attention
    monkeypatch.setattr(tt5, "fused_self_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def test_unpacked_matches_jax(jparams, monkeypatch):
    jr, tr = _pair(jparams, _synthetic_corpus)
    L = tr.store.prompt_len
    assert L == jr.store.prompt_len >= 64
    run = _run()
    q_rows, d_rows = _rows(tr, run)
    calls = _count_fused(monkeypatch)
    t = tr.score_pairs(q_rows, d_rows)
    n_blocks = -(-len(q_rows) // B)
    # every block at the full length goes through the fused block, at the
    # fixed batch shape (the last block is padded by repeating its last row)
    assert calls == [(B, L, 128)] * (JCFG.num_layers * n_blocks)
    j = jr.score_pairs(q_rows, d_rows)
    assert t.dtype == np.float32 and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=SCORE_ATOL, rtol=0)
    assert tr.rerank(run) == jr.rerank(run)


def test_packed_bucketed_matches_jax(jparams, monkeypatch):
    kw = dict(packed=True, bucket_lens=None)
    jr, tr = _pair(jparams, _variable_corpus, **kw)
    L = tr.store.prompt_len
    jr.bucket_lens = tr.bucket_lens = tuple(range(32, L, 32))
    run = _run()
    q_rows, d_rows = _rows(tr, run)
    plan = tr._bucket_plan(q_rows, d_rows)
    assert [b for _, b in plan] == [b for _, b in jr._bucket_plan(q_rows, d_rows)]
    buckets = [b for _, b in plan]
    assert min(buckets) < 64 <= max(buckets), buckets  # both routes taken
    assert tr.warm(q_rows, d_rows) == jr.warm(q_rows, d_rows)
    calls = _count_fused(monkeypatch)
    t = tr.score_pairs(q_rows, d_rows)
    assert calls == [(B, b, 128) for b in buckets if b >= 64
                     for _ in range(JCFG.num_layers)]
    j = jr.score_pairs(q_rows, d_rows)
    np.testing.assert_allclose(t, j, atol=SCORE_ATOL, rtol=0)
    assert tr.rerank(run) == jr.rerank(run)


def test_serving_params_are_fused_and_cast(jparams):
    """Serving weights are fused once and matmul weights cast once to the
    compute dtype; norm scales and the position-bias table stay fp32."""
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = dataclasses.replace(config_from_jax(JCFG), dtype=torch.bfloat16)
    flat = tt5.flatten_params(serving_params(tree, cfg, torch.device("cpu")))
    assert set(flat) == set(tt5.flatten_params(tt5.fuse_attention_params(tree)))
    assert flat["encoder.block_0.self_attn.qkv"].dtype == torch.bfloat16
    assert flat["decoder.block_1.cross_attn.kv"].dtype == torch.bfloat16
    assert flat["shared.embedding"].dtype == torch.bfloat16
    assert flat["encoder.block_0.self_attn.rel_bias"].dtype == torch.float32
    assert flat["encoder.block_0.ln_self.scale"].dtype == torch.float32


def test_reranker_runs_on_the_card_unless_asked(monkeypatch):
    """The serving entry point defaults to cuda and never falls back to
    the CPU: without a card it raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_jax(JCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Reranker({}, cfg, None, None, rel_id=3, nrel_id=4)

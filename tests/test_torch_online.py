"""The port's dense retrieval and online mining against the JAX package's, on
the CPU: ``embed`` / ``encode_corpus`` on a tiny T5 with the JAX weights,
the online batch (mined rows and assembled prompts) on the same
embeddings and sampled slots, the sliced refresh, the loop's bit-exact
``checkpoint_index`` resume, ``run(mining="online")``, ``load_run`` and
``cli.build_pools --method dense``."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.data import DeviceCorpus as JDeviceCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore as JTripletStore
from pacednegatives_tpu.models import T5Config as JT5Config
from pacednegatives_tpu.models import init_params as jinit_params
from pacednegatives_tpu.models import dual_encoder as jde
from pacednegatives_tpu.ops import mips as jmips
from pacednegatives_tpu.train import init_train_state as jinit_state
from pacednegatives_tpu.train import make_optimizer as jmake_optimizer
from pacednegatives_tpu.train import online as jonline
from pacednegatives_tpu_torch.cli import build_pools
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import TextCorpus as TTextCorpus
from pacednegatives_tpu_torch.data import TokenizedStore as TTokenizedStore
from pacednegatives_tpu_torch.data import device_corpus
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.tokenizer import HashTokenizer as THash
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import dual_encoder as de
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)
from pacednegatives_tpu_torch.train import (
    MetricWriter,
    init_train_state,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
)
from pacednegatives_tpu_torch.train import online
from pacednegatives_tpu_torch.train.runner import RunConfig, load_run, run

# fp32 on both sides: encoder sums in another order
EMB_ATOL = 1e-5


@functools.cache
def _setup():
    """The tiny corpus and model of tests/test_online.py, in both packages
    (the port's corpus built from the same host store)."""
    corpus = TextCorpus.synthetic(num_docs=64, num_queries=8, seed=0)
    tok = HashTokenizer(vocab_size=512)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=6, max_d_tokens=16)
    triples = JTripletStore.synthetic(corpus, n_pairs=32, n_neg=8, seed=1)
    jdc = JDeviceCorpus.build(store, triples)
    tcorpus = TTextCorpus(corpus.doc_ids, corpus.doc_texts, corpus.query_ids,
                          corpus.query_texts)
    tstore = TTokenizedStore.build(tcorpus, THash(vocab_size=512),
                                   max_q_tokens=6, max_d_tokens=16)
    ttriples = TripletStore.synthetic(tcorpus, n_pairs=32, n_neg=8, seed=1)
    tdc = DeviceCorpus.build(tstore, ttriples, device="cpu")
    jcfg = JT5Config.tiny(vocab_size=512)
    jparams = jinit_params(jax.random.key(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return tok, jdc, tdc, jcfg, jparams, config_from_jax(jcfg), np_params


def _tparams():
    *_, np_params = _setup()
    return params_from_jax(np_params)


def test_embed_and_encode_corpus_match_jax():
    _, jdc, tdc, jcfg, jparams, tcfg, _ = _setup()
    tparams = _tparams()
    q_tok = np.asarray(jdc.q_tokens).astype(np.int32)
    mask = (q_tok != jdc.pad_id).astype(np.int32)
    je = np.asarray(jde.embed(jparams, jcfg, jnp.asarray(q_tok),
                              jnp.asarray(mask)))
    te = de.embed(tparams, tcfg, torch.from_numpy(q_tok).long(),
                  torch.from_numpy(mask))
    assert te.dtype == torch.float32 and not te.requires_grad
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=EMB_ATOL)
    # 30 docs in batches of 8 (a padded last batch), masks derived per batch
    d_tok = np.asarray(jdc.d_tokens)[:30]
    jc = np.asarray(jde.encode_corpus(jparams, jcfg, jnp.asarray(d_tok), None,
                                      batch_size=8, pad_id=jdc.pad_id))
    tc = de.encode_corpus(tparams, tcfg, tdc.d_tokens[:30], None,
                          batch_size=8, pad_id=tdc.pad_id)
    assert tc.shape == (30, tcfg.d_model)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(tc, dim=1).numpy(),
                               1.0, rtol=1e-5)


def test_sliced_refresh_matches_monolithic():
    _, _, tdc, _, _, tcfg, _ = _setup()
    whole = online.OnlineMiningConfig(pool_size=8, encode_batch=16,
                                      quantize=True)
    sliced = online.OnlineMiningConfig(pool_size=8, encode_batch=16,
                                       quantize=True,
                                       refresh_rows_per_call=24)
    v0, s0 = online.make_refresh_fn(tdc, tcfg, whole)(_tparams())
    v1, s1 = online.make_refresh_fn(tdc, tcfg, sliced)(_tparams())
    assert v0.dtype == torch.int8 and s0.shape == (64,)
    assert torch.equal(v0, v1) and torch.equal(s0, s1)


@pytest.mark.parametrize("quantize", [False, True])
def test_online_batch_matches_jax(quantize, monkeypatch):
    """JAX's fused step with a stub train step that hands back its batch;
    the slots it sampled are recovered from neg_rank and given to the
    port's fused step (same embeddings, same weights). The mined rows and
    every assembled tensor must be equal."""
    tok, jdc, tdc, jcfg, jparams, tcfg, _ = _setup()
    P, n, B = 8, 2, 4
    jmining = jonline.OnlineMiningConfig(pool_size=P, encode_batch=16,
                                         quantize=quantize)
    jemb = jonline.make_refresh_fn(jdc, jcfg, jmining)(jparams)
    jctrl = JEta(kind="lce", objective="weighted_ce", optimizer="adamw",
                 clamp=False)
    jtx = jmake_optimizer(lr=1e-3, total_steps=4)
    jfused = jonline.make_online_fused_step(
        jdc, lambda s, b: (s, b), jctrl, jcfg, jmining, n)
    pair_idx = np.arange(3, 3 + B, dtype=np.int32)
    (_, _), jbatch = jfused((jinit_state(jparams, jtx, jctrl.init()), jemb),
                            jnp.asarray(pair_idx))
    jbatch = {k: np.asarray(v) for k, v in jbatch.items()}
    slots = np.rint(jbatch["neg_rank"] * (P - 1)).astype(np.int64)

    temb = (tuple(torch.from_numpy(np.array(x)) for x in jemb) if quantize
            else torch.from_numpy(np.array(jemb)))
    ctrl = EtaController(kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False)
    mining = online.OnlineMiningConfig(pool_size=P, encode_batch=16,
                                       quantize=quantize)
    fused = online.make_online_fused_step(tdc, lambda s, b: (s, b), ctrl,
                                          tcfg, mining, n)
    monkeypatch.setattr(device_corpus, "sample_pool_indices_batch",
                        lambda gen, pool, means, k: torch.from_numpy(
                            slots.reshape(B, n)))
    tparams = _tparams()
    state = init_train_state(tparams, make_optimizer(1e-3, 4),
                             ctrl.init("cpu"))
    (_, _), tbatch = fused((state, temb), torch.from_numpy(pair_idx).long())

    # the mined rows: the port's dispatch against JAX's top-k on the same
    # index, from each package's own query embeddings
    q_rows = np.asarray(jdc.query_rows)[pair_idx]
    q_tok = np.asarray(jdc.q_tokens)[q_rows].astype(np.int32)
    jq = jde.embed(jparams, jcfg, jnp.asarray(q_tok))
    if quantize:
        _, jtop = jmips.mips_topk_quantized_streaming(jq, *jemb, P + 1)
    else:
        _, jtop = jmips.mips_topk_exact(jq, jemb, P + 1)
    ttop = online.mine_top(de.embed(tparams, tcfg,
                                    torch.from_numpy(q_tok).long()),
                           temb, P + 1, mining)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    assert set(jbatch) == set(tbatch)
    for key, want in jbatch.items():
        np.testing.assert_array_equal(tbatch[key].numpy(), want, err_msg=key)


def _loop_parts(seed_params, lr=1e-2):
    _, _, tdc, _, _, tcfg, _ = _setup()
    params = t5.tree_map(lambda x: x.clone(), seed_params)
    ctrl = EtaController(eta0=0.5, meta_lr=1e-3, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=18.7)
    tx = make_optimizer(lr, total_steps=8, warmup_steps=1)
    step = make_train_step(tcfg, ctrl, tx, loss="lce", n_neg_per_example=2,
                           use_mean=False, rel_id=3, nrel_id=4)
    mining = online.OnlineMiningConfig(pool_size=8, encode_batch=16,
                                       quantize=True)
    fused = online.make_online_fused_step(tdc, step, ctrl, tcfg, mining, 2)
    refresh = online.make_refresh_fn(tdc, tcfg, mining)
    return init_train_state(params, tx, ctrl.init("cpu")), fused, refresh


def test_checkpoint_index_resume_bit_exact(tmp_path):
    """A run stopped at a checkpoint that coincides with a refresh and
    resumed with its index snapshot reproduces the uninterrupted run's
    losses exactly (online.py:344-352)."""
    _, _, tdc, *_ = _setup()
    seed = _tparams()

    def loop(fused, refresh):
        return online.OnlineMiningLoop(
            fused_step=fused, refresh_fn=refresh, num_pairs=tdc.num_pairs,
            batch_size=4, chunk_size=2, refresh_every=4, log_mode="all",
            checkpoint_dir=str(tmp_path), checkpoint_every_steps=4,
            checkpoint_index=True, corpus=tdc)

    state, fused, refresh = _loop_parts(seed)
    full_w = MetricWriter(None)
    loop(fused, refresh).run(state, 8, full_w)
    full = {h["step"]: h["loss"] for h in full_w.history if "loss" in h}
    assert (tmp_path / "step_4" / "index.pt").exists()
    assert sum("refresh_seconds" in h for h in full_w.history) == 2

    state_b, fused_b, refresh_b = _loop_parts(seed)
    restored = restore_checkpoint(str(tmp_path / "step_4"), state_b)
    res_w = MetricWriter(None)
    loop(fused_b, refresh_b).run(restored, 8, res_w)
    res = {h["step"]: h["loss"] for h in res_w.history if "loss" in h}
    assert sorted(res) == [5, 6, 7, 8]
    assert [res[s] for s in res] == [full[s] for s in res]
    # the snapshot was loaded, not re-encoded
    assert not any("refresh_seconds" in h and h["step"] == 4
                   for h in res_w.history)


def test_overlap_and_approx_are_not_ported():
    """The overlapped refresh is ported (tests/test_torch_overlap.py); the
    loop keeps the JAX package's refusal of it beside checkpoint_index.
    ``method="approx"`` is not carried over."""
    _, _, tdc, _, _, tcfg, _ = _setup()
    with pytest.raises(ValueError, match="checkpoint_index"):
        online.OnlineMiningLoop(fused_step=None, refresh_fn=None,
                                num_pairs=8, batch_size=4, overlap=object(),
                                checkpoint_index=True)
    with pytest.raises(NotImplementedError, match="approx"):
        online.make_online_fused_step(
            tdc, None, None, tcfg,
            online.OnlineMiningConfig(method="approx"))


@pytest.fixture(scope="module")
def online_run(tmp_path_factory):
    """run(mining="online") on a tiny model: 3 steps, int8 index, refresh
    every 2 steps (the initial encode and one refresh)."""
    out = tmp_path_factory.mktemp("online_run")
    cfg = RunConfig(
        model="tiny", remat=False, mining="online", quantize_index=True,
        pool_size=8, encode_batch=16, refresh_every=2, batch_size=4,
        total_steps=12, warmup_steps=4, synthetic_docs=64,
        synthetic_queries=8, synthetic_pairs=32, synthetic_pool=8,
        max_q_tokens=8, max_d_tokens=24, chunk_size=1, log_mode="all",
        out_dir=str(out))
    return out, run(cfg, device="cpu")


def test_run_online_mining_on_cpu(online_run):
    out, summary = online_run
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [r["step"] for r in rows if "refresh_seconds" in r] == [0, 2]
    assert all(0.0 <= r["neg_rank"] <= 1.0 for r in rows if "neg_rank" in r)


def test_load_run_round_trip(online_run):
    out, _ = online_run
    params, mcfg, tok, rc = load_run(str(out), device="cpu")
    assert rc.mining == "online" and mcfg.d_model == 64
    saved = torch.load(out / "final" / "state.pt", weights_only=True)
    flat = t5.flatten_params(params)
    assert set(flat) == set(saved["params"])
    assert all(torch.equal(flat[k], saved["params"][k]) for k in flat)


def test_load_run_of_a_card_trained_run_on_cpu(online_run, tmp_path):
    """A run trained on the card saved a CUDA generator's state (16 bytes:
    seed and offset), which no CPU generator takes; ``load_run`` on the
    CPU reloads its weights all the same (a run scored on the other
    device, as ``cli.evaluate --device cpu`` does)."""
    import shutil

    out, _ = online_run
    copy = tmp_path / "run"
    shutil.copytree(out, copy)
    state = copy / "final" / "state.pt"
    saved = torch.load(state, weights_only=True)
    saved["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(saved, state)
    params, _, _, _ = load_run(str(copy), device="cpu")
    flat = t5.flatten_params(params)
    assert all(torch.equal(flat[k], saved["params"][k]) for k in flat)


def test_build_pools_dense_on_cpu(online_run, tmp_path):
    out, _ = online_run
    corpus = TTextCorpus.synthetic(num_docs=64, num_queries=8, seed=3)
    paths = {}
    for name, ids, texts in (("docs", corpus.doc_ids, corpus.doc_texts),
                             ("queries", corpus.query_ids,
                              corpus.query_texts)):
        paths[name] = tmp_path / f"{name}.tsv"
        paths[name].write_text("".join(f"{i}\t{t}\n"
                                       for i, t in zip(ids, texts)))
    (tmp_path / "pairs.tsv").write_text("q1\td1\n")
    argv = ["--method", "dense", "--run", str(out), "--docs",
            str(paths["docs"]), "--queries", str(paths["queries"]),
            "--pairs", str(tmp_path / "pairs.tsv"), "--device", "cpu",
            "--topk", "exact", "--encode_batch", "16"]
    build_pools.main(argv + ["--out", str(tmp_path / "p.jsonl"),
                             "--cutoff", "10"])
    recs = [json.loads(line) for line in
            (tmp_path / "p.jsonl").read_text().splitlines()]
    assert [r["query_id"] for r in recs] == corpus.query_ids
    assert recs[1]["doc_id_a"] == "d1" and recs[0]["doc_id_a"] == ""
    # easiest first: the reversed top-10 of the run's own dense index
    params, mcfg, tok, rc = load_run(str(out), device="cpu")
    store = TTokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                  max_d_tokens=rc.max_d_tokens)
    enc = lambda a, m: de.encode_corpus(params, mcfg, torch.from_numpy(a),
                                        torch.from_numpy(m), batch_size=16)
    _, top = online.mips_topk_exact(enc(store.q_tokens, store.q_mask),
                                    enc(store.d_tokens, store.d_mask), 10)
    want = [[corpus.doc_ids[d] for d in row[::-1]] for row in top.tolist()]
    assert [r["doc_id_b"] for r in recs] == want
    # a cutoff above the corpus size leaves every pool short: none written
    build_pools.main(argv + ["--out", str(tmp_path / "short.jsonl"),
                             "--cutoff", "100"])
    assert (tmp_path / "short.jsonl").read_text() == ""


@pytest.mark.parametrize("method,slice_", [("bm25", "slice E"),
                                           ("splade", "slice R")])
def test_build_pools_other_methods_not_ported(method, slice_, tmp_path):
    """The methods beside dense, each ported by its ROADMAP slice: ``--method
    bm25`` (slice E) runs and writes a full pool per query
    (tests/test_torch_eval.py holds it byte for byte to the JAX CLI);
    ``--method splade`` (slice R) needs a trained run, as the JAX CLI does
    (tests/test_torch_splade.py holds its pools to the JAX pipeline)."""
    corpus = TTextCorpus.synthetic(num_docs=24, num_queries=3, seed=0)
    docs, queries = tmp_path / "docs.tsv", tmp_path / "queries.tsv"
    docs.write_text("".join(f"{i}\t{t}\n" for i, t in
                            zip(corpus.doc_ids, corpus.doc_texts)))
    queries.write_text("".join(f"{i}\t{t}\n" for i, t in
                               zip(corpus.query_ids, corpus.query_texts)))
    out = tmp_path / "p.jsonl"
    if method == "splade":
        with pytest.raises(SystemExit, match="--run"):
            build_pools.main(["--method", method, "--docs", str(docs),
                              "--queries", str(queries), "--out", str(out)])
        return
    build_pools.main(["--method", method, "--docs", str(docs), "--queries",
                      str(queries), "--out", str(out), "--cutoff", "5"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [len(r["doc_id_b"]) for r in recs] == [5, 5, 5]

"""Port of model-in-the-loop negative selection (slice P):
``train/scored_pool.py`` against the JAX package's on the same numpy
inputs and the same starting state, in fp32 on the CPU.

The draws differ between the packages (``jax.random`` against a torch
generator), so the whole-step comparison feeds the port the JAX step's
own draw: the port module's sampler is replaced by one that returns
``sample_pool_indices_batch(fold_in(state.key, state.step), ...)`` of the
JAX package. Scores are held to ``SCORE_ATOL`` (fp32 forwards summed in
other orders), the step to the step tolerances of
``tests/test_torch_train.py``; the W8A8 scores as ``tests/test_torch_quant.py``
holds them, counting the int8 codes that flip between the packages."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.data import DeviceCorpus as JCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore
from pacednegatives_tpu.models import quant as jquant
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.models.monot5 import score_batch as j_score_batch
from pacednegatives_tpu.ops.sampling import (
    sample_pool_indices_batch as j_sample,
)
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu.train import runner as jrunner
from pacednegatives_tpu.train import scored_pool as jscored
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import quant as tquant
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.train import make_optimizer, make_train_step
from pacednegatives_tpu_torch.train import scored_pool as tscored
from pacednegatives_tpu_torch.train.runner import RunConfig, run
from test_torch_quant import _flipped_per_pair, _recording
from test_torch_train import STEP_ATOL, STEP_RTOL

B, N_NEG, C = 4, 2, 8
# candidate scores: two fp32 forwards through 2 + 2 layers, summed in other
# orders (the same bound as the port's t5 forward tests)
SCORE_ATOL = 2e-5
# W8A8: pairs with no flipped code, and every pair (test_torch_quant.py)
INT8_SCORE_ATOL, INT8_NOISE = 1e-3, 0.03
CTRL = dict(eta0=2.0, meta_lr=0.01, warmup_steps=1, total_steps=8,
            kind="lce", objective="weighted_ce", optimizer="adamw",
            clamp=False, ce_scale=3.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    """A variable-length corpus (doc word counts 2..40 against a 48-token
    budget), so that the length buckets pick different widths; prompts of
    L >= 64, so that flash_v3 takes the encoder."""
    tok = HashTokenizer(vocab_size=256)
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(50)]
    corpus = TextCorpus(
        [f"d{i}" for i in range(32)],
        [" ".join(rng.choice(words, size=int(k)))
         for k in rng.integers(2, 40, size=32)],
        [f"q{i}" for i in range(8)],
        [" ".join(rng.choice(words, size=int(k)))
         for k in rng.integers(1, 8, size=8)],
    )
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=48)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=12, seed=1)
    return tok, store, triples


def _setup(data, flash_v3=False, packed=True, dtype=jnp.float32):
    tok, store, triples = data
    jcfg = dataclasses.replace(
        jt5.T5Config.tiny(vocab_size=256), d_kv=64, dtype=dtype,
        flash_v3=flash_v3, fused_qkv=True, flash_v3_interpret=flash_v3)
    jctrl, tctrl = JEta(**CTRL), EtaController(**CTRL)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    step_kw = dict(loss="lce", n_neg_per_example=N_NEG, rel_id=tok.true_id,
                   nrel_id=tok.false_id)
    jstep = j_make_train_step(jcfg, jctrl, jtx, **step_kw)
    tstep = make_train_step(config_from_jax(jcfg), tctrl,
                            make_optimizer(lr=1e-2, total_steps=8), **step_kw)
    jdc = JCorpus.build(store, triples, packed=packed)
    tdc = DeviceCorpus.build(store, triples, device="cpu", packed=packed)
    return dict(tok=tok, jcfg=jcfg, tcfg=config_from_jax(jcfg), jctrl=jctrl,
                tctrl=tctrl, jstate=jstate, tstate=tstate, jstep=jstep,
                tstep=tstep, jdc=jdc, tdc=tdc)


def _fused(s, side, **kw):
    mk = jscored.make_scored_pool_step if side == "j" else \
        tscored.make_scored_pool_step
    return mk(s[f"{side}dc"], s[f"{side}step"], s[f"{side}ctrl"],
              s[f"{side}cfg"], n_neg_per_example=N_NEG, candidates=C,
              rel_id=s["tok"].true_id, nrel_id=s["tok"].false_id, **kw)


def _jax_draw(s, jstate):
    """The JAX step's draw: positions into the model order."""
    key = jax.random.fold_in(jstate.key, jstate.step)
    diff = s["jctrl"].difficulty(jstate.curriculum)
    return np.asarray(j_sample(key, C, jnp.broadcast_to(diff, (B,)), N_NEG))


def _inject(monkeypatch, draws: list):
    """Replace the port module's sampler by one that returns the next draw
    of ``draws``."""
    def sample(generator, n_pool, means, n):
        assert (n_pool, n, means.shape) == (C, N_NEG, (B,))
        return torch.from_numpy(np.array(draws.pop(0))).long()

    monkeypatch.setattr(tscored, "sample_pool_indices_batch", sample)


def _capture_scores(monkeypatch, name="score_batch", module=tscored):
    """Record each scoring call's (ids, mask, scores) in the port step."""
    calls = []
    real = getattr(module, name)

    def rec(params, cfg, ids, mask, **kw):
        out = real(params, cfg, ids, mask, **kw)
        calls.append((ids.clone(), mask.clone(), out.clone()))
        return out

    monkeypatch.setattr(module, name, rec)
    return calls


def test_balanced_slots_match_jax():
    for n_pool, c in ((100, 10), (8, 8), (1000, 256), (12, 5), (7, 1)):
        np.testing.assert_array_equal(tscored.balanced_slots(n_pool, c),
                                      jscored.balanced_slots(n_pool, c))
    for c in (0, 9):
        for mod in (tscored, jscored):
            with pytest.raises(ValueError, match="candidates"):
                mod.balanced_slots(8, c)


@pytest.mark.parametrize("flash_v3,chunk,buckets", [
    (False, 8, (24, 40, 56)), (True, 1024, ()),
])
def test_step_matches_jax_with_its_draw(data, monkeypatch, flash_v3, chunk,
                                        buckets):
    """Two scored-pool steps (the first update runs at lr(0) = 0, the
    second moves the weights), B 4, C 8, n 2, both fed JAX's draw: the
    candidate scores of step 1 (one scoring call) against JAX's
    ``score_batch`` on the same rows and their order against
    ``jnp.argsort``; with buckets, each chunk's width; then the loss, the
    metrics (the four of the scored pool among them), the curriculum and
    every leaf. JAX runs flash_v3 in interpret mode, the port its plain
    version."""
    s = _setup(data, flash_v3=flash_v3)
    kw = dict(score_chunk_rows=chunk, score_buckets=buckets)
    jfused = jax.jit(_fused(s, "j", **kw))
    tfused = _fused(s, "t", **kw)
    calls = _capture_scores(monkeypatch)
    jstate, tstate = s["jstate"], s["tstate"]
    pair_idx = np.arange(B)
    for step in range(2):
        sel = _jax_draw(s, jstate)
        _inject(monkeypatch, [sel])
        calls.clear()
        before = jstate.params
        jstate, jm = jfused(jstate, jnp.asarray(pair_idx, jnp.int32))
        tstate, tm = tfused(tstate, torch.from_numpy(pair_idx))
        assert len(calls) == (B * C) // min(chunk, B * C)
        if step == 0 and len(calls) == 1:  # all B*C rows in (B, C) order
            ((ids, mask, got),) = calls
            want = np.asarray(j_score_batch(
                before, s["jcfg"], jnp.asarray(ids.numpy()),
                jnp.asarray(mask.numpy()), rel_id=s["tok"].true_id,
                nrel_id=s["tok"].false_id)).reshape(B, C)
            np.testing.assert_allclose(got.numpy().reshape(B, C), want,
                                       atol=SCORE_ATOL, rtol=0)
            np.testing.assert_array_equal(
                torch.argsort(got.reshape(B, C), dim=1, stable=True),
                np.asarray(jnp.argsort(jnp.asarray(want), axis=1)))
        if buckets:  # each chunk at the smallest width covering its rows
            widths = [ids.shape[1] for ids, _, _ in calls]
            longest = [int(m.sum(1).max()) for _, m, _ in calls]
            L = s["tdc"].assemble(torch.zeros(1, dtype=torch.long),
                                  torch.zeros(1, dtype=torch.long))[0].shape[1]
            ladder = [b for b in buckets if b < L] + [L]
            assert widths == [min(b for b in ladder if b >= n)
                              for n in longest]
            assert len(set(widths)) > 1
        assert set(tm) == set(jm)
        assert {"neg_scored", "neg_rank", "neg_rank_static",
                "pool_score_spread"} <= set(tm)
        assert float(tm["neg_scored"]) == B * C + B * N_NEG
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {step} {key}")
    np.testing.assert_allclose(float(tstate.curriculum.eta),
                               float(jstate.curriculum.eta),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    tflat = tt5.flatten_params(tstate.params)
    assert set(tflat) == set(jflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)
    first = tt5.flatten_params(_np_tree(s["jstate"].params))
    assert any(not np.allclose(v.numpy(), first[k], rtol=0, atol=1e-6)
               for k, v in tflat.items()), "the second update moved nothing"


def test_scores_order_as_jnp_argsort(data, monkeypatch):
    """The candidates' order: a stable sort, as ``jnp.argsort`` orders.
    The step is fed its own scores back rounded to bf16 (so that many tie)
    and the negatives it trains must be the ones ``jnp.argsort`` of those
    scores and the same draw pick. An unstable sort breaks such ties in
    another order."""
    s = _setup(data)
    real = tscored.score_batch

    def tied(params, cfg, ids, mask, **kw):
        out = real(params, cfg, ids, mask, **kw)
        return (out * 4).to(torch.bfloat16).float().round() / 4

    monkeypatch.setattr(tscored, "score_batch", tied)
    calls = _capture_scores(monkeypatch)
    sel = _jax_draw(s, s["jstate"])
    _inject(monkeypatch, [sel.copy()])
    seen = {}

    def step_fn(state, batch):
        seen.update(batch)
        return state, {"loss": torch.zeros(())}

    fused = tscored.make_scored_pool_step(
        s["tdc"], step_fn, s["tctrl"], s["tcfg"], n_neg_per_example=N_NEG,
        candidates=C, rel_id=s["tok"].true_id, nrel_id=s["tok"].false_id)
    fused(s["tstate"], torch.arange(B))
    scores = calls[0][2].numpy().reshape(B, C)
    assert len(np.unique(scores)) < B * C // 2  # ties, many
    order = np.asarray(jnp.argsort(jnp.asarray(scores), axis=1))
    slots = jscored.balanced_slots(12, C)
    triples = data[2]
    docs = triples.pools[:B][:, slots]
    picked = np.take_along_axis(order, sel, axis=1)
    neg_d = np.take_along_axis(docs, picked, axis=1).reshape(-1)
    q = np.repeat(triples.query_rows[:B], N_NEG)
    ids, _ = s["tdc"].assemble(torch.from_numpy(q).long(),
                               torch.from_numpy(neg_d).long())
    assert torch.equal(seen["neg_ids"], ids)


def test_chunked_and_bucketed_scoring_equal_one_call(data, monkeypatch):
    """A non-divisor chunk (7, rounded down to a divisor of B*C = 32: 4),
    and length buckets with chunks of 8, each against one scoring call over
    all B*C rows, on the same draw: the same selection, loss and weights
    (JAX test_scored_pool.py:282-383 holds the JAX step the same way)."""
    s = _setup(data)
    pair_idx = torch.arange(B)
    sel = _jax_draw(s, s["jstate"])

    def one(**kw):
        _inject(monkeypatch, [sel.copy()])
        return _fused(s, "t", **kw)(s["tstate"], pair_idx)

    ref_state, ref = one()
    for kw in (dict(score_chunk_rows=7),
               dict(score_chunk_rows=8, score_buckets=(24, 40, 56))):
        st, m = one(**kw)
        for key in ("loss", "pool_score_spread", "neg_rank_static",
                    "neg_rank"):
            np.testing.assert_allclose(float(m[key]), float(ref[key]),
                                       rtol=1e-5, err_msg=f"{kw} {key}")
        for a, b in zip(tt5.flatten_params(st.params).values(),
                        tt5.flatten_params(ref_state.params).values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_refusals_match_jax(data):
    s = _setup(data, packed=False)
    for side, mod in (("j", jscored), ("t", tscored)):
        with pytest.raises(ValueError, match="candidates"):
            mod.make_scored_pool_step(
                s[f"{side}dc"], s[f"{side}step"], s[f"{side}ctrl"],
                s[f"{side}cfg"], n_neg_per_example=N_NEG, candidates=1,
                rel_id=3, nrel_id=4)
        with pytest.raises(ValueError, match="score_dtype"):
            _fused(s, side, score_dtype="fp8")
        with pytest.raises(ValueError, match="positive"):
            _fused(s, side, score_buckets=(0, 16))
    # an unpacked corpus with buckets: raised when the step runs
    with pytest.raises(ValueError, match="packed"):
        jax.jit(_fused(s, "j", score_buckets=(24,)))(
            s["jstate"], jnp.arange(B, dtype=jnp.int32))
    with pytest.raises(ValueError, match="packed"):
        _fused(s, "t", score_buckets=(24,))(s["tstate"], torch.arange(B))


@pytest.mark.parametrize("score_dtype", ["int8", "int8_bf16"])
def test_int8_scoring_matches_jax(data, monkeypatch, score_dtype):
    """The W8A8 scoring pass inside the step (the weights quantized once a
    step) against JAX's ``score_batch_int8`` on the same rows and weights,
    with the int8 codes that flip between the packages counted per row, as
    tests/test_torch_quant.py counts them; where no code flipped, the
    candidates' order equals ``jnp.argsort``'s."""
    s = _setup(data, dtype=jnp.bfloat16)
    stream = jnp.bfloat16 if score_dtype == "int8_bf16" else jnp.float32
    calls = _capture_scores(monkeypatch, "score_batch_int8", tquant)
    t_in = _recording(monkeypatch, tquant, "_quantize_tokens",
                      lambda x: x.float().numpy())
    _inject(monkeypatch, [_jax_draw(s, s["jstate"])])
    fused = _fused(s, "t", score_dtype=score_dtype)
    fused(s["tstate"], torch.arange(B))
    ((ids, mask, got),) = calls
    j_in = _recording(monkeypatch, jquant, "int8_linear",
                      lambda x: np.asarray(x.astype(jnp.float32)))
    jq = jquant.quantize_scoring_params(s["jstate"].params, s["jcfg"])
    want = np.asarray(jquant.score_batch_int8(
        jq, s["jcfg"], jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
        rel_id=s["tok"].true_id, nrel_id=s["tok"].false_id,
        stream_dtype=stream))
    got = got.numpy()
    flips = _flipped_per_pair(j_in, t_in, B * C)
    clean = flips == 0
    diff = np.abs(got - want)
    assert clean.sum() >= B * C * 3 // 4, (flips, diff)
    np.testing.assert_allclose(got[clean], want[clean],
                               atol=INT8_SCORE_ATOL, rtol=0)
    assert diff.max() <= INT8_NOISE, (flips, diff)
    rows = clean.reshape(B, C).all(axis=1)
    order_t = torch.argsort(torch.from_numpy(got).reshape(B, C), dim=1,
                            stable=True).numpy()
    order_j = np.asarray(jnp.argsort(jnp.asarray(want).reshape(B, C), axis=1))
    np.testing.assert_array_equal(order_t[rows], order_j[rows])


TINY = dict(model="tiny", remat=False, total_steps=8, batch_size=4,
            chunk_size=1, synthetic_docs=24, synthetic_queries=8,
            synthetic_pairs=12, synthetic_pool=8, max_q_tokens=8,
            max_d_tokens=24, warmup_steps=4, scored_pool=8)


def test_run_writes_the_jax_runners_rows(tmp_path):
    """``run(RunConfig(scored_pool=8))``: two steps whose rows carry the
    keys the JAX runner's rows carry, the scored pool's metrics and the
    same ``neg_scored``; and the JAX runner's refusals raise the same
    errors (online mining, a non-lce curriculum, an unknown dtype), meta
    too (the JAX meta loop ignores the field)."""
    jsum = jrunner.run(jrunner.RunConfig(**TINY, out_dir=str(tmp_path / "j")))
    tsum = run(RunConfig(**TINY, out_dir=str(tmp_path / "t")), device="cpu")
    assert tsum["steps"] == jsum["steps"] == 2
    assert np.isfinite(tsum["final_loss"])
    rows = {}
    for side in ("j", "t"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            rows[side] = [json.loads(line) for line in f]
    steps = {side: [r for r in r_ if "loss" in r] for side, r_ in rows.items()}
    assert [sorted(r) for r in steps["t"]] == [sorted(r) for r in steps["j"]]
    assert [r["neg_scored"] for r in steps["t"]] == \
        [r["neg_scored"] for r in steps["j"]] == [4 * (8 + 2)] * 2
    for extra, match in ((dict(mining="online"), "static pools"),
                         (dict(curriculum="interp"), "lce-family"),
                         (dict(scored_pool_dtype="fp8"), "scored_pool_dtype")):
        for mk, cfg_cls, kw in ((jrunner.run, jrunner.RunConfig, {}),
                                (run, RunConfig, dict(device="cpu"))):
            with pytest.raises(ValueError, match=match):
                mk(cfg_cls(**{**TINY, **extra,
                              "out_dir": str(tmp_path / "x")}), **kw)
    with pytest.raises(ValueError, match="scored_pool"):
        run(RunConfig(**{**TINY, "curriculum": "meta-cheap",
                         "out_dir": str(tmp_path / "m")}), device="cpu")

"""The port's dropout (``deterministic=False``) against the JAX package's,
on the CPU in fp32: the same placement and scaling (both packages fed the
same 0/1 masks), the keep rate of the port's own masks, the same masks in
a recomputed block, the refusals, and the dropout stream through the
train step, the runner and a checkpoint."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)
from pacednegatives_tpu_torch.train import (
    TrainLoop,
    init_train_state,
    make_fused_step,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from pacednegatives_tpu_torch.train.runner import RunConfig, run

# fp32 through 2 + 2 layers, the packages apart only in summation order
# (tests/test_torch_t5.py); gradients at the whole step's tolerance
# (tests/test_torch_train.py)
RTOL, ATOL = 1e-5, 2e-5
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
RATE = 0.1

JCFG = dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), d_kv=64,
                           dropout_rate=RATE)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jparams = jt5.init_params(jax.random.key(0), JCFG)
    return jparams, params_from_jax(_np_tree(jparams))


def _inputs(B=3, L=20, Lt=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 256, size=(B, L)).astype(np.int32)
    mask = (np.arange(L)[None] < np.array([L, L - 5, L - 9])[:B, None])
    ids = np.where(mask, ids, 0).astype(np.int32)
    labels = rng.integers(2, 256, size=(B, Lt)).astype(np.int32)
    return ids, mask.astype(np.int32), labels


def _jax_loss(params, cfg, ids, mask, labels, **kw):
    logits = jt5.forward_logits(params, cfg, ids, labels, mask, **kw)
    return jnp.mean(jnp.square(logits)), logits


def _port_loss(params, cfg, ids, mask, labels, **kw):
    logits = tt5.forward_logits(params, cfg, ids, labels, mask, **kw)
    return logits.square().mean(), logits


def _port_grads(params, cfg, ids, mask, labels, **kw):
    p = tt5.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, logits = _port_loss(p, cfg, torch.from_numpy(ids).long(),
                              torch.from_numpy(mask), torch.from_numpy(labels)
                              .long(), **kw)
    loss.backward()
    return logits.detach(), {k: v.grad for k, v in
                             tt5.flatten_params(p).items()}


def test_rate_zero_is_the_deterministic_forward(weights):
    """deterministic=False at rate 0 leaves every activation as it is: the
    port's logits equal its deterministic ones bit for bit, and JAX's at
    rate 0 as the two deterministic forwards agree."""
    jparams, tparams = weights
    cfg = dataclasses.replace(JCFG, dropout_rate=0.0)
    ids, mask, labels = _inputs()
    j_drop = jt5.forward_logits(jparams, cfg, ids, labels, mask,
                                deterministic=False,
                                dropout_key=jax.random.key(1))
    tcfg = config_from_jax(cfg)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(labels).long(),
            torch.from_numpy(mask))
    t_det = tt5.forward_logits(tparams, tcfg, *args)
    t_drop = tt5.forward_logits(tparams, tcfg, *args, deterministic=False,
                                dropout_seed=1)
    assert torch.equal(t_drop, t_det)
    np.testing.assert_allclose(t_drop.numpy(), np.asarray(j_drop),
                               rtol=RTOL, atol=ATOL)


def _injected(kind):
    """A stand-in for ``_dropout`` whose n-th call drops by mask n (numpy,
    keep rate 0.9): the same masks in the same order in both packages."""
    calls = []

    def fake(x, rate, _key, deterministic):
        if deterministic or rate == 0.0:
            return x
        rng = np.random.default_rng(len(calls))
        keep = rng.random(tuple(x.shape)) < 1.0 - rate
        calls.append(tuple(x.shape))
        if kind == "jax":
            return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)
        return torch.where(torch.from_numpy(keep), x / (1.0 - rate),
                           0.0).to(x.dtype)

    return fake, calls


def test_injected_masks_match_jax(weights, monkeypatch):
    """Both packages' dropout sites, fed the same masks in call order:
    logits and parameter gradients agree, so the sites, their order, their
    shapes and the scaling are JAX's (embeddings, dense attention weights,
    the attention and FFN residuals, the final norms)."""
    jparams, tparams = weights
    ids, mask, labels = _inputs()
    jfake, jcalls = _injected("jax")
    monkeypatch.setattr(jt5, "_dropout", jfake)
    (_, jlogits), jgrads = jax.value_and_grad(_jax_loss, has_aux=True)(
        jparams, JCFG, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(labels), deterministic=False,
        dropout_key=jax.random.key(0))
    tfake, tcalls = _injected("torch")
    monkeypatch.setattr(tt5, "_dropout", tfake)
    tlogits, tgrads = _port_grads(tparams, config_from_jax(JCFG), ids, mask,
                                  labels, deterministic=False,
                                  dropout_seed=0)
    # 2 embeddings, 3 sites an encoder block, 5 a decoder block, 2 norms
    assert tcalls == jcalls and len(tcalls) == 2 + 3 * 2 + 5 * 2 + 2
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    jflat = tt5.flatten_params(_np_tree(jgrads))
    assert set(jflat) == set(tgrads)
    for key, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)


def test_keep_rate_and_scale():
    x = torch.ones((1000, 1000))
    y = tt5._dropout(x, RATE, 3, deterministic=False)
    kept = int((y != 0).sum())
    n, p = x.numel(), 1.0 - RATE
    assert abs(kept - n * p) <= 4 * (n * p * (1 - p)) ** 0.5
    assert torch.equal(y[y != 0], torch.full((kept,), 1.0)
                       / torch.tensor(p))  # 1 / fp32(0.9), in fp32
    assert torch.equal(tt5._dropout(x, RATE, 3, False), y)  # seeded
    assert not torch.equal(tt5._dropout(x, RATE, 4, False), y)
    assert tt5._dropout(x, RATE, None, deterministic=True) is x
    # bf16: scaled by 1 / bf16(0.9), as JAX's weak-typed constant
    yb = tt5._dropout(x.bfloat16(), RATE, 3, False)
    assert torch.equal(yb != 0, y != 0)
    assert yb.dtype == torch.bfloat16
    assert float(yb[yb != 0][0]) == float(
        torch.tensor(1.0, dtype=torch.bfloat16)
        / torch.tensor(p, dtype=torch.bfloat16))


@pytest.mark.parametrize("policy", ["full", "dots", "dots_nobatch"])
def test_recomputed_blocks_draw_the_same_masks(weights, policy):
    _, tparams = weights
    ids, mask, labels = _inputs()
    cfg = config_from_jax(JCFG)
    base = _port_grads(tparams, cfg, ids, mask, labels, deterministic=False,
                       dropout_seed=7)
    remat = _port_grads(tparams, dataclasses.replace(
        cfg, remat=True, remat_policy=policy), ids, mask, labels,
        deterministic=False, dropout_seed=7)
    assert torch.equal(remat[0], base[0])
    for key, g in base[1].items():
        assert torch.equal(remat[1][key], g), key
    other = _port_grads(tparams, cfg, ids, mask, labels, deterministic=False,
                        dropout_seed=8)
    assert not torch.equal(other[0], base[0])


@pytest.mark.parametrize("knobs", [{"flash_v3": True},
                                   {"attention_impl": "chunked"}])
def test_dropout_refused_with_fused_or_chunked_attention(weights, knobs):
    _, tparams = weights
    ids, mask, labels = _inputs()
    cfg = dataclasses.replace(config_from_jax(JCFG), **knobs)
    with pytest.raises(ValueError, match="dropout"):
        tt5.forward_logits(tparams, cfg, torch.from_numpy(ids).long(),
                           torch.from_numpy(labels).long(),
                           torch.from_numpy(mask), deterministic=False,
                           dropout_seed=0)


def test_run_with_dropout_on_cpu(tmp_path):
    summary = run(RunConfig(model="tiny", dropout=True, total_steps=12,
                            batch_size=4, n=2, chunk_size=1,
                            synthetic_docs=24, synthetic_pairs=12,
                            max_q_tokens=8, max_d_tokens=24,
                            microbatches=2, out_dir=str(tmp_path)),
                  device="cpu")
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])


def _loop(dropout: bool, seed: int = 0):
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=20, query_len=6)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8,
                                 max_d_tokens=16)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=5, seed=1)
    cfg = tt5.T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                       num_heads=2, num_layers=1, num_decoder_layers=1,
                       remat=True, remat_policy="dots_nobatch")
    ctrl = EtaController(eta0=2.0, meta_lr=0.05, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=3.0)
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=1)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(seed))
    state = init_train_state(params, tx, ctrl.init(), seed=seed)
    tc = DeviceCorpus.build(store, triples, device="cpu")
    step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=2,
                           rel_id=tok.true_id, nrel_id=tok.false_id,
                           dropout=dropout, microbatches=2)
    loop = TrainLoop(make_fused_step(tc, step, ctrl, loss="lce",
                                     n_neg_per_example=2),
                     num_pairs=len(triples), batch_size=2, chunk_size=1,
                     corpus=tc)
    return state, loop


def test_dropout_stream_resumes_from_a_checkpoint(tmp_path):
    """The dropout generator is part of the state: a run resumed from a
    checkpoint draws the masks of the uninterrupted run, and dropout leaves
    the negatives' generator as it was."""
    state, loop = _loop(True)
    straight = loop.run(state, 4)
    state, loop = _loop(True)
    half = loop.run(state, 2)
    save_checkpoint(str(tmp_path / "step_2"), half)
    template, loop = _loop(True, seed=7)
    resumed = loop.run(restore_checkpoint(str(tmp_path / "step_2"),
                                          template), 4)
    for key, a in tt5.flatten_params(straight.params).items():
        assert torch.equal(tt5.flatten_params(resumed.params)[key], a), key
    assert torch.equal(resumed.dropout_generator.get_state(),
                       straight.dropout_generator.get_state())
    state, loop = _loop(False)
    plain = loop.run(state, 4)
    assert torch.equal(plain.generator.get_state(),
                       straight.generator.get_state())
    assert not torch.equal(plain.dropout_generator.get_state(),
                           straight.dropout_generator.get_state())
    assert not torch.equal(tt5.flatten_params(plain.params)["shared.embedding"],
                           tt5.flatten_params(straight.params)
                           ["shared.embedding"])

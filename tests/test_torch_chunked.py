"""Port of the chunked attention path (models/t5.py ``_chunked_attention``
and its flash-style ``custom_vjp``) and of the step's bf16 accumulation
carry and hoisted position biases, against the JAX package on the same
numpy inputs and weights, on the CPU.

The kernel route (``flash_kernel``) is held as a whole through the core
``_flash_core``: the JAX side with its Pallas kernels in interpret mode,
the port with its kernels' plain versions, each with ``flash_v2_eligible``
forced both ways so that K2b and K2a are both reached."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pacednegatives_tpu.ops.flash as jflash
from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.data import TokenizedStore
from pacednegatives_tpu.eval.rerank import Reranker as JReranker
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import TokenizedStore as TStore
from pacednegatives_tpu_torch.data import corpus as tcorpus
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus as TCorpus
from pacednegatives_tpu_torch.data.tokenizer import HashTokenizer as TTok
from pacednegatives_tpu_torch.data.triples import TripletStore as TTriples
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.ops import flash as tflash
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

# fp32 through 2 + 2 layers; the packages differ only in summation order
# (the JAX package's own chunked-vs-dense tolerances,
# tests/test_chunked_attention.py:37-61)
ATOL, RTOL = 2e-5, 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-4
# one attention core, fp32: outputs and gradients within 1e-5 of each
# one's largest magnitude (sums of <= 256 terms in another order)
CORE_TOL = 1e-5
# the whole step, fp32 carry: the JAX package's flash_v3-vs-dense step
# tolerance (tests/test_flash_v3.py:240-246), as tests/test_torch_train.py
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
# bf16 carry: both packages round each microbatch's gradient / 2 to bf16
# and add; a gradient whose fp32 value differs in its last bits between
# the packages can round one bf16 ulp (2^-8 relative) apart, and AdamW
# turns that into a weight difference of up to ~lr * 2^-8 = 4e-5 a step
# (measured: 8.4e-5 at most after two steps, against 2.7e-6 with the fp32
# carry). Weights within 2e-4 absolute, losses and metrics within 5e-3.
BF16_STEP_RTOL, BF16_STEP_ATOL = 5e-3, 2e-4

JCFG = jt5.T5Config.tiny(vocab_size=256)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX chunked tests' inputs (tests/test_chunked_attention.py:16-25):
    3 rows of 20 tokens, two of them padded."""
    params = _np_tree(jt5.init_params(jax.random.key(0), JCFG))
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 256, size=(3, 20)).astype(np.int32)
    ids[0, 15:] = 0
    ids[2, 7:] = 0
    labels = rng.integers(2, 256, size=(3, 2)).astype(np.int32)
    return params, ids, labels


def _chunked(cfg, chunk, **kw):
    return dataclasses.replace(cfg, attention_impl="chunked",
                               attention_chunk=chunk, **kw)


def _logits(params, cfg, ids, labels):
    return tt5.forward_logits(params_from_jax(params), config_from_jax(cfg),
                              torch.from_numpy(ids), torch.from_numpy(labels))


# ---------------------------------------------------------------------------
# The plain route (t5.py's XLA route) in the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 7, 20, 64])
def test_chunked_matches_jax(setup, chunk):
    """chunk 7 pads the keys (20 % 7 != 0), chunk 64 is the single-chunk
    path; the port against the JAX package's chunked route."""
    params, ids, labels = setup
    cfg = _chunked(JCFG, chunk)
    want = jax.jit(lambda p: jt5.forward_logits(
        p, cfg, jnp.asarray(ids), jnp.asarray(labels)))(params)
    got = _logits(params, cfg, ids, labels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _grads(params, cfg, ids, labels, with_jax=True):
    """d(mean CE of the labels) / d(params): the port's autograd and
    (``with_jax``) jax.grad, as flat dicts of numpy arrays."""

    def jloss(p):
        logits = jt5.forward_logits(p, cfg, jnp.asarray(ids),
                                    jnp.asarray(labels))
        onehot = jax.nn.one_hot(labels, cfg.vocab_size)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))

    jg = (tt5.flatten_params(_np_tree(jax.jit(jax.grad(jloss))(params)))
          if with_jax else None)
    tp = tt5.tree_map(lambda t: t.requires_grad_(), params_from_jax(params))
    logits = tt5.forward_logits(tp, config_from_jax(cfg),
                                torch.from_numpy(ids), torch.from_numpy(labels))
    lab = torch.from_numpy(labels).long()
    (-logits.log_softmax(-1).gather(-1, lab[..., None]).mean()).backward()
    tg = {k: v.grad.numpy() for k, v in tt5.flatten_params(tp).items()}
    return tg, jg


@pytest.mark.parametrize("chunk", [7, 64])
def test_chunked_gradients_match_jax(setup, chunk):
    """The hand-written backward (multi-chunk and single-chunk) against
    jax.grad through the JAX custom VJP, every leaf."""
    params, ids, labels = setup
    tg, jg = _grads(params, _chunked(JCFG, chunk), ids, labels)
    assert set(tg) == set(jg)
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=key)


def test_bf16_residual(setup):
    """attn_residual_dtype="bf16": the forward is bit-identical to the fp32
    residual's; the gradients stay within the JAX test's 1.5e-2 of the
    fp32-residual gradients (normalised by each leaf's largest), and match
    the JAX package's bf16-residual gradients as the fp32 ones do."""
    params, ids, labels = setup
    base = _chunked(JCFG, 8)
    bf16 = _chunked(JCFG, 8, attn_residual_dtype="bf16")
    assert config_from_jax(bf16).attn_residual_dtype == "bf16"
    assert torch.equal(_logits(params, bf16, ids, labels),
                       _logits(params, base, ids, labels))
    g32, _ = _grads(params, base, ids, labels, with_jax=False)
    g16, j16 = _grads(params, bf16, ids, labels)
    for key in g32:
        denom = max(np.abs(g32[key]).max(), 1e-6)
        np.testing.assert_allclose(g16[key] / denom, g32[key] / denom,
                                   atol=1.5e-2, err_msg=key)
        np.testing.assert_allclose(g16[key], j16[key], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=key)


def test_chunked_config_errors():
    params = tt5.init_params(tt5.T5Config.tiny(256),
                             torch.Generator().manual_seed(0))
    x = torch.zeros((1, 4, 64))
    p = params["encoder"]["block_0"]["self_attn"]
    cfg = config_from_jax(_chunked(JCFG, 8))
    with pytest.raises(ValueError, match="dropout"):
        tt5.encode(params, cfg, torch.ones((1, 4), dtype=torch.long),
                   deterministic=False)
    with pytest.raises(ValueError, match="requires attention_impl='chunked'"):
        tt5.attention(p, dataclasses.replace(cfg, attention_impl="dense",
                                             attn_residual_dtype="bf16"),
                      x, x, None)
    with pytest.raises(ValueError, match="attn_residual_dtype must be"):
        tt5.attention(p, dataclasses.replace(cfg, attn_residual_dtype="fp16"),
                      x, x, None)


def test_position_bias_from_tables_matches_jax(setup):
    params = setup[0]
    enc = params["encoder"]["block_0"]["self_attn"]["rel_bias"]
    dec = params["decoder"]["block_0"]["self_attn"]["rel_bias"]
    want = jax.jit(jt5.position_bias_from_tables, static_argnums=(2, 3, 4))(
        jnp.asarray(enc), jnp.asarray(dec), JCFG, 20, 3)
    got = tt5.position_bias_from_tables(torch.from_numpy(enc),
                                        torch.from_numpy(dec),
                                        config_from_jax(JCFG), 20, 3)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# The kernel route, as a whole
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _jax_kernels(v2: bool):
    """The JAX Pallas kernels in interpret mode, with the K2b / K2a choice
    forced (tests/test_chunked_attention.py:198-254 patches the same way)."""
    names = ("flash_attention_forward", "flash_attention_forward_v2",
             "flash_attention_backward", "flash_attention_backward_v2")
    origs = {n: getattr(jflash, n) for n in names}
    with contextlib.ExitStack() as stack:
        for n in names:
            stack.enter_context(mock.patch.object(
                jflash, n, lambda *a, _f=origs[n], **kw:
                _f(*a, **{**kw, "interpret": True})))
        stack.enter_context(mock.patch.object(
            jflash, "flash_v2_eligible", lambda *a: v2))
        yield


@pytest.mark.parametrize("v2", [True, False], ids=["K2b", "K2a"])
def test_flash_core_kernel_route_matches_jax(monkeypatch, v2):
    """_flash_core's kernel route (K1 forward; K2b or K2a backward): out and
    the gradients of q, k, v and the position bias, port (plain versions of
    the kernels, fp32) against JAX (Pallas in interpret mode), with
    Lq != Lk (the JAX test's 256 / 128, tests/test_chunked_attention.py)."""
    monkeypatch.setattr(tt5, "flash_v2_eligible", lambda *a: v2)
    rng = np.random.default_rng(v2)
    B, H, Lq, Lk, dk = 2, 4, 256, 128, 64
    q = rng.standard_normal((B, H, Lq, dk)).astype(np.float32)
    k = rng.standard_normal((B, H, Lk, dk)).astype(np.float32)
    v = rng.standard_normal((B, H, Lk, dk)).astype(np.float32)
    shared = (rng.standard_normal((1, H, Lq, Lk)) * 0.5).astype(np.float32)
    per_batch = np.where(np.arange(Lk)[None, None, None, :] < [[[[Lk]]], [[[100]]]],
                         0.0, -1e9).astype(np.float32)
    cot = rng.standard_normal((B, H, Lq, dk)).astype(np.float32)

    def jloss(q, k, v, shared):
        out = jt5._flash_core(128, ("pallas", 128), "fp32", q, k, v, shared,
                              jnp.asarray(per_batch))
        return jnp.sum(out * cot), out

    with _jax_kernels(v2):
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
            *map(jnp.asarray, (q, k, v, shared)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, shared)]
    before = (tflash.flash_attention_backward.launches,
              tflash.flash_attention_backward_v2.launches)
    out = tt5.flash_core(128, "kernel", "fp32", *leaves,
                         torch.from_numpy(per_batch))
    (out * torch.from_numpy(cot)).sum().backward()
    assert (tflash.flash_attention_backward.launches,
            tflash.flash_attention_backward_v2.launches) == before
    for name, a, b in zip(("out", "dq", "dk", "dv", "dpos"),
                          [out.detach()] + [t.grad for t in leaves],
                          [jout, *jg]):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        err = np.abs(a.numpy() - b).max()
        assert err <= CORE_TOL * np.abs(b).max(), (name, err)


def test_kernel_route_needs_cuda(setup):
    """The kernel gate is the JAX package's (128-aligned, dk 64 / 128) with
    "on a TPU" read as "on CUDA": on the CPU, flash_kernel changes nothing
    and launches nothing."""
    assert tt5.pallas_flash_eligible(512, 512, 64, "cuda")
    assert not tt5.pallas_flash_eligible(512, 512, 64, "cpu")
    assert not tt5.pallas_flash_eligible(188, 256, 64, "cuda")
    assert not tt5.pallas_flash_eligible(512, 512, 32, "cuda")
    params, ids, labels = setup
    ids = np.tile(ids, (1, 7))[:, :128]  # L 128: a kernel-eligible length
    launches = lambda: (tflash.flash_attention_forward.launches,
                        tflash.flash_attention_backward_v2.launches)
    before = launches()
    cfg = dataclasses.replace(_chunked(JCFG, 64), d_kv=64)
    jparams = _np_tree(jt5.init_params(jax.random.key(1), cfg))
    on = _logits(jparams, dataclasses.replace(cfg, flash_kernel=True), ids,
                 labels)
    assert torch.equal(on, _logits(jparams, cfg, ids, labels))
    assert launches() == before


# ---------------------------------------------------------------------------
# The train step and serving with chunked attention
# ---------------------------------------------------------------------------

N_NEG = 2


@pytest.fixture(scope="module")
def data():
    """The tokenizer and two LCE batches of 4 pairs x (1 + 2) prompts of
    64 tokens, drawn by the port's corpus (its JAX twin's sampler is
    held to it in tests/test_torch_train.py): the same batches go to both
    steps."""
    tok = TTok(256)
    corpus = tcorpus.TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                          doc_len=60, query_len=8)
    store = TStore.build(corpus, tok, max_q_tokens=12, max_d_tokens=48)
    triples = TTriples.synthetic(corpus, n_pairs=8, n_neg=5, seed=1)
    dc = TCorpus.build(store, triples)
    batches = [dc.lce_batch(torch.Generator().manual_seed(s),
                            torch.arange(4), 0.5, N_NEG) for s in range(2)]
    return tok, batches


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                           else v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("grad_accum_dtype", ["fp32", "bf16"])
def test_train_step_chunked_matches_jax(data, grad_accum_dtype):
    """make_train_step(loss="lce", microbatches=2) with chunked attention
    (64-token prompts in 16-key chunks), two steps from one state on the
    same batches, for both accumulation carries (the first update runs at
    lr 0, so the weights move only at the second; the JAX step compiles
    once, so the second step costs little)."""
    tok, batches = data
    # one encoder and one decoder block: the JAX step's compile is most
    # of this test's time, and grows with the depth
    jcfg = dataclasses.replace(_chunked(JCFG, 16), vocab_size=256,
                               fused_qkv=True, num_layers=1,
                               num_decoder_layers=1)
    kw = dict(eta0=2.0, meta_lr=0.01, warmup_steps=1, total_steps=8,
              kind="lce", objective="weighted_ce", optimizer="adamw",
              clamp=False, ce_scale=3.0)
    step_kw = dict(loss="lce", n_neg_per_example=N_NEG, use_mean=True,
                   rel_id=tok.true_id, nrel_id=tok.false_id, microbatches=2,
                   grad_accum_dtype=grad_accum_dtype)
    jctrl = JEta(**kw)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    jstep = jax.jit(j_make_train_step(jcfg, jctrl, jtx, **step_kw))
    tstep = make_train_step(config_from_jax(jcfg), EtaController(**kw),
                            make_optimizer(lr=1e-2, total_steps=8), **step_kw)
    rtol, atol = ((STEP_RTOL, STEP_ATOL) if grad_accum_dtype == "fp32"
                  else (BF16_STEP_RTOL, BF16_STEP_ATOL))
    for s, tb in enumerate(batches):
        jstate, jm = jstep(jstate, _jax_batch(tb))
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"step {s} {key}")
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    for key, val in tt5.flatten_params(tstate.params).items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_bf16_carry_differs_from_fp32(data):
    """The bf16 carry is a different (rounded) sum, not a relabelled fp32
    one: one step with each carry from the same state moves the weights
    differently."""
    tok, (batch, _) = data
    cfg = config_from_jax(dataclasses.replace(_chunked(JCFG, 16),
                                              fused_qkv=True))
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(eta0=2.0, meta_lr=0.01, warmup_steps=1, total_steps=8,
              kind="lce", objective="weighted_ce", optimizer="adamw",
              clamp=False, ce_scale=3.0)
    mus = []
    for dt in ("fp32", "bf16"):
        ctrl = EtaController(**kw)
        tx = make_optimizer(lr=1e-2, total_steps=8)
        step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
                               microbatches=2, grad_accum_dtype=dt,
                               rel_id=tok.true_id, nrel_id=tok.false_id)
        state, _ = step(init_train_state(params, tx, ctrl.init()), batch)
        mus.append(tt5.flatten_params(state.opt_state.mu))
    diff = [((mus[0][k] - mus[1][k]).norm() / mus[0][k].norm()).item()
            for k in mus[0] if mus[0][k].norm() > 0]
    # bf16 rounding of every gradient entry: ~2^-9 relative, and no more
    assert 0 < max(diff) <= 2.0**-6


def test_reranker_chunked_matches_jax():
    """Reranker scores with a chunked config, port against JAX, same weights
    and corpus (tests/test_torch_rerank.py does the same with flash_v3)."""
    from pacednegatives_tpu.data import corpus as jcorpus
    from pacednegatives_tpu.data.tokenizer import HashTokenizer as JTok

    cfg = jt5.T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                       num_heads=2, num_layers=2, num_decoder_layers=2,
                       attention_impl="chunked", attention_chunk=32)
    params = _np_tree(jt5.init_params(jax.random.key(3), cfg))
    mk = lambda mod: mod.TextCorpus.synthetic(num_docs=24, num_queries=4,
                                              seed=0, doc_len=40,
                                              query_len=5)
    jc, tc = mk(jcorpus), mk(tcorpus)
    jstore = TokenizedStore.build(jc, JTok(512), max_q_tokens=8,
                                  max_d_tokens=56)
    tstore = TStore.build(tc, TTok(512), max_q_tokens=8, max_d_tokens=56)
    run = {jc.query_ids[q]: [jc.doc_ids[d] for d in range(6 * q, 6 * q + 6)]
           for q in range(4)}
    jr = JReranker(params, cfg, jstore, jc, rel_id=3, nrel_id=4, batch_size=8)
    tr = Reranker(params_from_jax(params), config_from_jax(cfg), tstore, tc,
                  rel_id=3, nrel_id=4, batch_size=8, device="cpu")
    q_rows = np.repeat(np.arange(4), 6)
    d_rows = np.arange(24)
    want = np.asarray(jr.score_pairs(q_rows, d_rows))
    got = tr.score_pairs(q_rows, d_rows)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert tr.rerank(run) == jr.rerank(run)

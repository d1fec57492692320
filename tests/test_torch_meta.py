"""Port of the bilevel meta-weight step (slice C): ``make_meta_train_step``
``cheap`` (NewWrapper) and ``std`` (StdWrapper, a gradient through a
virtual SGD step) against the JAX package on the same numpy inputs and
the same starting state, in fp32 on the CPU; std's v-gradient against
central finite differences (the oracle of tests/test_train.py:201-257);
cheap on the flash_v3 route; std on the plain chunked route; and its
refusal of the hand kernels' routes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.curriculum import MetaWeightTable as JTable
from pacednegatives_tpu.data import DeviceCorpus as JCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_meta_train_step as j_make_meta
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu_torch.curriculum import MetaWeightTable
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.ops.losses import token_ce
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_meta_train_step,
    make_optimizer,
)
from test_torch_train import STEP_ATOL, STEP_RTOL

B, ROWS = 3, 4
META_LR = 0.05


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=40, query_len=8)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8,
                                 max_d_tokens=24)
    triples = TripletStore.synthetic(corpus, n_pairs=12, n_neg=5, seed=1)
    return tok, store, triples


@pytest.fixture(scope="module")
def long_data():
    """Prompts of L >= 64, so the encoder routes through flash_v3."""
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=60, query_len=8)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=48)
    triples = TripletStore.synthetic(corpus, n_pairs=12, n_neg=5, seed=1)
    return tok, store, triples


def _jcfg(**kw):
    return dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), **kw)


def _run_both(data, variant, jcfg, tcfg=None, steps=2):
    """``steps`` meta steps in each package from one converted state, on
    the runner's batches: rows j of the table, pairs (j * B + arange(B)) %
    num_pairs, each at its table weight. Returns the two final states and
    the per-step metrics."""
    tok, store, triples = data
    jtable, ttable = JTable(ROWS, B), MetaWeightTable(ROWS, B)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jtable.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    sched = lambda step: np.float32(META_LR)
    kw = dict(variant=variant, rel_id=tok.true_id, nrel_id=tok.false_id)
    jstep = jax.jit(j_make_meta(jcfg, jtable, jtx, sched, **kw))
    tstep = make_meta_train_step(tcfg or config_from_jax(jcfg), ttable,
                                 make_optimizer(lr=1e-2, total_steps=8),
                                 sched, **kw)
    jc = JCorpus.build(store, triples)
    metrics = []
    for j in range(steps):
        pair_idx = (j * B + jnp.arange(B)) % jc.num_pairs
        jb = jc.pair_batch(pair_idx, jtable.lookup(jstate.curriculum, j))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jstate, jm = jstep(jstate, jb, jnp.int32(j))
        tstate, tm = tstep(tstate, tb, j)
        metrics.append((jm, tm))
    return jstate, tstate, metrics


def _assert_matches(jstate, tstate, metrics):
    for s, (jm, tm) in enumerate(metrics):
        assert set(tm) == set(jm) == {"loss", "avg_weight"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {s} {key}")
    np.testing.assert_allclose(tstate.curriculum.table.numpy(),
                               np.asarray(jstate.curriculum.table),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    assert tstate.step == int(jstate.step)
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    tflat = tt5.flatten_params(tstate.params)
    assert set(tflat) == set(jflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)


@pytest.mark.parametrize("variant,flash_v3", [
    pytest.param("cheap", False, id="cheap"),
    pytest.param("std", False, id="std"),
    pytest.param("cheap", True, id="cheap-flash_v3")])
def test_meta_step_matches_jax(request, monkeypatch, variant, flash_v3):
    """Two steps, no remat: the table rows, the loss, the average weight
    and every parameter (the second update moves them). Dense attention,
    or, for cheap, flash_v3 + fused_qkv at d_kv 64 (JAX in interpret mode,
    the port's FusedSelfAttention on its plain versions): the meta step's
    forwards concatenate q|k|v on each call, so wqkv's gradient flows back
    through the concat. Every encoder layer of each of the four forwards
    must take that route."""
    if not flash_v3:
        jstate, tstate, metrics = _run_both(
            request.getfixturevalue("data"), variant, _jcfg())
        _assert_matches(jstate, tstate, metrics)
        table = tstate.curriculum.table
        assert ((table[:2] > 0) & (table[:2] < 1) & (table[:2] != 1)).all()
        assert torch.equal(table[2:], torch.ones_like(table[2:]))
        return
    calls = []
    fused = tt5.fused_self_attention

    def counted(*args):
        calls.append(args[0].shape)
        return fused(*args)

    monkeypatch.setattr(tt5, "fused_self_attention", counted)
    jcfg = _jcfg(d_kv=64, flash_v3=True, fused_qkv=True,
                 flash_v3_interpret=True)
    jstate, tstate, metrics = _run_both(request.getfixturevalue("long_data"),
                                        variant, jcfg)
    _assert_matches(jstate, tstate, metrics)
    # 2 steps x (frozen pos, neg + main pos, neg) x the encoder's layers
    assert len(calls) == 2 * 4 * jcfg.num_layers
    table = tstate.curriculum.table
    assert ((table[:2] > 0) & (table[:2] < 1) & (table[:2] != 1)).all()
    assert torch.equal(table[2:], torch.ones_like(table[2:]))


def test_meta_std_under_dots_nobatch_matches_jax_default_remat(data):
    """std under the runner's default remat (the selective checkpoint that
    saves the projections' products): the gradient through the virtual
    step runs, and matches JAX's std under its default remat."""
    jstate, tstate, metrics = _run_both(
        data, "std", _jcfg(remat=True, remat_policy="dots_nobatch"))
    _assert_matches(jstate, tstate, metrics)


def test_meta_std_on_plain_chunked_attention(data):
    """std with chunked attention and flash_kernel on the CPU, where
    ``_FlashCore`` takes its plain route (torch ops, twice
    differentiable): against JAX's std on the same chunked config."""
    jcfg = _jcfg(attention_impl="chunked", attention_chunk=16,
                 flash_kernel=True)
    tcfg = config_from_jax(jcfg)
    jstate, tstate, metrics = _run_both(data, "std", jcfg, tcfg, steps=1)
    _assert_matches(jstate, tstate, metrics)


def test_meta_std_refuses_flash_v3():
    """flash_v3 reaches FusedSelfAttention (K3 / K4), which has no double
    backward, on every device."""
    cfg = dataclasses.replace(tt5.T5Config.tiny(vocab_size=256), d_kv=64,
                              flash_v3=True)
    with pytest.raises(NotImplementedError, match="double backward"):
        make_meta_train_step(cfg, MetaWeightTable(ROWS, B),
                             make_optimizer(lr=1e-2, total_steps=8),
                             lambda s: 0.05, variant="std")
    # cheap takes first-order gradients only, and builds
    make_meta_train_step(cfg, MetaWeightTable(ROWS, B),
                         make_optimizer(lr=1e-2, total_steps=8),
                         lambda s: 0.05, variant="cheap")


def test_meta_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        make_meta_train_step(tt5.T5Config.tiny(), MetaWeightTable(ROWS, B),
                             make_optimizer(lr=1e-2, total_steps=8),
                             lambda s: 0.05, variant="newer")


def test_meta_std_gradient_matches_finite_differences(data):
    """The port's own oracle: the stored row after one std step equals
    sigmoid(v - lr * gv_fd), gv_fd the central finite difference (eps
    1e-2) of F(v) = weighted_CE(theta - lr * d/dtheta weighted_CE(theta,
    v), v) - sum(v) evaluated with real model applies, at the tolerances
    of tests/test_train.py:256 (rtol 5e-3, atol 2e-3)."""
    tok, store, triples = data
    cfg = tt5.T5Config.tiny(vocab_size=256)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    table = MetaWeightTable(num_batches=8, batch_size=3)
    tx = make_optimizer(lr=1e-3, total_steps=4)
    step = make_meta_train_step(cfg, table, tx, lambda s: META_LR,
                                variant="std", rel_id=tok.true_id,
                                nrel_id=tok.false_id)
    state = init_train_state(params, tx, table.init())
    dc = DeviceCorpus.build(store, triples, device="cpu")
    batch = dc.pair_batch(torch.arange(3), torch.tensor(0.4))

    def per_example(p):
        return tuple(token_ce(tt5.forward_logits(
            p, cfg, batch[f"{s}_ids"], batch[f"{s}_labels"],
            batch[f"{s}_mask"]), batch[f"{s}_labels"]) for s in ("pos", "neg"))

    def F(v):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in tt5.flatten_params(params).items()}
        pce, nce = per_example(tt5.unflatten_params(leaves))
        g = torch.autograd.grad((pce * v).sum() / 3 + (nce * v).sum() / 3,
                                list(leaves.values()))
        virt = tt5.unflatten_params({k: p.detach() - META_LR * gk
                                     for (k, p), gk in zip(leaves.items(), g)})
        with torch.no_grad():
            pce, nce = per_example(virt)
            return float((pce * v).sum() / 3 + (nce * v).sum() / 3 - v.sum())

    v0 = torch.ones(3)
    eps = 1e-2
    gv_fd = np.zeros(3)
    for i in range(3):
        e = torch.zeros(3)
        e[i] = eps
        gv_fd[i] = (F(v0 + e) - F(v0 - e)) / (2 * eps)

    new_state, _ = step(state, batch, 2)
    got = table.lookup(new_state.curriculum, 2).numpy()
    want = 1.0 / (1.0 + np.exp(-(v0.numpy() - META_LR * gv_fd)))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-3)
    # the gradient is non-trivial (the weights moved off sigmoid(1))
    assert np.max(np.abs(gv_fd)) > 0.1

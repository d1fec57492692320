"""Port of distillation: the mining and teacher-scoring CLIs (host copies)
byte for byte against the JAX package's, and ``make_distill_step`` against
JAX's on the same numpy batch and the same starting state, in fp32 on the
CPU, for MarginMSE and CE under ``remat_policy="dots"`` and for one
MarginMSE step through the fused block (the port's plain K3 / K4 against
the Pallas kernels in interpret mode)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.cli import mine_negatives as j_mine
from pacednegatives_tpu.cli import teacher_scores as j_teach
from pacednegatives_tpu.data import HashTokenizer as JTok
from pacednegatives_tpu.data import TextCorpus as JCorpus
from pacednegatives_tpu.data import TokenizedStore as JStore
from pacednegatives_tpu.distill import TeacherBatcher as JBatcher
from pacednegatives_tpu.distill import make_distill_step as j_make_step
from pacednegatives_tpu.distill import score_teachers as j_score
from pacednegatives_tpu.distill.train import init_distill_state as j_init
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu_torch.cli import mine_negatives as t_mine
from pacednegatives_tpu_torch.cli import teacher_scores as t_teach
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.distill import (
    EnsembleMiner,
    TeacherBatcher,
    make_distill_step,
    score_teachers,
)
from pacednegatives_tpu_torch.distill.train import init_distill_state
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    distill_state_from_jax,
)
from pacednegatives_tpu_torch.train import make_optimizer

# the whole step through 2 + 2 layers: the tolerances tests/test_torch_train.py
# holds the LCE step to (the JAX package's own flash_v3 against dense step
# tolerance, tests/test_flash_v3.py:240-246)
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
STEPS = 3


@pytest.fixture(scope="module")
def corpus():
    return TextCorpus.synthetic(num_docs=40, num_queries=6, seed=0)


@pytest.fixture(scope="module")
def triples(corpus):
    miner = EnsembleMiner.build(corpus, budget=20)
    if not miner.index.native:
        pytest.skip("native lexical library unavailable")
    return miner.mine_triples(corpus, [(f"q{i}", f"d{i}") for i in range(6)],
                              seed=0)


def test_mining_and_teacher_clis_write_the_jax_clis_bytes(tmp_path, corpus,
                                                          triples):
    docs, queries, pairs = (str(tmp_path / f"{k}.tsv")
                            for k in ("docs", "queries", "pairs"))
    with open(docs, "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(corpus.doc_ids,
                                                    corpus.doc_texts))
    with open(queries, "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(corpus.query_ids,
                                                    corpus.query_texts))
    with open(pairs, "w") as f:
        f.writelines(f"q{i}\td{i}\n" for i in range(6))
    out = {}
    for name, mine, teach in (("jax", j_mine, j_teach),
                              ("port", t_mine, t_teach)):
        tsv, js = str(tmp_path / f"{name}.tsv"), str(tmp_path / f"{name}.json")
        mine.main(["--docs", docs, "--queries", queries, "--pairs", pairs,
                   "--out", tsv, "--budget", "20", "--seed", "3"])
        teach.main(["--docs", docs, "--queries", queries, "--triples", tsv,
                    "--out", js])
        with open(tsv, "rb") as f1, open(js, "rb") as f2:
            out[name] = (f1.read(), f2.read())
    assert out["port"] == out["jax"]
    assert out["port"][0].count(b"\n") == 7  # the header and 6 triples


def _batch(triples, max_q, max_d, batch_size):
    """One TeacherBatcher batch from the JAX package's host objects, and the
    port's copy's batch from its own, which must be the same arrays."""
    jc = JCorpus.synthetic(num_docs=40, num_queries=6, seed=0)
    jtok = JTok(vocab_size=256)
    jstore = JStore.build(jc, jtok, max_q_tokens=max_q, max_d_tokens=max_d)
    jbatch = JBatcher(triples, jc, jstore, j_score(jc, triples),
                      batch_size).get_batch(0)
    tc = TextCorpus.synthetic(num_docs=40, num_queries=6, seed=0)
    tok = HashTokenizer(vocab_size=256)
    store = TokenizedStore.build(tc, tok, max_q_tokens=max_q,
                                 max_d_tokens=max_d)
    tbatch = TeacherBatcher(triples, tc, store, score_teachers(tc, triples),
                            batch_size).get_batch(0)
    assert set(tbatch) == set(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], jbatch[k], err_msg=k)
    return tok, jbatch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(jcfg, tok, batch, objective, steps):
    """``steps`` steps of each package's distill step from one JAX state on
    one batch -> (JAX losses, port losses, JAX state, port state)."""
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init(jt5.init_params(jax.random.key(0), jcfg), jtx)
    tstate = distill_state_from_jax(_np_tree(jstate))
    kw = dict(objective=objective, rel_id=tok.true_id, nrel_id=tok.false_id)
    jstep = jax.jit(j_make_step(jcfg, jtx, **kw))
    tstep = make_distill_step(config_from_jax(jcfg),
                              make_optimizer(lr=1e-2, total_steps=8), **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, tl = [], []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert tstate.step == int(jstate.step) == steps
    return jl, tl, jstate, tstate


def _assert_tree_close(port, jax_tree, what):
    jflat = tt5.flatten_params(_np_tree(jax_tree))
    tflat = tt5.flatten_params(port)
    assert set(tflat) == set(jflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=f"{what} {key}")


@pytest.mark.parametrize("objective", ["margin_mse", "ce"])
def test_distill_step_matches_jax(triples, objective):
    """The CLI's recompute (remat ``dots``) at T5Config.tiny in fp32, batch
    3 (6 prompts), three steps (the first update runs at lr(0) = 0): every
    loss, then every parameter."""
    tok, batch = _batch(triples, 8, 24, 3)
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), remat=True,
                               remat_policy="dots")
    jl, tl, jstate, tstate = _run_both(jcfg, tok, batch, objective, STEPS)
    np.testing.assert_allclose(tl, jl, rtol=STEP_RTOL, atol=STEP_ATOL)
    _assert_tree_close(tstate.params, jstate.params, "params")
    first = tt5.flatten_params(_np_tree(jt5.init_params(jax.random.key(0),
                                                        jcfg)))
    assert any(not np.allclose(v.numpy(), first[k], rtol=0, atol=1e-6)
               for k, v in tt5.flatten_params(tstate.params).items()), \
        "the updates moved nothing"


def test_flash_v3_distill_step_matches_jax(triples):
    """One MarginMSE step with the encoder on the fused block at L 64,
    dk 64: JAX's Pallas K3 / K4 in interpret mode against the port's plain
    versions. The first update runs at lr(0) = 0, so the gradient is held
    through Adam's moments."""
    tok, batch = _batch(triples, 12, 48, 3)
    assert batch["ids"].shape == (6, 64)
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), d_kv=64,
                               flash_v3=True, fused_qkv=True,
                               flash_v3_interpret=True)
    jl, tl, jstate, tstate = _run_both(jcfg, tok, batch, "margin_mse", 1)
    np.testing.assert_allclose(tl, jl, rtol=STEP_RTOL, atol=STEP_ATOL)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
        if hasattr(s, "mu")][0]
    _assert_tree_close(tstate.opt_state.mu, adam.mu, "mu")
    _assert_tree_close(tstate.opt_state.nu, adam.nu, "nu")


@pytest.mark.parametrize("objective", ["margin_mse", "ce"])
def test_distill_step_decreases_loss(corpus, triples, objective):
    tok = HashTokenizer(vocab_size=256)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8, max_d_tokens=24)
    b = TeacherBatcher(triples, corpus, store, score_teachers(corpus, triples),
                       batch_size=6)
    batch = {k: torch.from_numpy(v) for k, v in b.get_batch(0).items()}
    cfg = tt5.T5Config.tiny(vocab_size=256)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    tx = make_optimizer(lr=3e-3, total_steps=30)
    step = make_distill_step(cfg, tx, objective, rel_id=tok.true_id,
                             nrel_id=tok.false_id)
    state = init_distill_state(params, tx)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_distill_step_refuses_an_unknown_objective():
    with pytest.raises(ValueError):
        make_distill_step(tt5.T5Config.tiny(256),
                          make_optimizer(1e-3, 8), objective="kl")


def test_distill_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pacednegatives_tpu_torch.cli import distill

    with pytest.raises(RuntimeError, match="cuda"):
        distill.main(["--docs", "d", "--queries", "q", "--triples", "t",
                      "--teacher", "s", "--out_dir",
                      os.path.join(str(tmp_path), "run")])

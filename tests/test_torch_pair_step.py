"""Port of the pair-loss train step (slice C): ``make_train_step(loss=
"pair")`` under each pacing curriculum against the JAX package on the same
numpy inputs and the same starting state, in fp32 on the CPU, and
``DeviceCorpus.pair_batch`` with a per-example difficulty."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.curriculum import ContrastController as JContrast
from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.curriculum import InterpController as JInterp
from pacednegatives_tpu.curriculum import LevelController as JLevel
from pacednegatives_tpu.data import DeviceCorpus as JCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_fused_step as j_make_fused_step
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu_torch.curriculum import (
    ContrastController,
    EtaController,
    InterpController,
    LevelController,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.train import (
    make_fused_step,
    make_optimizer,
    make_train_step,
)
from test_torch_train import STEP_ATOL, STEP_RTOL

B = 4
# the controllers' settings: each moves within two steps (level and
# contrast check every step against a threshold of 0; the tiny model's
# CE of ~log 256 over ce_scale 20 sits below eta 0.5, so eta's weights
# are non-zero and eta moves)
CONTROLLERS = {
    "interp": (JInterp, InterpController,
               dict(start=0.1, end=0.9, num_steps=8, batch_size=B)),
    "level": (JLevel, LevelController,
              dict(n_neg=4, threshold=0.0, check_every=1)),
    "eta": (JEta, EtaController,
            dict(eta0=0.5, meta_lr=0.05, warmup_steps=1, total_steps=8,
                 kind="eta", objective="self_paced", ce_scale=20.0)),
    "contrast": (JContrast, ContrastController,
                 dict(eta0=0.5, meta_lr=0.05, warmup_steps=1, total_steps=8,
                      n_neg=4, threshold=0.0, rate_check=1, ce_scale=20.0)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=60, query_len=8)
    # prompts of L >= 64, so the encoder routes through flash_v3
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=48)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=5, seed=1)
    return tok, store, triples


def _assert_tree_close(got, want, what):
    """A port state (tensors, ints, NamedTuples) against a JAX one."""
    if hasattr(want, "_fields"):
        for name in want._fields:
            _assert_tree_close(getattr(got, name), getattr(want, name),
                               f"{what}.{name}")
    elif isinstance(want, (tuple, list)):
        return  # an optax chain's empty states
    elif isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=what)
    elif isinstance(got, int):
        assert got == int(np.asarray(want)), what


@pytest.mark.parametrize("curriculum,flash_v3,microbatches", [
    ("interp", True, 1), ("interp", False, 2),
    ("level", True, 2), ("level", False, 1),
    ("eta", True, 1), ("eta", False, 2),
    ("contrast", True, 2), ("contrast", False, 1),
])
def test_pair_step_matches_jax(data, curriculum, flash_v3, microbatches):
    """make_train_step(loss="pair"), B 4, two steps (the first update runs
    at lr(0) = 0, the second moves the weights) on the pair batches the
    JAX controller's difficulty draws: JAX (flash_v3 in interpret mode, or
    dense) against the port (plain versions on the CPU) from one converted
    state. Every metric, the curriculum state and every leaf at the
    step tolerances of tests/test_torch_train.py."""
    tok, store, triples = data
    jcfg = dataclasses.replace(
        jt5.T5Config.tiny(vocab_size=256), d_kv=64, flash_v3=flash_v3,
        fused_qkv=True, flash_v3_interpret=flash_v3)
    jcls, tcls, kw = CONTROLLERS[curriculum]
    jctrl, tctrl = jcls(**kw), tcls(**kw)
    step_kw = dict(loss="pair", rel_id=tok.true_id, nrel_id=tok.false_id,
                   microbatches=microbatches)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    jstep = jax.jit(j_make_train_step(jcfg, jctrl, jtx, **step_kw))
    tstep = make_train_step(config_from_jax(jcfg), tctrl,
                            make_optimizer(lr=1e-2, total_steps=8), **step_kw)
    jc = JCorpus.build(store, triples)
    difficulties = []
    for s in range(2):
        difficulty = jctrl.difficulty(jstate.curriculum)
        difficulties.append(float(difficulty))
        np.testing.assert_array_equal(
            tctrl.difficulty(tstate.curriculum).numpy(),
            np.asarray(difficulty))
        jb = jc.pair_batch(jnp.arange(s, s + B, dtype=jnp.int32), difficulty)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {s} {key}")
    assert tstate.step == int(jstate.step) == 2
    _assert_tree_close(tstate.curriculum, _np_tree(jstate.curriculum),
                       "curriculum")
    if curriculum != "eta":
        # eta's difficulty is 0 until its first update, then eta
        assert difficulties[0] != float(
            jctrl.difficulty(jstate.curriculum)), "the difficulty never moved"
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    tflat = tt5.flatten_params(tstate.params)
    assert set(tflat) == set(jflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)


def test_pair_batch_per_example_difficulty_matches_jax(data):
    """pair_batch with a (B,) difficulty (the meta loop's table row): each
    example takes the pool slot its own weight names."""
    _, store, triples = data
    jc = JCorpus.build(store, triples)
    tc = DeviceCorpus.build(store, triples, device="cpu")
    idx = np.array([0, 3, 5, 7])
    weights = np.array([0.0, 0.26, 0.74999994, 1.0], np.float32)
    jb = jc.pair_batch(jnp.asarray(idx), jnp.asarray(weights))
    tb = tc.pair_batch(torch.from_numpy(idx), torch.from_numpy(weights))
    assert set(jb) == set(tb)
    for key in jb:
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]),
                                      err_msg=key)
    np.testing.assert_allclose(tb["neg_rank"].numpy(),
                               [0.0, 0.25, 0.5, 1.0])


def test_fused_pair_step_draws_nothing(data):
    """make_fused_step(loss="pair") assembles the pair batch at the
    controller's difficulty, as the JAX fused step does, and leaves the
    sampling generator where it was."""
    tok, store, triples = data
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), d_kv=64)
    jcls, tcls, kw = CONTROLLERS["interp"]
    jctrl, tctrl = jcls(**kw), tcls(**kw)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    step_kw = dict(loss="pair", rel_id=tok.true_id, nrel_id=tok.false_id)
    jfused = jax.jit(j_make_fused_step(
        JCorpus.build(store, triples),
        j_make_train_step(jcfg, jctrl, jtx, **step_kw), jctrl, loss="pair"))
    tfused = make_fused_step(
        DeviceCorpus.build(store, triples, device="cpu"),
        make_train_step(config_from_jax(jcfg), tctrl,
                        make_optimizer(lr=1e-2, total_steps=8), **step_kw),
        tctrl, loss="pair")
    before = tstate.generator.get_state()
    for s in range(3):
        idx = np.arange(s, s + B)
        jstate, jm = jfused(jstate, jnp.asarray(idx, jnp.int32))
        tstate, tm = tfused(tstate, torch.from_numpy(idx))
        for key in ("loss", "neg_rank", "difficulty"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {s} {key}")
    assert float(tm["neg_rank"]) > 0.0
    assert torch.equal(tstate.generator.get_state(), before)

"""The port's optimizer variants against the JAX package's optax chains on
the CPU: AdamW with a bf16 first moment, the factored second moment
(``scale_by_adam_factored``), gradient accumulation (``optax.MultiSteps``),
their states carried over from JAX, and a checkpoint taken in the middle
of an accumulation."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import train_state_from_jax
from pacednegatives_tpu_torch.optim import (
    AdamState,
    FactoredAdamState,
    MultiStepsState,
    apply_updates,
    tree_leaves,
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

# fp32 on both sides, a few roundings apart (tests/test_torch_train.py)
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
# 2-D and 3-D leaves (factored) and 1-D ones (full nu)
SHAPES = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2), "e": (2, 3, 4)}}
CTRL = dict(eta0=0.9, meta_lr=0.05, warmup_steps=2, total_steps=10,
            kind="lce", objective="weighted_ce", optimizer="adamw",
            clamp=False, ce_scale=2.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _within_one_bf16_ulp(got, want, key) -> None:
    got, want = _f32(got), _f32(want)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-126)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(got - want) <= ulp).all(), key


class _Pair:
    """One optimizer in both packages on the same parameters, fed the
    same gradients."""

    def __init__(self, seed=1, **opt_kw):
        self.rng = np.random.default_rng(seed)
        params = self._tree()
        self.jtx = j_make_optimizer(0.1, total_steps=12, warmup_steps=2,
                                    **opt_kw)
        self.ttx = make_optimizer(0.1, total_steps=12, warmup_steps=2,
                                  **opt_kw)
        # jitted, as the JAX train step runs it: XLA keeps the fp32 excess
        # precision of b1 * mu where eager bf16 arithmetic rounds it
        self.jupdate = jax.jit(self.jtx.update)
        self.jp = jax.tree_util.tree_map(jnp.asarray, params)
        self.tp = tt5.tree_map(torch.from_numpy, params)
        self.jst, self.tst = self.jtx.init(self.jp), self.ttx.init(self.tp)

    def _tree(self):
        return jax.tree_util.tree_map(
            lambda s: self.rng.normal(size=s).astype(np.float32), SHAPES,
            is_leaf=lambda x: isinstance(x, tuple))

    def update(self):
        grads = self._tree()
        ju, self.jst = self.jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads), self.jst, self.jp)
        self.jp = optax.apply_updates(self.jp, ju)
        before = self.tp
        tu, self.tst = self.ttx.update(tt5.tree_map(torch.from_numpy, grads),
                                       self.tst, self.tp)
        self.tp = apply_updates(self.tp, tu)
        return before

    def check_params(self):
        jflat = tt5.flatten_params(_np_tree(self.jp))
        for key, val in tt5.flatten_params(self.tp).items():
            np.testing.assert_allclose(val.numpy(), jflat[key],
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=key)


def _leaf_state(jst, field):
    """The (first) optax sub-state that has ``field``."""
    return next(s for s in jax.tree_util.tree_leaves(
        jst, is_leaf=lambda x: hasattr(x, field)) if hasattr(s, field))


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, None)])
def test_bf16_mu_matches_optax(weight_decay, clip):
    """optax.adamw(mu_dtype=bf16) behind the clip, three updates: the
    stored mu within one bf16 ulp, the rest at the fp32 tolerance."""
    pair = _Pair(weight_decay=weight_decay, grad_clip=clip,
                 moments="bf16_mu")
    for _ in range(3):
        pair.update()
        pair.check_params()
    adam = _leaf_state(pair.jst, "mu")
    assert pair.tst.count == int(adam.count) == 3
    jmu = tt5.flatten_params(_np_tree(adam.mu))
    jnu = tt5.flatten_params(_np_tree(adam.nu))
    for key, val in tt5.flatten_params(pair.tst.mu).items():
        assert val.dtype == torch.bfloat16 and jmu[key].dtype.name == "bfloat16"
        _within_one_bf16_ulp(val, jmu[key], key)
    for key, val in tt5.flatten_params(pair.tst.nu).items():
        np.testing.assert_allclose(val.numpy(), jnu[key], rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=key)


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, None),
                                               (0.01, 100.0)])
def test_factored_matches_jax(weight_decay, clip):
    """make_optimizer(moments="factored") in both packages, three updates
    (the first at lr(0) = 0): bf16 mu within one bf16 ulp; the row and
    column EMAs (the full nu of 1-D leaves) and the weights at the fp32
    tolerance."""
    pair = _Pair(weight_decay=weight_decay, grad_clip=clip,
                 moments="factored")
    for _ in range(3):
        pair.update()
        pair.check_params()
    fac = _leaf_state(pair.jst, "nu_row")
    assert isinstance(pair.tst, FactoredAdamState)
    assert pair.tst.count == int(fac.count) == 3
    for key, val in tt5.flatten_params(pair.tst.mu).items():
        _within_one_bf16_ulp(val, tt5.flatten_params(_np_tree(fac.mu))[key],
                             key)
    for field in ("nu_row", "nu_col"):
        jflat = tt5.flatten_params(_np_tree(getattr(fac, field)))
        for key, val in tt5.flatten_params(getattr(pair.tst, field)).items():
            if val is None:
                assert jflat[key] is None and key.startswith("b.c")
                continue
            np.testing.assert_allclose(val.numpy(), jflat[key],
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"{field} {key}")


@pytest.mark.parametrize("k,moments", [(2, "fp32"), (3, "fp32"),
                                       (2, "factored"), (3, "bf16_mu")])
def test_grad_accum_matches_multisteps(k, moments):
    """grad_accum_steps = k: optax.MultiSteps over six mini-steps, the
    schedule in applied-update units. The weights move only on every k-th
    mini-step and stay bit for bit where they do not."""
    pair = _Pair(moments=moments, grad_accum_steps=k)
    for i in range(6):
        before = pair.update()
        pair.check_params()
        moved = [not torch.equal(a, b) for a, b in
                 zip(tree_leaves(before), tree_leaves(pair.tp))]
        if (i + 1) % k:
            assert not any(moved), f"mini-step {i} moved the weights"
        elif i + 1 > k:  # the first update runs at lr(0) = 0
            assert all(moved), f"update at mini-step {i} moved nothing"
        assert isinstance(pair.tst, MultiStepsState)
        assert pair.tst.mini_step == int(pair.jst.mini_step) == (i + 1) % k
        assert pair.tst.gradient_step == int(pair.jst.gradient_step)
    jacc = tt5.flatten_params(_np_tree(pair.jst.acc_grads))
    for key, val in tt5.flatten_params(pair.tst.acc_grads).items():
        np.testing.assert_allclose(val.numpy(), jacc[key], rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=key)


@pytest.mark.parametrize("k,moments", [(1, "bf16_mu"), (1, "factored"),
                                       (2, "fp32"), (3, "factored")])
def test_train_state_from_jax_continues_identically(k, moments):
    """A JAX TrainState taken mid-run (for k > 1 mid-accumulation) carried
    into the port continues as JAX does."""
    pair = _Pair(moments=moments, grad_accum_steps=k)
    for _ in range(k + 1 if k > 1 else 2):
        pair.update()
    jstate = j_init_state(pair.jp, pair.jtx, JEta(**CTRL).init())
    jstate = jstate._replace(opt_state=pair.jst, key=None)
    tstate = train_state_from_jax(_np_tree(jstate))
    kind = {"fp32": AdamState, "bf16_mu": AdamState,
            "factored": FactoredAdamState}[moments]
    inner = tstate.opt_state.inner_state if k > 1 else tstate.opt_state
    assert isinstance(inner, kind)
    if moments != "fp32":
        assert tree_leaves(inner.mu)[0].dtype == torch.bfloat16
    pair.tp, pair.tst = tstate.params, tstate.opt_state
    for _ in range(2 * k):
        pair.update()
        pair.check_params()


def _loop(moments: str, seed: int = 0):
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=20, query_len=6)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8,
                                 max_d_tokens=16)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=5, seed=1)
    cfg = tt5.T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                       num_heads=2, num_layers=1, num_decoder_layers=1)
    ctrl = EtaController(eta0=2.0, meta_lr=0.05, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=3.0)
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=2,
                        grad_accum_steps=2, moments=moments)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(seed))
    state = init_train_state(params, tx, ctrl.init(), seed=seed)
    tc = DeviceCorpus.build(store, triples, device="cpu")
    step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=2,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    loop = TrainLoop(make_fused_step(tc, step, ctrl, loss="lce",
                                     n_neg_per_example=2),
                     num_pairs=len(triples), batch_size=2, chunk_size=1,
                     corpus=tc)
    return state, loop


@pytest.mark.parametrize("moments", ["fp32", "bf16_mu", "factored"])
def test_resume_mid_accumulation_equals_uninterrupted(tmp_path, moments):
    state, loop = _loop(moments)
    straight = loop.run(state, 6)
    state, loop = _loop(moments)
    half = loop.run(state, 3)
    assert half.opt_state.mini_step == 1
    save_checkpoint(str(tmp_path / "step_3"), half)
    template, loop = _loop(moments, seed=7)  # other weights, RNG
    resumed = loop.run(restore_checkpoint(str(tmp_path / "step_3"),
                                          template), 6)
    assert resumed.step == straight.step == 6
    assert resumed.opt_state.gradient_step == 3
    for a, b in zip(tree_leaves(straight.params),
                    tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(straight.opt_state.inner_state.mu),
                    tree_leaves(resumed.opt_state.inner_state.mu)):
        assert a.dtype == b.dtype and torch.equal(a, b)

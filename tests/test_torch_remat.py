"""The port's selective recompute (``remat_policy`` "full", "dots",
"dots_nobatch") and the ReLU-FFN custom VJP (``ffn_custom_vjp``), on the
CPU: every policy gives the step the numbers of the step without remat on
each attention route, the recompute re-runs exactly the ops its policy does
not save, and the dots_nobatch step matches the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.data import DeviceCorpus as JCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

# a recompute repeats the forward's ops on the same inputs: the step is
# the same to the last bits but for summation-order noise
RTOL, ATOL = 1e-5, 1e-6
# the whole step through 2 + 2 layers against JAX (test_torch_train.py)
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
N_NEG = 2
POLICIES = ("full", "dots", "dots_nobatch")
# dense; flash_v3 (the fused block's plain versions); chunked over 32-key
# chunks (three chunks of the 72-token prompts' keys, padded to 96)
ROUTES = {
    "dense": {},
    "flash_v3": {"flash_v3": True},
    "chunked": {"attention_impl": "chunked", "attention_chunk": 32},
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=60, query_len=8)
    # prompts of L 64 + 8 = 72 >= 64, so the encoder takes flash_v3
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=56)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=5, seed=1)
    jc = JCorpus.build(store, triples)
    batches = []
    for s in range(2):
        jb = jc.lce_batch(jax.random.key(s), jnp.arange(4, dtype=jnp.int32),
                          0.5, N_NEG)
        batches.append({k: np.array(v) for k, v in jb.items()})
    return tok, batches


def _jcfg(**kw):
    return dataclasses.replace(jt5.T5Config.tiny(vocab_size=256), d_kv=64,
                               **kw)


CTRL = dict(eta0=2.0, meta_lr=0.01, warmup_steps=1, total_steps=8,
            kind="lce", objective="weighted_ce", optimizer="adamw",
            clamp=False, ce_scale=3.0)


def _step_kw(tok):
    return dict(loss="lce", n_neg_per_example=N_NEG, use_mean=True,
                rel_id=tok.true_id, nrel_id=tok.false_id, microbatches=2)


def _port_run(cfg, tok, batches, params):
    """Two steps of the port's make_train_step from ``params``; the
    metrics of each and the final state."""
    ctrl = EtaController(**CTRL)
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=0)
    state = init_train_state(params, tx, ctrl.init())
    step = make_train_step(cfg, ctrl, tx, **_step_kw(tok))
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append(m)
    return metrics, state


@pytest.mark.parametrize("route,policy,ffn_custom_vjp", [
    *((r, p, False) for r in ROUTES for p in POLICIES),
    ("dense", "dots_nobatch", True),
])
def test_remat_step_matches_plain_step(data, route, policy, ffn_custom_vjp):
    tok, batches = data
    cfg = config_from_jax(_jcfg(fused_qkv=True, **ROUTES[route]))
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    plain = _port_run(cfg, tok, batches, params)
    remat = _port_run(dataclasses.replace(cfg, remat=True,
                                          remat_policy=policy,
                                          ffn_custom_vjp=ffn_custom_vjp),
                      tok, batches, params)
    for m0, m1 in zip(plain[0], remat[0]):
        for key in m0:
            torch.testing.assert_close(m1[key], m0[key], rtol=RTOL,
                                       atol=ATOL, msg=key)
    for key, a in tt5.flatten_params(plain[1].params).items():
        torch.testing.assert_close(tt5.flatten_params(remat[1].params)[key],
                                   a, rtol=RTOL, atol=ATOL, msg=key)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _record_saved(monkeypatch) -> list:
    """Wrap the policies so that each output a policy saves in a forward
    leaves its shape in the returned list."""
    saved = []
    make = tt5.remat_policy_fn

    def recording(saved_ops):
        policy = make(saved_ops)

        def record(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if (not ctx.is_recompute
                    and decision == CheckpointPolicy.MUST_SAVE):
                a, b = args[0], args[1]  # mm / bmm operands
                saved.append(tuple(a.shape[:-1]) + (b.shape[-1],))
            return decision

        return record

    monkeypatch.setattr(tt5, "remat_policy_fn", recording)
    return saved


def _backward_ops(cfg, params, ids, labels) -> dict:
    """Forward under ``cfg``, then count the ops the backward runs: on the
    CPU the recompute runs on this thread, and a saved op's cached output
    is returned without running the op."""
    p = tt5.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = tt5.forward_logits(p, cfg, ids, labels).square().mean()
    with _OpCount() as count:
        loss.backward()
    return count.counts


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_runs_what_the_policy_does_not_save(route, policy,
                                                      monkeypatch):
    """The backward's aten.mm / aten.bmm counts against remat=False's (the
    backward's own products): "full" recomputes both kinds, "dots" neither,
    "dots_nobatch" only the attention products; dots_nobatch saves no
    batched product, so no (B, H, Lq, Lk) scores, and dots saves the
    encoder's scores on the routes that form them whole."""
    cfg = config_from_jax(_jcfg(fused_qkv=True, **ROUTES[route]))
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    B, L = 2, 72
    ids = torch.from_numpy(rng.integers(2, 256, (B, L)))
    labels = torch.from_numpy(rng.integers(2, 256, (B, 2)))
    base = _backward_ops(cfg, params, ids, labels)
    saved = _record_saved(monkeypatch)
    counts = _backward_ops(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), params,
        ids, labels)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    extra = {op: counts.get(op, 0) - base.get(op, 0) for op in (mm, bmm)}
    if policy == "full":
        assert extra[mm] > 0 and extra[bmm] > 0 and not saved
    if policy == "dots":
        assert extra[mm] == 0 and extra[bmm] == 0
    if policy == "dots_nobatch":
        assert extra[mm] == 0 and extra[bmm] > 0
        assert saved and all(len(s) == 2 for s in saved)
    scores = [s for s in saved if s == (B * cfg.num_heads, L, L)]
    if policy == "dots" and route != "chunked":
        assert scores
    if policy != "dots":
        assert not scores


def test_einsum_projection_would_dispatch_to_bmm():
    """Why the port's projections stay torch.matmul: a 3-D activation times
    a 2-D weight folds to aten.mm (saved by dots_nobatch), where the einsum
    "bld,df->blf" dispatches to aten.bmm (recomputed)."""
    x, w = torch.randn(2, 5, 8), torch.randn(8, 4)
    with _OpCount() as count:
        torch.matmul(x, w)
    assert torch.ops.aten.mm.default in count.counts
    assert torch.ops.aten.bmm.default not in count.counts
    with _OpCount() as count:
        torch.einsum("bld,df->blf", x, w)
    assert torch.ops.aten.bmm.default in count.counts
    assert torch.ops.aten.mm.default not in count.counts


def test_dots_nobatch_step_matches_jax(data):
    """make_train_step with remat_policy="dots_nobatch" (dense attention,
    microbatches 2, two steps) in both packages from one state; one layer
    a stack, to keep JAX's compile short."""
    tok, batches = data
    jcfg = _jcfg(fused_qkv=True, remat=True, remat_policy="dots_nobatch",
                 num_layers=1, num_decoder_layers=1)
    jctrl, tctrl = JEta(**CTRL), EtaController(**CTRL)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    jstep = jax.jit(j_make_train_step(jcfg, jctrl, jtx, **_step_kw(tok)))
    tstep = make_train_step(config_from_jax(jcfg), tctrl,
                            make_optimizer(lr=1e-2, total_steps=8),
                            **_step_kw(tok))
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=key)
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    for key, val in tt5.flatten_params(tstate.params).items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# The ReLU-FFN custom VJP
# ---------------------------------------------------------------------------


def _ffn_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    wi = rng.normal(size=(16, 32)).astype(np.float32) * 0.25
    wo = rng.normal(size=(32, 16)).astype(np.float32) * 0.25
    g = rng.normal(size=(2, 7, 16)).astype(np.float32)
    return x, wi, wo, g


def test_relu_ffn_vjp_matches_plain_and_jax():
    x, wi, wo, g = _ffn_inputs()
    jy, vjp = jax.vjp(jt5._relu_ffn, *map(jnp.asarray, (x, wi, wo)))
    jgrads = vjp(jnp.asarray(g))
    cfg = tt5.T5Config(d_model=16, d_ff=32)
    outs = {}
    for custom in (False, True):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, wi, wo)]
        y = tt5.mlp({"wi": xs[1], "wo": xs[2]},
                    dataclasses.replace(cfg, ffn_custom_vjp=custom), xs[0])
        y.backward(torch.from_numpy(g))
        outs[custom] = (y.detach(), [t.grad for t in xs])
    for custom, (y, grads) in outs.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        for got, want, plain in zip(grads, jgrads, outs[False][1]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)


def test_relu_ffn_saves_post_relu_hidden_only():
    x, wi, wo, _ = _ffn_inputs()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    cfg = tt5.T5Config(d_model=16, d_ff=32, ffn_custom_vjp=True)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, wi, wo)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tt5.mlp({"wi": xs[1], "wo": xs[2]}, cfg, xs[0])
    hidden = [t for t in saved if t.shape == (2, 7, 32)]
    h = torch.relu(torch.matmul(xs[0], xs[1])).detach()
    assert len(saved) == 4 and len(hidden) == 1
    assert torch.equal(hidden[0], h)  # post-ReLU: no negative entry
    assert (h == 0).any() and (torch.matmul(xs[0], xs[1]) < 0).any()

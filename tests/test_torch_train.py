"""Port of the LCE training path: DeviceCorpus, EtaController, the AdamW
optimizer, the whole ``make_train_step(loss="lce")``, checkpoint/resume and
the training CLI, against the JAX package on the same numpy inputs and the
same starting state, in fp32 on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.curriculum.base import StepSignals as JSignals
from pacednegatives_tpu.data import DeviceCorpus as JCorpus
from pacednegatives_tpu.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu.data import TripletStore
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu.train.loop import pair_index_stream as j_stream
from pacednegatives_tpu_torch.cli.train import main as cli_main
from pacednegatives_tpu_torch.curriculum import EtaController, StepSignals
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    train_state_from_jax,
)
from pacednegatives_tpu_torch.optim import apply_updates
from pacednegatives_tpu_torch.train import (
    TrainLoop,
    init_train_state,
    make_fused_step,
    make_optimizer,
    make_train_step,
    pair_index_stream,
    restore_checkpoint,
    save_checkpoint,
)
from pacednegatives_tpu_torch.train.runner import RunConfig, _check_ported, run

# optimizer and controller arithmetic: fp32 on both sides, a few roundings
# apart (pow, sqrt, the global-norm sum order); the updates are O(lr) = 0.1,
# so a few ulps of an update are ~1e-6 absolute
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
# the whole step through 2 + 2 layers (the JAX package's own flash_v3
# against dense step tolerance, tests/test_flash_v3.py:240-246)
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4


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


# ---------------------------------------------------------------------------
# Data, sampler stream, controller, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_device_corpus_matches_jax(data, packed):
    _, store, triples = data
    jc = JCorpus.build(store, triples, packed=packed)
    tc = DeviceCorpus.build(store, triples, device="cpu", packed=packed)
    q_rows, d_rows = np.array([0, 3, 5, 7]), np.array([1, 15, 2, 9])
    for a, b in zip(jc.assemble(jnp.asarray(q_rows), jnp.asarray(d_rows)),
                    tc.assemble(torch.from_numpy(q_rows),
                                torch.from_numpy(d_rows))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for positive in (True, False):
        np.testing.assert_array_equal(tc.labels(3, positive).numpy(),
                                      np.asarray(jc.labels(3, positive)))
    idx = np.array([1, 2, 6])
    for diff in (0.0, 0.4, 1.0):
        jb = jc.pair_batch(jnp.asarray(idx), diff)
        tb = tc.pair_batch(torch.from_numpy(idx), diff)
        assert set(jb) == set(tb)
        for key in jb:
            np.testing.assert_allclose(tb[key].numpy(), np.asarray(jb[key]),
                                       err_msg=key)
    # LCE batches are random: check the structure, and that each negative
    # is the pool slot its neg_rank names
    g = torch.Generator().manual_seed(0)
    tb = tc.lce_batch(g, torch.from_numpy(idx), torch.tensor(0.5), 3)
    assert tb["neg_ids"].shape == (9, tb["pos_ids"].shape[1])
    slots = np.rint(tb["neg_rank"].numpy() * (triples.n_neg - 1)).astype(int)
    docs = triples.pools[np.repeat(idx, 3), slots]
    ids, _ = tc.assemble(torch.from_numpy(triples.query_rows[np.repeat(idx, 3)]
                                          .astype(np.int64)),
                         torch.from_numpy(docs.astype(np.int64)))
    np.testing.assert_array_equal(tb["neg_ids"].numpy(), ids.numpy())
    assert all(len(set(r)) == 3 for r in slots.reshape(3, 3))


def test_pair_index_stream_matches_jax():
    a, b = j_stream(20, 3, seed=4, exclude=[2, 5]), pair_index_stream(
        20, 3, seed=4, exclude=[2, 5])
    for _ in range(12):
        np.testing.assert_array_equal(next(a), next(b))


def _signals(rng, B=6):
    pce, nce, ce = (rng.random(B).astype(np.float32) * 3 for _ in range(3))
    succ = (rng.random(B) > 0.5).astype(np.float32)
    return (pce, nce, ce, succ)


@pytest.mark.parametrize("kind,milestones", [("eta", ()),
                                             ("lce", ((2, 0.1),))])
def test_eta_controller_matches_optax(kind, milestones):
    kw = dict(eta0=0.9, meta_lr=0.05, warmup_steps=2, total_steps=10,
              kind=kind, ce_scale=2.0, milestones=milestones)
    if kind == "lce":
        kw.update(objective="weighted_ce", optimizer="adamw", clamp=False)
    jc, tc = JEta(**kw), EtaController(**kw)
    js, ts = jc.init(), tc.init()
    rng = np.random.default_rng(0)
    for _ in range(3):
        sig = _signals(rng)
        jsig = JSignals(*map(jnp.asarray, sig))
        tsig = StepSignals(*map(torch.from_numpy, sig))
        np.testing.assert_allclose(float(tc.meta_loss(ts, tsig)),
                                   float(jc.meta_loss(js, jsig)),
                                   rtol=OPT_RTOL)
        js, ts = jc.update(js, jsig), tc.update(ts, tsig)
        np.testing.assert_allclose(float(ts.eta), float(js.eta),
                                   rtol=OPT_RTOL, atol=OPT_ATOL)
        np.testing.assert_allclose(float(tc.difficulty(ts)),
                                   float(jc.difficulty(js)), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(tc.success_rate(ts, tsig)),
                                   float(jc.success_rate(js, jsig)),
                                   rtol=OPT_RTOL)
    jstate = j_init_state({"w": jnp.zeros(2)}, j_make_optimizer(0.1, 10), js)
    state = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    assert state.curriculum.step == 3 and state.opt_state.count == 0
    np.testing.assert_allclose(float(state.curriculum.opt_state.nu),
                               float(ts.opt_state.nu), rtol=OPT_RTOL)


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, None),
                                               (0.0, 100.0)])
def test_optimizer_matches_optax(weight_decay, clip):
    """Three AdamW updates with a warmup schedule; the first update uses
    lr(0) = 0, and clip 1.0 triggers on these gradients while 100 does
    not."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2)}}
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    params = jax.tree_util.tree_map(mk, shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    jtx = j_make_optimizer(0.1, total_steps=10, warmup_steps=2,
                           weight_decay=weight_decay, grad_clip=clip)
    ttx = make_optimizer(0.1, total_steps=10, warmup_steps=2,
                         weight_decay=weight_decay, grad_clip=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tt5.tree_map(torch.from_numpy, params)
    jst, tst = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: mk(p.shape), params)
        ju, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jst,
                             jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update(tt5.tree_map(torch.from_numpy, grads), tst, tp)
        tp = apply_updates(tp, tu)
        jflat = tt5.flatten_params(_np_tree(jp))
        for key, val in tt5.flatten_params(tp).items():
            np.testing.assert_allclose(val.numpy(), jflat[key],
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=key)
    adam = next(s for s in jax.tree_util.tree_leaves(
        jst, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    assert tst.count == int(adam.count) == 3
    jmu = tt5.flatten_params(_np_tree(adam.mu))
    for key, val in tt5.flatten_params(tst.mu).items():
        np.testing.assert_allclose(val.numpy(), jmu[key], rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


def test_unported_optimizer_settings_raise():
    with pytest.raises(ValueError):
        make_optimizer(0.1, 10, moments="fp16")


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

N_NEG = 2


def _jax_setup(data, flash_v3, label_grouping, use_mean):
    tok, store, triples = data
    jcfg = dataclasses.replace(
        jt5.T5Config.tiny(vocab_size=256), d_kv=64, flash_v3=flash_v3,
        fused_qkv=True, flash_v3_interpret=flash_v3)
    kw = dict(eta0=2.0, meta_lr=0.01, warmup_steps=1, total_steps=8,
              kind="lce", objective="weighted_ce", optimizer="adamw",
              clamp=False, ce_scale=3.0)
    step_kw = dict(loss="lce", n_neg_per_example=N_NEG, use_mean=use_mean,
                   label_grouping=label_grouping, rel_id=tok.true_id,
                   nrel_id=tok.false_id, microbatches=2)
    return jcfg, kw, step_kw


@pytest.mark.parametrize("flash_v3,label_grouping,use_mean", [
    (True, "per_example", True),
    (False, "flat_tokens", False),
])
def test_train_step_matches_jax(data, flash_v3, label_grouping, use_mean):
    """make_train_step(loss="lce"), B 4, n 2, microbatches 2, two steps
    (the first update runs at lr(0) = 0, the second moves the weights):
    JAX (flash_v3 in interpret mode, or dense) against the port (plain
    versions on the CPU) from one state and on the same batches."""
    _, store, triples = data
    jcfg, ctrl_kw, step_kw = _jax_setup(data, flash_v3, label_grouping,
                                        use_mean)
    jctrl, tctrl = JEta(**ctrl_kw), EtaController(**ctrl_kw)
    jtx = j_make_optimizer(lr=1e-2, total_steps=8)
    jstate = j_init_state(jt5.init_params(jax.random.key(0), jcfg), jtx,
                          jctrl.init())
    tstate = train_state_from_jax(_np_tree(jstate._replace(key=None)))
    jstep = jax.jit(j_make_train_step(jcfg, jctrl, jtx, **step_kw))
    tstep = make_train_step(config_from_jax(jcfg), tctrl,
                            make_optimizer(lr=1e-2, total_steps=8), **step_kw)
    jc = JCorpus.build(store, triples)
    for s in range(2):
        jb = jc.lce_batch(jax.random.key(s), jnp.arange(4, dtype=jnp.int32),
                          0.5, N_NEG)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"step {s} {key}")
    assert tstate.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(tstate.curriculum.eta),
                               float(jstate.curriculum.eta),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    jflat = tt5.flatten_params(_np_tree(jstate.params))
    tflat = tt5.flatten_params(tstate.params)
    assert set(tflat) == set(jflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)
    first = tt5.flatten_params(_np_tree(jt5.init_params(jax.random.key(0),
                                                        jcfg)))
    assert any(not np.allclose(v.numpy(), first[k], rtol=0, atol=1e-6)
               for k, v in tflat.items()), "the second update moved nothing"


def test_remat_matches_plain_step(data):
    """remat=True (torch.utils.checkpoint per block) gives the step the
    same numbers."""
    _, store, triples = data
    jcfg, ctrl_kw, step_kw = _jax_setup(data, True, "per_example", True)
    cfg = config_from_jax(jcfg)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    tc = DeviceCorpus.build(store, triples, device="cpu")
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        ctrl = EtaController(**ctrl_kw)
        tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=0)
        state = init_train_state(params, tx, ctrl.init())
        step = make_fused_step(tc, make_train_step(c, ctrl, tx, **step_kw),
                               ctrl, loss="lce", n_neg_per_example=N_NEG)
        outs.append(step(state, torch.arange(4)))
    (s0, m0), (s1, m1) = outs
    torch.testing.assert_close(m0["loss"], m1["loss"], rtol=1e-6, atol=1e-6)
    for a, b in zip(tt5.flatten_params(s0.params).values(),
                    tt5.flatten_params(s1.params).values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints, runner, CLI
# ---------------------------------------------------------------------------


def _tiny_loop_state(data, seed=0):
    tok, store, triples = data
    cfg = tt5.T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                       num_heads=2, num_layers=1, num_decoder_layers=1)
    ctrl = EtaController(eta0=2.0, meta_lr=0.05, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=3.0)
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=1)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(seed))
    state = init_train_state(params, tx, ctrl.init(), seed=seed)
    tc = DeviceCorpus.build(store, triples, device="cpu")
    step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=2,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    loop = TrainLoop(make_fused_step(tc, step, ctrl, loss="lce",
                                     n_neg_per_example=2),
                     num_pairs=len(triples), batch_size=2, chunk_size=2,
                     corpus=tc)
    return state, loop


def test_checkpoint_resume_equals_uninterrupted(data, tmp_path):
    state, loop = _tiny_loop_state(data)
    straight = loop.run(state, 5)
    state, loop = _tiny_loop_state(data)
    half = loop.run(state, 2)
    save_checkpoint(str(tmp_path / "step_2"), half)
    template, loop = _tiny_loop_state(data, seed=7)  # other weights, RNG
    resumed = loop.run(restore_checkpoint(str(tmp_path / "step_2"),
                                          template), 5)
    assert resumed.step == straight.step == 5
    for a, b in zip(tt5.flatten_params(straight.params).values(),
                    tt5.flatten_params(resumed.params).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(resumed.curriculum.eta, straight.curriculum.eta,
                               rtol=0, atol=0)
    assert resumed.opt_state.count == straight.opt_state.count == 5
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())


def test_cli_train_main_on_cpu(tmp_path, capsys):
    """The training CLI on the CPU: config.json, metrics.jsonl, a final
    checkpoint, and the JAX runner's summary keys on stdout."""
    out = tmp_path / "run"
    summary = cli_main(
        preset={"curriculum": "lce", "model": "tiny", "remat": False,
                "total_steps": 12, "batch_size": 4, "n": 2, "chunk_size": 2,
                "synthetic_docs": 24, "synthetic_pairs": 12,
                "max_q_tokens": 8, "max_d_tokens": 24, "eval_every_steps": 2,
                "eval_pairs": 4, "out_dir": str(out)},
        argv=["--device", "cpu", "--microbatches", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    assert set(summary) == {"steps", "final_loss", "out_dir"}
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    rows = [json.loads(l) for l in (out / "metrics.jsonl").read_text()
            .splitlines()]
    assert {"loss", "probs", "p_true", "eta", "difficulty", "success_rate",
            "neg_rank", "meta_loss"} <= set(rows[1])
    assert any("eval/mrr_hard" in r for r in rows)
    assert (out / "final" / "state.pt").exists()
    assert json.loads((out / "config.json").read_text())["microbatches"] == 2


@pytest.mark.parametrize("field,value", [
    ("scan_layers", True), ("scored_pool", 4),
    ("export_hf", True), ("model", "/some/hf/dir"),
])
def test_run_refuses_unported_settings(tmp_path, field, value):
    """The layer scan is not carried over and raises, naming its ROADMAP
    item. The scored pool (slice P), the HF export and an HF checkpoint
    directory (slice R) are ported: the check lets them through, and a
    directory that does not exist fails to load."""
    cfg = RunConfig(**{"model": "tiny", "out_dir": str(tmp_path),
                       field: value})
    if field == "scan_layers":
        with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP"):
            run(cfg, device="cpu")
        return
    _check_ported(cfg)
    if field == "model":
        with pytest.raises(FileNotFoundError, match=value):
            run(cfg, device="cpu")


def test_run_never_falls_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig(model="tiny", remat=False, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        run(cfg, device="cuda")

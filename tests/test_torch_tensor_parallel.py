"""Tensor parallelism in the port: meshes with model=2 over gloo ranks on
the CPU, against one process and against the JAX package's single device.

Four processes of ``tests/torch_parallel_worker.py`` (``tp`` cases) form a
group of 4 ranks (dp2 x tp2, then data1 x seq2 x tp2), then two of them a
group of 2 (tp2). Meanwhile this process computes the references: every
case in one process of the port (the same generator draws, so the same
batches) and JAX's single-device step on the batches one process drew
(test_sharding_equivalence.py's model and tolerances: loss rtol 1e-5,
parameters rtol 1e-4 / atol 1e-6). Every case runs two steps at a constant
learning rate, so both steps move the weights. The 8-rank dp2 x seq2 x tp2
mesh of tests/test_scored_pool.py is left out for time: its row split is
dp2 x seq2's and its weight split tp2's, each held here.

Cases: the fused LCE step (tp2, dp2 x tp2, data1 x seq2 x tp2; the
gradient unclipped, then with the clip engaged), every arm of
``dryrun_multichip`` on dp2 x tp2 (packed assembly, the scored pool in
bf16, int8 and length buckets, the online step over a 2-shard index, the
overlapped refresh), the factored moments, dropout on the dense route,
TrainLoop's checkpoint (read back by one process) and resume, the W8A8
scores, the HF export, the K2a / K2b route at t5-base's heads, and
``param_shardings`` against JAX's leaf by leaf.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as W
from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.curriculum import InterpController as JInterp
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.parallel import MeshConfig as JMeshConfig
from pacednegatives_tpu.parallel import create_mesh as j_create_mesh
from pacednegatives_tpu.parallel import param_shardings as j_param_shardings
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu_torch.data import HashTokenizer
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.convert import params_from_jax
from pacednegatives_tpu_torch.parallel.collectives import (
    copy_to_model,
    reduce_from_model,
)
from pacednegatives_tpu_torch.parallel.mesh import (
    Mesh,
    model_split,
    param_shardings,
    shard_params,
)
from pacednegatives_tpu_torch.train import (
    init_train_state,
    restore_checkpoint,
)
from test_torch_multiproc import (
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_RTOL,
    _close_params,
    _jax_cfg,
    _spawn,
    _wait,
)

CPU = torch.device("cpu")


_JAX_STEPS = {}


def _jax_tp_cfg():
    """The worker's ``TP_CFG``: test_sharding_equivalence's model with the
    gated-GELU FFN."""
    return jt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=256,
                        num_heads=4, num_layers=2, num_decoder_layers=2,
                        gated_ffn=True)


def _jax_run(jparams, batches, clip=None, interp=False, relu=False):
    """JAX's single-device step (optax.adamw at the worker's constant lr
    and eps, behind clip_by_global_norm when ``clip``) on ``batches``:
    (losses, params, mu)."""
    tok = HashTokenizer(vocab_size=512)
    ctrl = (JInterp(start=0.2, end=0.8, num_steps=24, batch_size=8) if interp
            else JEta(**W.CTRL))
    tx = optax.adamw(W.TP_LR, eps=W.TP_EPS, weight_decay=0.0)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    key = (clip, interp, relu)
    if key not in _JAX_STEPS:  # one jit a configuration
        _JAX_STEPS[key] = jax.jit(j_make_train_step(
            _jax_cfg() if relu else _jax_tp_cfg(), ctrl, tx, loss="lce",
            n_neg_per_example=W.N_NEG,
            rel_id=tok.true_id, nrel_id=tok.false_id))
    step = _JAX_STEPS[key]
    state = j_init_state(jparams, tx, ctrl.init())
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v.numpy().astype(
            np.int32 if v.dtype == torch.int64 else v.numpy().dtype))
            for k, v in b.items()}
        state, m = step(state, jb)
        losses.append(float(m["loss"]))
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    flat = lambda t: {k: np.asarray(v) for k, v in
                      W.t5.flatten_params(jax.device_get(t)).items()}
    return losses, flat(state.params), flat(adam.mu)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jparams = jt5.init_params(jax.random.key(0), _jax_tp_cfg())
    jrelu = jt5.init_params(jax.random.key(0), _jax_cfg())
    params, relu = (params_from_jax(jax.tree_util.tree_map(np.asarray, p))
                    for p in (jparams, jrelu))
    work = str(tmp_path_factory.mktemp("tp_ranks"))
    torch.save({"params": params, "params_relu": relu},
               os.path.join(work, "inputs.pt"))
    procs = _spawn(work, "tp")
    threads = torch.get_num_threads()
    one, jax_ref = {"initial": params}, {}
    try:
        # one intra-op thread, as the ranks have
        torch.set_num_threads(1)
        fused = dict(
            fused={}, clip=dict(clip=W.TP_CLIP), packed=dict(packed=True),
            scored=dict(kind="scored"),
            scored_int8=dict(kind="scored", score_dtype="int8"),
            scored_buckets=dict(kind="scored", packed=True,
                                buckets=W.TP_BUCKETS))
        for case, kw in fused.items():
            batches = []
            one[case] = W.tp_steps(params, batches=batches, **kw)
            jax_ref[case] = _jax_run(jparams, batches, kw.get("clip"))
        batches = []
        one["relu"] = W.tp_steps(relu, cfg=W.CFG, steps=1, batches=batches)
        jax_ref["relu"] = _jax_run(jrelu, batches, relu=True)
        one["factored"] = W.tp_steps(params, clip=W.TP_CLIP,
                                     moments="factored")
        one["dropout"] = W.tp_steps(params, dropout=True)
        batches = []
        one["online"] = W.tp_online(params, batches=batches)
        jax_ref["online"] = _jax_run(jparams, batches, interp=True)
        one["overlap"] = W.tp_online(params, overlap=True)
        one["loop"] = W.tp_loop(params, str(tmp_path_factory.mktemp("lp")))
        one["int8_scores"] = W.tp_int8_scores(params)
        one["route"] = W.tp_route()
        one["export"] = W.tp_export(params,
                                    str(tmp_path_factory.mktemp("hf")))
    finally:
        torch.set_num_threads(threads)
        outs = _wait(procs, work)
    return {4: outs, 2: outs[:2]}, one, jax_ref


def _same_on_every_rank(outs: list, trees=("params", "mu")):
    """The whole state each rank gathered equals rank 0's bit for bit: the
    whole leaves are the same on every rank, and the ranks of a row agree
    on the split ones."""
    for out in outs[1:]:
        for key in ("loss", "eta", "difficulty"):
            assert out[key] == outs[0][key], key
        for tree in trees:
            for name, val in out[tree].items():
                assert torch.equal(val, outs[0][tree][name]), (tree, name)


def _held(got: dict, one: dict, jax_ref=None):
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eta"], one["eta"], rtol=LOSS_RTOL)
    for tree in ("params", "mu"):
        _close_params(got[tree], one[tree], f"one process {tree}")
    if jax_ref is not None:
        losses, params, mu = jax_ref
        np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_RTOL)
        _close_params(got["params"], params, "jax params")
        _close_params(got["mu"], mu, "jax mu")


@pytest.mark.parametrize("world,case", [(2, "tp2"), (4, "dp2_tp2"),
                                        (4, "seq2_tp2")])
def test_step_matches_one_process_and_jax(runs, world, case):
    """The fused LCE step over tp2, dp2 x tp2 and data1 x seq2 x tp2, two
    steps that move the weights, the gradient unclipped: the step equals
    one process's on the same draws and JAX's single device on the same
    batches. AdamW's first moment is a sum of the unclipped gradients, so
    a gradient off by any factor fails here (a column-parallel input's
    dropped backward all-reduce among them)."""
    ranks, one, jax_ref = runs
    outs = [r[case] for r in ranks[world]]
    _same_on_every_rank(outs)
    initial = t5.flatten_params(one["initial"])
    moved = [not torch.equal(outs[0]["params"][k], v)
             for k, v in initial.items()]
    assert all(moved)
    _held(outs[0], one["fused"], jax_ref["fused"])


def test_relu_ffn_step_matches_one_process_and_jax(runs):
    """test_sharding_equivalence's own model (T5 v1.0's ReLU FFN) under
    tp2: one step at lr(0) > 0, which moves the weights, held at the same
    tolerances (the two-step cases run the gated FFN; see the worker's
    TP_CFG)."""
    ranks, one, jax_ref = runs
    outs = [r["relu"] for r in ranks[2]]
    _same_on_every_rank(outs)
    _held(outs[0], one["relu"], jax_ref["relu"])


def test_clip_engaged_matches_one_process_and_jax(runs):
    """tp2 with the global-norm clip engaged (the norm is above
    ``TP_CLIP`` at both steps): the norm counts each logical element once,
    so a whole leaf counted ``model`` times fails here."""
    ranks, one, jax_ref = runs
    outs = [r["tp2_clip"] for r in ranks[2]]
    _same_on_every_rank(outs)
    _held(outs[0], one["clip"], jax_ref["clip"])
    # the clip changed the update: the unclipped run's weights differ
    diff = max((outs[0]["params"][k] - ranks[2][0]["tp2"]["params"][k])
               .abs().max().item() for k in outs[0]["params"])
    assert diff > 1e-4


@pytest.mark.parametrize("case", ["packed", "scored", "scored_int8",
                                  "scored_buckets"])
def test_dryrun_arm_matches_one_process_and_jax(runs, case):
    """dryrun_multichip's arms on dp2 x tp2: packed assembly, the scored
    pool scoring in bf16 (here the model's fp32), in W8A8 int8 and with
    length buckets on the packed corpus. Every rank draws the one
    process's negatives (neg_rank, neg_rank_static) and the step equals
    one process's and JAX's on that batch. The int8 forward under tp2 is
    the one process's exactly (its row-parallel scales are the model
    group's maxima and its int32 partial products summed before the
    dequantisation), so its draws count no flipped code."""
    ranks, one, jax_ref = runs
    outs = [r[case] for r in ranks[4]]
    _same_on_every_rank(outs)
    if case.startswith("scored"):
        for key in ("neg_rank", "neg_rank_static"):
            assert outs[0][key] == one[case][key], key
    _held(outs[0], one[case], jax_ref[case])


def test_factored_moments_match_one_process(runs):
    """The factored chain under tp2 with the clip engaged: its row and
    column EMAs take their means over the model group where a rank holds a
    slice of the axis, and every moment equals one process's."""
    ranks, one, _ = runs
    outs = [r["factored"] for r in ranks[2]]
    _same_on_every_rank(outs, trees=("params", "opt"))
    got, want = outs[0], one["factored"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _close_params(got["params"], want["params"], "params")
    for key, val in want["opt"].items():
        np.testing.assert_allclose(got["opt"][key].float().numpy(),
                                   val.float().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


def test_dropout_matches_one_process(runs):
    """Dropout on the dense route under tp2: the masks of the whole
    activations are the same on both ranks (seeded by the row), and a
    rank's attention-weight mask is its heads' of the one process's."""
    ranks, one, _ = runs
    outs = [r["dropout"] for r in ranks[2]]
    _same_on_every_rank(outs)
    _held(outs[0], one["dropout"])
    assert outs[0]["loss"] != ranks[2][0]["tp2"]["loss"]


def test_online_step_over_a_sharded_index(runs):
    """OnlineMiningLoop on dp2 x tp2 with the index in two shards: the
    queries embedded split, the refresh with gathered whole weights; the
    losses and weights are one process's, and the steps JAX's on one
    process's batches."""
    ranks, one, jax_ref = runs
    outs = [r["online"] for r in ranks[4]]
    assert len(outs[0]["rows"]) == W.ONLINE_STEPS and not outs[1]["rows"]
    for o in outs[1:]:
        for name, val in o["params"].items():
            assert torch.equal(val, outs[0]["params"][name]), name
    np.testing.assert_allclose([r["loss"] for r in outs[0]["rows"]],
                               [r["loss"] for r in one["online"]["rows"]],
                               rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], one["online"]["params"], "params")
    losses, params, _ = jax_ref["online"]
    np.testing.assert_allclose([r["loss"] for r in outs[0]["rows"]], losses,
                               rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], params, "jax params")


def test_overlapped_refresh_on_a_tp_mesh(runs):
    """The overlapped refresh on dp2 x tp2: its thread encodes with the
    weights gathered on the loop's thread, so it runs no collective; its
    index equals the serial refresh's bit for bit on every rank, each rank
    holding its row's shard, and the loop's losses are one process's."""
    ranks, one, _ = runs
    outs = [r["overlap"] for r in ranks[4]]
    for o in outs:
        for a, b in zip(o["index_overlapped"] if isinstance(
                o["index_overlapped"], tuple) else (o["index_overlapped"],),
                o["index_serial"] if isinstance(o["index_serial"], tuple)
                else (o["index_serial"],)):
            assert torch.equal(a, b)
    # the two ranks of a row hold one shard; the rows hold the index
    assert torch.equal(outs[0]["index_serial"], outs[1]["index_serial"])
    torch.testing.assert_close(
        torch.cat([outs[0]["index_serial"], outs[2]["index_serial"]]),
        one["overlap"]["index_serial"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([r["loss"] for r in outs[0]["rows"]],
                               [r["loss"] for r in one["overlap"]["rows"]],
                               rtol=LOSS_RTOL)


def test_trainloop_checkpoint_read_by_one_process(runs):
    """TrainLoop on tp2 over 2 chunks with a checkpoint after each: the
    file holds whole leaves, which one process restores into its own
    state (equal to one process's run), and a resume from the first
    checkpoint on the sharded state ends on the uninterrupted run's
    weights bit for bit."""
    ranks, one, _ = runs
    outs = [r["loop"] for r in ranks[2]]
    assert [len(o["rows"]) for o in outs] == [2, 0]
    np.testing.assert_allclose([r["loss"] for r in outs[0]["rows"]],
                               [r["loss"] for r in one["loop"]["rows"]],
                               rtol=LOSS_RTOL)
    for out in outs:
        for name, val in out["params"].items():
            assert torch.equal(out["resumed"][name], val), name
    _close_params(outs[0]["params"], one["loop"]["params"], "params")
    _close_params(outs[0]["mu"], one["loop"]["mu"], "mu")
    # one process reads the tp run's file
    ctrl = W.EtaController(**W.CTRL)
    tx = W.tp_tx(W.TP_CLIP)
    template = init_train_state(
        t5.init_params(W.TP_CFG, torch.Generator().manual_seed(5)), tx,
        ctrl.init())
    restored = restore_checkpoint(outs[0]["ckpt"], template)
    assert restored.step == 2 and restored.param_dims is None
    for name, val in t5.flatten_params(restored.params).items():
        assert torch.equal(val, outs[0]["params"][name]), name
    for name, val in t5.flatten_params(restored.opt_state.mu).items():
        assert torch.equal(val, outs[0]["mu"][name]), name


def test_int8_scores_equal_one_process(runs):
    """The W8A8 forward under tp2 on 24 candidate prompts: the row-
    parallel o / wo scales are reduced (max) over the model group and the
    int32 partials summed before the one dequantisation, so every code and
    every score is one process's (no flipped code to count); skipping the
    scale's max all-reduce fails here."""
    ranks, one, _ = runs
    want = one["int8_scores"]
    for r in ranks[2]:
        got = r["int8_scores"]
        flips = int((got != want).sum())
        assert flips == 0, (flips, (got - want).abs().max().item())


def test_backward_route_is_one_process_route(runs):
    """At t5-base's 12 heads, d_kv 64 and L 768 one process's backward is
    K2a (flash_v2_eligible(12, ...) is false); a tp2 rank holds 6 heads,
    for which K2b would be eligible, and still runs K2a: the route is
    chosen on the model's head count. Its input gradient is one process's
    (the kernels' plain versions on the CPU)."""
    ranks, one, _ = runs
    assert one["route"]["routes"] == ["k2a"]
    assert t5.backward_route(W.ROUTE["H"], W.ROUTE["L"], W.ROUTE["L"],
                             W.ROUTE["dk"]) == "k2a"
    assert t5.backward_route(W.ROUTE["H"] // 2, W.ROUTE["L"], W.ROUTE["L"],
                             W.ROUTE["dk"]) == "k2b"
    for r in ranks[2]:
        assert r["route"]["routes"] == ["k2a"]
        torch.testing.assert_close(r["route"]["out"], one["route"]["out"],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["route"]["dx"], one["route"]["dx"],
                                   rtol=1e-4, atol=1e-4)


def test_export_and_roundtrip(runs):
    """``save_pretrained`` of a tp2 state writes one process's bytes (rank
    0 writes the gathered whole leaves), and ``gather_params`` of
    ``shard_params`` is the whole tree bit for bit."""
    ranks, one, _ = runs
    assert ranks[2][0]["export"] == one["export"]
    assert ranks[2][1]["export"] is None
    assert all(r["roundtrip"] for r in ranks[2])


# -- one process ---------------------------------------------------------


def _jax_dims(mesh, params):
    def dim(sharding):
        spec = tuple(sharding.spec)
        return next((i for i, a in enumerate(spec) if a == "model"), None)

    return {k: dim(v) for k, v in W.t5.flatten_params(
        j_param_shardings(mesh, params)).items()}


@pytest.mark.parametrize("model,heads,d_kv", [(2, 4, 16), (4, 6, 16)])
def test_param_shardings_match_jax(model, heads, d_kv):
    """Leaf by leaf against JAX's param_shardings on the same tree: equal,
    but where the heads do not divide the model axis (H 6 over 4), where
    JAX splits q/k/v/o mid-head (H * d_kv = 96 divides) and the port keeps
    the whole attention layer on every rank (rel_bias stays whole in
    both)."""
    cfg = jt5.T5Config(vocab_size=512, d_model=64, d_kv=d_kv, d_ff=256,
                       num_heads=heads, num_layers=2, num_decoder_layers=2)
    jparams = jt5.init_params(jax.random.key(0), cfg)
    want = _jax_dims(j_create_mesh(JMeshConfig(data=-1, model=model),
                                   jax.devices()[:8]), jparams)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = t5.flatten_params(param_shardings(Mesh(8 // model, 1, model, CPU),
                                            params))
    assert got.keys() == want.keys()
    for key, dim in got.items():
        leaf = key.rsplit(".", 1)[1]
        if heads % model and "attn" in key and leaf != "rel_bias":
            assert dim is None and want[key] is not None, key
        else:
            assert dim == want[key], key
    assert got["encoder.block_0.mlp.wi"] == 1
    assert got["shared.embedding"] == 0


def test_shard_slices_and_model_1_identities():
    """``shard_params`` gives each model rank its contiguous slice (the
    slices concatenate to the leaf); at model=1 every leaf is whole, the
    conjugate Functions are the identity (no collective, the same tensor)
    and ``model_split`` of a whole axis is None."""
    params = t5.init_params(W.CFG, torch.Generator().manual_seed(0))
    dims = param_shardings(Mesh(1, 1, 2, CPU), params)
    parts = [t5.flatten_params(shard_params(
        Mesh(1, 1, 2, CPU, model_rank=r), params, dims)) for r in (0, 1)]
    for key, leaf in t5.flatten_params(params).items():
        d = t5.flatten_params(dims)[key]
        if d is None:
            assert parts[0][key] is leaf and parts[1][key] is leaf
        else:
            assert torch.equal(torch.cat([parts[0][key], parts[1][key]], d),
                               leaf)
    one = Mesh(2, 1, 1, CPU)
    assert all(d is None for d in t5.flatten_params(
        param_shardings(one, params)).values())
    x = torch.randn(3, 4)
    assert copy_to_model(x, one) is x and reduce_from_model(x, one) is x
    with one:
        assert model_split(4, 4) is None
        with pytest.raises(ValueError, match="does not split"):
            model_split(2, 4)

"""One rank of tests/test_torch_multiproc.py and
tests/test_torch_tensor_parallel.py: a gloo process on the CPU.

    python tests/torch_parallel_worker.py <dir> <rank> [dp|tp]

Reads ``<dir>/inputs.pt`` (written by the test: the initial weights and the
index's docs and queries), joins a gloo group of 4 ranks through the
``file://`` rendezvous ``<dir>/rendezvous4`` and runs the 4-rank cases;
then ranks 0 and 1 join a group of 2 (``<dir>/rendezvous2``) and run the
2-rank cases: the data-parallel cases (``dp``, the default) or the
tensor-parallel ones (``tp``: meshes with model=2). Each rank writes
``<dir>/rank<rank>.pt``. It imports torch and the port only; the test
holds its results against one process and against JAX. The functions that
run a case take ``mesh=None`` too: the test runs them so for the
one-process reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys

import numpy as np
import torch

from pacednegatives_tpu_torch.curriculum import EtaController, InterpController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.index import DenseIndex
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.hf_export import save_pretrained
from pacednegatives_tpu_torch.models.quant import (
    quantize_scoring_params,
    score_batch_int8,
)
from pacednegatives_tpu_torch.optim import Adam, FactoredAdam
from pacednegatives_tpu_torch.parallel import MeshConfig, create_mesh
from pacednegatives_tpu_torch.parallel.mesh import (
    gather_params,
    param_shardings,
    shard_params,
)
from pacednegatives_tpu_torch.parallel.collectives import merge_topk
from pacednegatives_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from pacednegatives_tpu_torch.train import (
    MetricWriter,
    TrainLoop,
    init_train_state,
    make_fused_step,
    make_optimizer,
    make_scored_pool_step,
    make_train_step,
    restore_checkpoint,
)
from pacednegatives_tpu_torch.train.online import (
    OnlineMiningConfig,
    OnlineMiningLoop,
    make_online_fused_step,
    make_refresh_fn,
)
from pacednegatives_tpu_torch.train.overlap import OverlappedRefresher
from pacednegatives_tpu_torch.train.state import (
    encoder_weights,
    gather_train_state,
    shard_train_state,
)

# test_sharding_equivalence.py's model, corpus and step: dims divisible by
# every mesh here, 16 pairs x (1 + 2) rows a step
CFG = t5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=256, num_heads=4,
                  num_layers=2, num_decoder_layers=2)
CTRL = dict(eta0=8.0, meta_lr=0.01, warmup_steps=1, total_steps=4,
            eta_max=10.0)
LR, TOTAL, B, N_NEG, STEPS = 1e-3, 4, 16, 2, 1
# no global-norm clipping: a gradient off by a factor (the world size, say)
# would be clipped back to the same first moment, and AdamW's update is
# scale-invariant, so only an unclipped first moment shows it
GRAD_CLIP = None
# the scored pool: 8 candidates of pools of 12, chunks of 32 rows
SCORED_C, SCORED_CHUNK = 8, 32
ONLINE_STEPS = 4
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
# each rank's (2, 2) top-k candidates at global rows 2 * rank + (0, 1)
MERGE_VALUES = {0: [[1.0, -0.0], [0.5, 0.0]], 1: [[1.0, 0.0], [0.5, -0.0]]}


def corpus(n_docs: int = 48, n_pairs: int = 32, n_neg: int = 8,
           packed: bool = False):
    """(tokenizer, DeviceCorpus on the CPU) of test_sharding_equivalence."""
    text = TextCorpus.synthetic(num_docs=n_docs, num_queries=8, seed=0)
    tok = HashTokenizer(vocab_size=512)
    store = TokenizedStore.build(text, tok, max_q_tokens=6, max_d_tokens=16)
    triples = TripletStore.synthetic(text, n_pairs=n_pairs, n_neg=n_neg,
                                     seed=1)
    return tok, DeviceCorpus.build(store, triples, device="cpu",
                                   packed=packed)


def _tx(total: int = TOTAL):
    return make_optimizer(LR, total_steps=total, grad_clip=GRAD_CLIP)


def _copy(params: dict) -> dict:
    return t5.tree_map(lambda p: p.clone(), params)


def _record(step_fn, batches: list | None):
    if batches is None:
        return step_fn

    def recorded(state, batch):
        batches.append({k: v.clone() for k, v in batch.items()})
        return step_fn(state, batch)

    return recorded


def _trajectory(state, metrics: list) -> dict:
    return {"loss": [float(m["loss"]) for m in metrics],
            "eta": [float(m["eta"]) for m in metrics],
            "difficulty": [float(m["difficulty"]) for m in metrics],
            "neg_rank": [float(m["neg_rank"]) for m in metrics],
            # after one step, whose update runs at lr(0) = 0, the weights
            # are still the initial ones (the broadcast and the state are
            # what they check) and AdamW's first moment is 0.1 x the
            # global batch's gradient, unclipped: the gradient's check
            "params": t5.flatten_params(state.params),
            "mu": t5.flatten_params(state.opt_state.mu)}


def _mesh_ctx(mesh):
    return contextlib.nullcontext() if mesh is None else mesh


def fused_steps(params: dict, mesh=None, negative_parallel: bool = False,
                batches: list | None = None) -> dict:
    """``STEPS`` fused LCE steps over pairs 0..B-1 (test_sharding_
    equivalence.py runs one); ``batches`` collects
    the batches the step was given (one process's: the global ones)."""
    tok, dc = corpus()
    ctrl = EtaController(**CTRL)
    tx = _tx()
    step = make_train_step(CFG, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    fused = make_fused_step(dc, _record(step, batches), ctrl, loss="lce",
                            n_neg_per_example=N_NEG,
                            negative_parallel=negative_parallel)
    state = init_train_state(_copy(params), tx, ctrl.init(), seed=3)
    metrics = []
    with _mesh_ctx(mesh):
        for _ in range(STEPS):
            state, m = fused(state, torch.arange(B))
            metrics.append(m)
    return _trajectory(state, metrics)


def scored_steps(params: dict, mesh=None, batches: list | None = None) -> dict:
    """``STEPS`` scored-pool steps (negative parallel under a mesh)."""
    tok, dc = corpus(n_neg=12)
    ctrl = EtaController(**CTRL)
    tx = _tx()
    step = make_train_step(CFG, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    fused = make_scored_pool_step(
        dc, _record(step, batches), ctrl, CFG, n_neg_per_example=N_NEG,
        candidates=SCORED_C, rel_id=tok.true_id, nrel_id=tok.false_id,
        negative_parallel=mesh is not None, score_chunk_rows=SCORED_CHUNK)
    state = init_train_state(_copy(params), tx, ctrl.init(), seed=3)
    metrics = []
    with _mesh_ctx(mesh):
        for _ in range(STEPS):
            state, m = fused(state, torch.arange(B))
            metrics.append(m)
    out = _trajectory(state, metrics)
    out["neg_rank_static"] = [float(m["neg_rank_static"]) for m in metrics]
    return out


def train_loop(params: dict, ckpt_dir: str, mesh=None) -> dict:
    """TrainLoop over 2 chunks of 1 step, a checkpoint after each; then a
    resume from the first checkpoint to the end."""
    tok, dc = corpus()

    def fresh(seed):
        ctrl = EtaController(**CTRL)
        tx = _tx()
        step = make_train_step(CFG, ctrl, tx, loss="lce",
                               n_neg_per_example=N_NEG, rel_id=tok.true_id,
                               nrel_id=tok.false_id)
        loop = TrainLoop(make_fused_step(dc, step, ctrl, loss="lce",
                                         n_neg_per_example=N_NEG),
                         num_pairs=dc.num_pairs, batch_size=8, chunk_size=1,
                         log_mode="all", checkpoint_dir=ckpt_dir,
                         checkpoint_every_steps=1, corpus=dc)
        return init_train_state(_copy(params), tx, ctrl.init(),
                                seed=seed), loop

    writer = MetricWriter(None)
    with _mesh_ctx(mesh):
        state, loop = fresh(3)
        final = loop.run(state, 2, writer)
        template, loop = fresh(9)
        resumed = loop.run(restore_checkpoint(
            os.path.join(ckpt_dir, "step_1"), template), 2)
    return {"rows": [r for r in writer.history if "loss" in r],
            "params": t5.flatten_params(final.params),
            "mu": t5.flatten_params(final.opt_state.mu),
            "resumed": t5.flatten_params(resumed.params),
            "eta": float(final.curriculum.eta)}


def online_loop(params: dict, mesh=None) -> dict:
    """OnlineMiningLoop over an index of 64 docs (a shard of 32 a rank on
    two ranks), ``ONLINE_STEPS`` steps in chunks of 2 with a refresh after
    the first chunk (test_multichip_loop.py:76 runs 12 in chunks of 3,
    refreshing every 6)."""
    tok, dc = corpus(n_docs=64, n_pairs=64)
    ctrl = InterpController(start=0.2, end=0.8, num_steps=24, batch_size=8)
    tx = make_optimizer(LR, total_steps=ONLINE_STEPS)
    step = make_train_step(CFG, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    mining = OnlineMiningConfig(pool_size=8, encode_batch=16)
    refresh = make_refresh_fn(dc, CFG, mining)
    loop = OnlineMiningLoop(
        fused_step=make_online_fused_step(dc, step, ctrl, CFG, mining, N_NEG),
        refresh_fn=refresh, num_pairs=dc.num_pairs, batch_size=8,
        chunk_size=2, refresh_every=2, log_mode="all", corpus=dc)
    writer = MetricWriter(None)
    with _mesh_ctx(mesh):
        shard = refresh(params)
        state = loop.run(init_train_state(_copy(params), tx, ctrl.init(),
                                          seed=3), ONLINE_STEPS, writer)
    return {"rows": [r for r in writer.history if "loss" in r],
            "refresh_rows": [r for r in writer.history
                             if "refresh_seconds" in r],
            "shard": shard, "params": t5.flatten_params(state.params),
            "difficulty": float(ctrl.difficulty(state.curriculum))}


def index_topk(docs: torch.Tensor, queries: torch.Tensor, mesh=None) -> dict:
    out = {}
    for quantize in (False, True):
        index = DenseIndex.build(docs, method="exact", mesh=mesh,
                                 quantize=quantize, device="cpu")
        out["int8" if quantize else "fp32"] = index.topk(queries, 10)
    return out


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) ---------------

# two steps at a constant learning rate: lr(0) > 0, so every step moves the
# weights (a warmup schedule's first update is 0). Adam's eps is 1e-3, not
# the trainer's 1e-6: an update moves by at most lr |dg| / eps when its
# gradient moves by dg, so the sums' rounding, which differs between a
# split and a whole reduction, cannot move a weight past the one-step
# tolerances (at eps 1e-6 an entry with |g| below eps moves by up to
# 1e3 x its gradient's rounding)
TP_STEPS, TP_LR, TP_EPS = 2, 1e-3, 1e-3
# the model of the two-step cases: CFG with T5 v1.1's gated-GELU FFN, whose
# derivative is continuous. With v1.0's ReLU a column-parallel wi sums its
# products in another order than one process's, and a pre-activation that
# rounds to the other side of 0 switches its unit's gradient on or off: at
# the second step one such unit moved the layer norms' gradients by 5e-4
# relative. The ReLU model's case (``relu``) is held after one step.
TP_CFG = dataclasses.replace(CFG, gated_ffn=True)
# a global-norm clip the gradients exceed (their norm is ~1 at the first
# step): the norm then scales every update
TP_CLIP = 0.05
# the buckets of the bucketed scored pool (prompts are 24 wide)
TP_BUCKETS = (12, 18)
# the K2a / K2b route case: t5-base's heads and d_kv at L 768, where one
# process takes K2a and a rank holding 6 heads would take K2b
ROUTE = dict(H=12, dk=64, L=768, d_model=64)


def tp_tx(clip=None, moments: str = "fp32"):
    """AdamW (optax.adamw's arithmetic) or the factored chain at a
    constant learning rate, behind a global-norm clip when given."""
    lr = lambda count: np.float32(TP_LR)
    if moments == "factored":
        return FactoredAdam(lr, eps=TP_EPS, clip_norm=clip)
    return Adam(lr, eps=TP_EPS, weight_decay=0.0, clip_norm=clip)


def _whole(state, mesh):
    return state if mesh is None else gather_train_state(mesh, state)


def _sharded(state, mesh):
    return state if mesh is None else shard_train_state(mesh, state)


def _opt_flat(opt_state) -> dict:
    out = {}
    for field, tree in opt_state._asdict().items():
        if isinstance(tree, dict):
            out.update({f"{field}.{k}": v for k, v in
                        t5.flatten_params(tree).items() if v is not None})
    return out


def tp_steps(params: dict, mesh=None, *, kind: str = "fused", clip=None,
             moments: str = "fp32", dropout: bool = False,
             packed: bool = False, score_dtype: str = "compute",
             buckets: tuple = (), batches: list | None = None,
             cfg: t5.T5Config = TP_CFG, steps: int = TP_STEPS) -> dict:
    """``steps`` LCE steps on pairs 0..B-1 (``kind`` "fused" or "scored")
    with the state sharded over ``mesh``'s model group; the trajectory,
    the whole params and every optimizer moment."""
    tok, dc = corpus(n_neg=12 if kind == "scored" else 8, packed=packed)
    ctrl = EtaController(**CTRL)
    tx = tp_tx(clip, moments)
    step = _record(make_train_step(
        cfg, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
        rel_id=tok.true_id, nrel_id=tok.false_id, dropout=dropout), batches)
    if kind == "fused":
        fused = make_fused_step(dc, step, ctrl, loss="lce",
                                n_neg_per_example=N_NEG)
    else:
        fused = make_scored_pool_step(
            dc, step, ctrl, cfg, n_neg_per_example=N_NEG,
            candidates=SCORED_C, rel_id=tok.true_id, nrel_id=tok.false_id,
            score_dtype=score_dtype, score_chunk_rows=SCORED_CHUNK,
            score_buckets=buckets)
    metrics = []
    with _mesh_ctx(mesh):
        state = _sharded(init_train_state(_copy(params), tx, ctrl.init(),
                                          seed=3), mesh)
        for _ in range(steps):
            state, m = fused(state, torch.arange(B))
            metrics.append(m)
        state = _whole(state, mesh)
    out = _trajectory(state, metrics)
    out["opt"] = _opt_flat(state.opt_state)
    if kind == "scored":
        out["neg_rank_static"] = [float(m["neg_rank_static"])
                                  for m in metrics]
    return out


def tp_loop(params: dict, ckpt_dir: str, mesh=None) -> dict:
    """TrainLoop over 2 chunks of 1 step with a checkpoint after each, on
    a sharded state; then a resume from the first checkpoint."""
    tok, dc = corpus()

    def fresh(seed):
        ctrl = EtaController(**CTRL)
        tx = tp_tx(TP_CLIP)
        step = make_train_step(TP_CFG, ctrl, tx, loss="lce",
                               n_neg_per_example=N_NEG, rel_id=tok.true_id,
                               nrel_id=tok.false_id)
        loop = TrainLoop(make_fused_step(dc, step, ctrl, loss="lce",
                                         n_neg_per_example=N_NEG),
                         num_pairs=dc.num_pairs, batch_size=8, chunk_size=1,
                         log_mode="all", checkpoint_dir=ckpt_dir,
                         checkpoint_every_steps=1, corpus=dc)
        return _sharded(init_train_state(_copy(params), tx, ctrl.init(),
                                         seed=seed), mesh), loop

    writer = MetricWriter(None)
    with _mesh_ctx(mesh):
        state, loop = fresh(3)
        final = _whole(loop.run(state, 2, writer), mesh)
        template, loop = fresh(9)
        resumed = _whole(loop.run(restore_checkpoint(
            os.path.join(ckpt_dir, "step_1"), template), 2), mesh)
    return {"rows": [r for r in writer.history if "loss" in r],
            "params": t5.flatten_params(final.params),
            "mu": t5.flatten_params(final.opt_state.mu),
            "resumed": t5.flatten_params(resumed.params),
            "ckpt": os.path.join(ckpt_dir, "step_2")}


def tp_online(params: dict, mesh=None, overlap: bool = False,
              batches: list | None = None) -> dict:
    """OnlineMiningLoop (``online_loop``'s) on a sharded state, serial or
    with an overlapped refresh (on the CPU, its thread computing; the swap
    lands at the next chunk boundary); with ``overlap``, also the index of
    the refresher beside the serial refresh's, on the same weights."""
    tok, dc = corpus(n_docs=64, n_pairs=64)
    ctrl = InterpController(start=0.2, end=0.8, num_steps=24, batch_size=8)
    tx = tp_tx()
    step = _record(make_train_step(
        TP_CFG, ctrl, tx, loss="lce", n_neg_per_example=N_NEG,
        rel_id=tok.true_id, nrel_id=tok.false_id), batches)
    mining = OnlineMiningConfig(pool_size=8, encode_batch=16)
    refresh = make_refresh_fn(dc, TP_CFG, mining)
    writer = MetricWriter(None)
    out = {}
    with _mesh_ctx(mesh):
        refresher = (OverlappedRefresher(dc, TP_CFG, mining) if overlap
                     else None)
        loop = OnlineMiningLoop(
            fused_step=make_online_fused_step(dc, step, ctrl, TP_CFG, mining,
                                              N_NEG),
            refresh_fn=refresh, num_pairs=dc.num_pairs, batch_size=8,
            chunk_size=2, refresh_every=2, log_mode="all", corpus=dc,
            overlap=refresher)
        state = _sharded(init_train_state(_copy(params), tx, ctrl.init(),
                                          seed=3), mesh)
        state = loop.run(state, ONLINE_STEPS, writer)
        if overlap:
            weights = encoder_weights(state, mesh)
            refresher.start(weights)
            out["index_overlapped"] = refresher.collect()
            out["index_serial"] = refresh(weights)
            refresher.close()
        state = _whole(state, mesh)
    out.update(rows=[r for r in writer.history if "loss" in r],
               params=t5.flatten_params(state.params))
    return out


def tp_int8_scores(params: dict, mesh=None) -> torch.Tensor:
    """The W8A8 forward's scores of 24 candidate prompts."""
    tok, dc = corpus(n_neg=12)
    idx = torch.arange(24)
    ids, mask = dc.assemble(dc.query_rows[idx % dc.num_pairs],
                            dc.pools[idx % dc.num_pairs, idx % 12])
    with _mesh_ctx(mesh):
        p = params if mesh is None else shard_params(mesh, params)
        qp = quantize_scoring_params(p, TP_CFG)
        return score_batch_int8(qp, TP_CFG, ids, mask, rel_id=tok.true_id,
                                nrel_id=tok.false_id)


def tp_route(mesh=None) -> dict:
    """One attention layer forward and backward at ``ROUTE``'s shape on
    the chunked kernel route (the kernels' plain versions on the CPU):
    which backward kernel ran, and the input's gradient."""
    H, dk, L, d = ROUTE["H"], ROUTE["dk"], ROUTE["L"], ROUTE["d_model"]
    cfg = t5.T5Config(vocab_size=512, d_model=d, d_kv=dk, d_ff=128,
                      num_heads=H, num_layers=1, num_decoder_layers=1,
                      attention_impl="chunked", attention_chunk=256,
                      flash_kernel=True)
    g = torch.Generator().manual_seed(11)
    p = {"q": torch.randn(d, H * dk, generator=g) * 0.05,
         "k": torch.randn(d, H * dk, generator=g) * 0.05,
         "v": torch.randn(d, H * dk, generator=g) * 0.05,
         "o": torch.randn(H * dk, d, generator=g) * 0.05}
    rel = torch.randn(32, H, generator=g)
    x = torch.randn(1, L, d, generator=g)
    routes = []
    saved = {name: getattr(t5, name) for name in (
        "pallas_flash_eligible", "flash_attention_backward",
        "flash_attention_backward_v2")}

    def record(name, fn):
        def call(*a):
            routes.append(name)
            return fn(*a)
        return call

    t5.pallas_flash_eligible = lambda *a: True
    t5.flash_attention_backward = record(
        "k2a", saved["flash_attention_backward"])
    t5.flash_attention_backward_v2 = record(
        "k2b", saved["flash_attention_backward_v2"])
    try:
        with _mesh_ctx(mesh):
            dims = {"q": 1, "k": 1, "v": 1, "o": 0, "rel": 1}
            local = ({**p, "rel": rel} if mesh is None else
                     shard_params(mesh, {**p, "rel": rel}, dims))
            xr = x.clone().requires_grad_(True)
            bias = t5.compute_position_bias(local["rel"], L, L, True, 32, 128)
            out = t5.attention({k: local[k] for k in "qkvo"}, cfg, xr, xr,
                               (bias, None))
            out.square().sum().backward()
    finally:
        for name, fn in saved.items():
            setattr(t5, name, fn)
    return {"routes": routes, "dx": xr.grad, "out": out.detach()}


def tp_export(params: dict, path: str, mesh=None) -> bytes | None:
    """A state sharded over ``mesh`` exported as a tp caller does it: the
    whole leaves gathered over the model group, then ``save_pretrained``
    on rank 0; rank 0's (or one process's) model.safetensors bytes."""
    if mesh is not None:
        dims = param_shardings(mesh, params)
        params = gather_params(mesh, shard_params(mesh, params, dims), dims)
        if mesh.rank != 0:
            return None
    save_pretrained(params, TP_CFG, path)
    with open(os.path.join(path, "model.safetensors"), "rb") as f:
        return f.read()


def _tp_cases(world: int, inputs: dict, work: str) -> dict:
    params = inputs["params"]
    out = {}
    if world == 4:
        mesh = create_mesh(MeshConfig(data=2, model=2), "cpu")
        out["dp2_tp2"] = tp_steps(params, mesh)
        out["packed"] = tp_steps(params, mesh, packed=True)
        out["scored"] = tp_steps(params, mesh, kind="scored")
        out["scored_int8"] = tp_steps(params, mesh, kind="scored",
                                      score_dtype="int8")
        out["scored_buckets"] = tp_steps(params, mesh, kind="scored",
                                         packed=True, buckets=TP_BUCKETS)
        out["online"] = tp_online(params, mesh)
        out["overlap"] = tp_online(params, mesh, overlap=True)
        np_mesh = create_mesh(MeshConfig(data=1, seq=2, model=2), "cpu")
        out["seq2_tp2"] = tp_steps(params, np_mesh)
    else:
        mesh = create_mesh(MeshConfig(data=1, model=2), "cpu")
        dims = param_shardings(mesh, params)
        with mesh:
            back = gather_params(mesh, shard_params(mesh, params, dims), dims)
        out["roundtrip"] = all(torch.equal(a, b) for a, b in zip(
            t5.flatten_params(back).values(),
            t5.flatten_params(params).values()))
        out["tp2"] = tp_steps(params, mesh)
        out["relu"] = tp_steps(inputs["params_relu"], mesh, cfg=CFG, steps=1)
        out["tp2_clip"] = tp_steps(params, mesh, clip=TP_CLIP)
        out["factored"] = tp_steps(params, mesh, clip=TP_CLIP,
                                   moments="factored")
        out["dropout"] = tp_steps(params, mesh, dropout=True)
        out["loop"] = tp_loop(params, os.path.join(work, "ckpt_tp"), mesh)
        out["int8_scores"] = tp_int8_scores(params, mesh)
        out["route"] = tp_route(mesh)
        out["export"] = tp_export(params, os.path.join(work, "hf_tp"), mesh)
    return out


def _cases(world: int, inputs: dict, work: str) -> dict:
    params = inputs["params"]
    out = {}
    if world == 2:
        mesh = create_mesh(MeshConfig(data=2), "cpu")
        out["dp2"] = fused_steps(params, mesh)
        out["loop"] = train_loop(params, os.path.join(work, "ckpt"), mesh)
        out["online"] = online_loop(params, mesh)
        out["index"] = index_topk(inputs["docs"], inputs["queries"], mesh)
        # ties across the shards and signed zeros (MERGE_VALUES)
        with mesh:
            out["merge_ties"] = merge_topk(
                torch.tensor(MERGE_VALUES[mesh.row_rank]),
                torch.tensor([[0, 1], [0, 1]]) + 2 * mesh.row_rank, 4)
            # 3 pairs do not split over 2 ranks
            ctrl = EtaController(**CTRL)
            state = init_train_state(_copy(params),
                                     _tx(),
                                     ctrl.init())
            try:
                make_fused_step(corpus()[1], None, ctrl, loss="lce",
                                n_neg_per_example=N_NEG)(state,
                                                         torch.arange(3))
                out["rows_error"] = None
            except ValueError as e:
                out["rows_error"] = str(e)
    else:
        out["dp4"] = fused_steps(params, create_mesh(MeshConfig(data=4),
                                                     "cpu"))
        np_mesh = create_mesh(MeshConfig(data=2, seq=2), "cpu")
        out["np"] = fused_steps(params, np_mesh, negative_parallel=True)
        out["scored"] = scored_steps(params, np_mesh)
    return out


def main() -> None:
    work, rank = sys.argv[1], int(sys.argv[2])
    cases = _tp_cases if sys.argv[3:4] == ["tp"] else _cases
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    out = {}
    for world in (4, 2):
        if rank >= world:
            break
        assert maybe_initialize_distributed(
            f"file://{os.path.join(work, f'rendezvous{world}')}", world, rank,
            device="cpu", timeout=COLLECTIVE_TIMEOUT)
        try:
            out.update(cases(world, inputs, work))
        finally:
            torch.distributed.destroy_process_group()
    tmp = os.path.join(work, f".rank{rank}.tmp")
    torch.save(out, tmp)
    os.replace(tmp, os.path.join(work, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()

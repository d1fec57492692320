"""One rank of tests/test_torch_multiproc.py: a gloo process on the CPU.

    python tests/torch_parallel_worker.py <dir> <rank>

Reads ``<dir>/inputs.pt`` (written by the test: the initial weights and the
index's docs and queries), joins a gloo group of 4 ranks through the
``file://`` rendezvous ``<dir>/rendezvous4`` and runs the 4-rank cases;
then ranks 0 and 1 join a group of 2 (``<dir>/rendezvous2``) and run the
2-rank cases. Each rank writes ``<dir>/rank<rank>.pt``. It imports torch
and the port only; the test holds its results against one process and
against JAX. The functions that run a case take ``mesh=None`` too: the
test runs them so for the one-process reference.
"""

from __future__ import annotations

import datetime
import os
import sys

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
from pacednegatives_tpu_torch.parallel import MeshConfig, create_mesh
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


def corpus(n_docs: int = 48, n_pairs: int = 32, n_neg: int = 8):
    """(tokenizer, DeviceCorpus on the CPU) of test_sharding_equivalence."""
    text = TextCorpus.synthetic(num_docs=n_docs, num_queries=8, seed=0)
    tok = HashTokenizer(vocab_size=512)
    store = TokenizedStore.build(text, tok, max_q_tokens=6, max_d_tokens=16)
    triples = TripletStore.synthetic(text, n_pairs=n_pairs, n_neg=n_neg,
                                     seed=1)
    return tok, DeviceCorpus.build(store, triples, device="cpu")


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
    import contextlib

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
            out.update(_cases(world, inputs, work))
        finally:
            torch.distributed.destroy_process_group()
    tmp = os.path.join(work, f".rank{rank}.tmp")
    torch.save(out, tmp)
    os.replace(tmp, os.path.join(work, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()

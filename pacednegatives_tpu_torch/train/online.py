"""Online negative mining: the port of train/online.py.

The dense index feeds the paced sampler at train time (the JAX package's
north star, runner.py:114-115). Each step:

  1. embeds the batch's queries with the CURRENT fp32 master weights
     (models/dual_encoder.py, no gradient),
  2. mines a fresh pool per query from the device index (MIPS top-k,
     reversed to easiest first), dropping the positive,
  3. samples n negatives from the paced binomial over pool ranks with
     ``state.generator`` (the static-pool sampler's semantics),
  4. assembles the prompts from the device corpus and runs the train step.

Every ``refresh_every`` steps the index is re-encoded with the current
weights. Serially, as the JAX package's one-device loop does
(online.py:19-27), the next step waits for the new index; with
``overlap=`` (train/overlap.py) the refresh runs beside training, on a
second card or on a stream of its own on this one, and the new index lands
``overlap_delay_chunks`` chunk boundaries later.

Under a mesh (parallel/mesh.py) the index is sharded over the ranks: each
rank encodes only its shard's docs (``make_refresh_fn``), embeds its block
of the batch's queries, and the query embeddings are gathered so that
every rank mines the global batch from its shard and merges the shards'
candidates (``parallel.collectives.merge_topk``); each rank then keeps its
rows of the batch, with the global draws. Metrics and checkpoints are
written by rank 0. Under tensor parallelism the query embedding runs
split over the model group, and each refresh encodes with whole weights,
gathered once on the loop's thread (``train.state.encoder_weights``), so
that the encode runs no collective, serial or overlapped.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.dual_encoder import embed, encode_corpus
from pacednegatives_tpu_torch.ops.mips import (
    mips_topk_exact,
    mips_topk_pallas_quantized,
    mips_topk_quantized_streaming,
    quantize_embeddings,
)
from pacednegatives_tpu_torch.parallel.collectives import (
    gather_batch,
    merge_topk,
)
from pacednegatives_tpu_torch.parallel.mesh import (
    current_mesh,
    local_rows,
    shard_range,
)
from pacednegatives_tpu_torch.train.loop import (
    MetricWriter,
    checkpoint,
    done_per_sec,
    pair_index_stream,
    write_chunk_metrics,
    writer_of,
)
from pacednegatives_tpu_torch.train.state import TrainState, encoder_weights


@dataclasses.dataclass(frozen=True)
class OnlineMiningConfig:
    pool_size: int = 64  # mined pool per query (reference pools are 1000)
    encode_batch: int = 128
    method: str = "exact"  # "approx" (lax.approx_max_k) is not carried over
    exclude_positive: bool = True
    quantize: bool = False  # int8 index (4x less device memory)
    # the refresh encodes at most this many docs per slice, bounding the
    # fp32 embedding transient to one slice (online.py:60-65)
    refresh_rows_per_call: int = 262144
    # K6 tiling, the JAX package's defaults (online.py:66-76): blocks of
    # 4096 rows (halved while the row count is not a multiple, down to
    # 1024) and k' = 32 candidates a block: near-exact, the consumer is a
    # difficulty-percentile sampler
    k_per_block: int = 32
    mips_block_n: int = 4096


def _check_method(mining: OnlineMiningConfig) -> None:
    if mining.method == "approx":
        raise NotImplementedError(
            "OnlineMiningConfig(method='approx') (lax.approx_max_k) is not "
            "carried over to the PyTorch package; use 'exact'")
    if mining.method != "exact":
        raise ValueError(f"unknown mining method {mining.method!r}")


def mips_block_n(mining: OnlineMiningConfig, rows: int) -> int | None:
    """K6's block size for ``rows`` docs (online.py:121-124), or None when
    no block size of at least 1024 divides the row count."""
    bn = mining.mips_block_n
    while bn > 1024 and rows % bn:
        bn //= 2
    return bn if rows % bn == 0 else None


def _top(q: torch.Tensor, embeddings, k: int, mining: OnlineMiningConfig):
    """(values, doc rows) of the top k of one index (or shard)."""
    if mining.quantize:
        vals, scales = embeddings
        bn = mips_block_n(mining, vals.shape[0])
        if bn is not None and vals.device.type == "cuda":
            return mips_topk_pallas_quantized(
                q, vals, scales, k, block_n=bn,
                k_per_block=min(mining.k_per_block, k))
        return mips_topk_quantized_streaming(q, vals, scales, k)
    return mips_topk_exact(q, embeddings, k)


def mine_top(q_emb: torch.Tensor, embeddings, k: int,
             mining: OnlineMiningConfig, mesh=None) -> torch.Tensor:
    """(B, D) query embeddings -> (B, k) doc rows, hardest first, with the
    dispatch of online.py:119-145: the int8 index goes through K6 on the
    card when its row count is block-aligned, else (and on the CPU, as JAX
    does off the TPU) through the exact streaming path. With a ``mesh``,
    ``embeddings`` is this rank's shard: its top min(k, shard rows), then
    the merge of every shard's (the same rows on every rank)."""
    q = q_emb.float()
    if mesh is None:
        return _top(q, embeddings, k, mining)[1]
    shard = (embeddings[0] if mining.quantize else embeddings).shape[0]
    v, i = _top(q, embeddings, min(k, shard), mining)
    return merge_topk(v, i + mesh.row_rank * shard, k, mesh)[1]


def make_online_fused_step(corpus: DeviceCorpus, step_fn: Callable,
                           controller, model_cfg: t5.T5Config,
                           mining: OnlineMiningConfig,
                           n_neg_per_example: int = 1):
    """fused((state, embeddings), pair_idx[, corpus]) -> ((state',
    embeddings), metrics). ``embeddings`` is the (N, D) fp32 index or the
    (int8 values, scales) pair; the loop swaps it at a refresh."""
    _check_method(mining)
    n = n_neg_per_example
    P = mining.pool_size
    default_corpus = corpus

    def fused(carry, pair_idx: torch.Tensor, corpus=None):
        corpus = default_corpus if corpus is None else corpus
        mesh = current_mesh()
        state, embeddings = carry
        difficulty = controller.difficulty(state.curriculum)
        B = pair_idx.shape[0]
        q_rows = corpus.query_rows[pair_idx]
        pos_rows = corpus.pos_rows[pair_idx]

        # 1-2. query embeddings under the current weights (each rank its
        # block, gathered), mined pools
        mine_q = local_rows(q_rows, mesh)
        q_tok = corpus.q_tokens[mine_q].long()
        q_mask = (corpus.q_mask[mine_q] if corpus.q_mask is not None
                  else (q_tok != corpus.pad_id).to(torch.int32))
        q_emb = embed(state.params, model_cfg, q_tok, q_mask)
        if mesh is not None:
            q_emb = gather_batch(q_emb, mesh)
        k = P + (1 if mining.exclude_positive else 0)
        idx = mine_top(q_emb, embeddings, k, mining, mesh)
        if mining.exclude_positive:
            # drop the positive if retrieved, else the extra last slot: a
            # stable sort that gives the positive the worst key
            rank = torch.arange(k, device=idx.device).expand(B, k)
            key = torch.where(idx == pos_rows[:, None], k + 1, rank)
            order = torch.argsort(key, dim=1, stable=True)
            idx = torch.gather(idx, 1, order)[:, :P]
        pools = idx.flip(1)  # easiest first (compute_all_bm25.py:44)

        # 3-4. paced binomial sampling over the mined pools' ranks, the
        # static path's prompt assembly, the step
        rows = (None if mesh is None else
                local_rows(torch.arange(B), mesh))
        batch = corpus.lce_batch(state.generator, pair_idx, difficulty, n,
                                 pools=pools, rows=rows)
        state, metrics = step_fn(state, batch)
        return (state, embeddings), metrics

    return fused


def make_refresh_fn(corpus: DeviceCorpus, model_cfg: t5.T5Config,
                    mining: OnlineMiningConfig):
    """params -> fresh corpus index: (N, D) fp32 embeddings, or the
    (int8 values, fp32 scales) pair with ``mining.quantize``.

    The docs are encoded in slices of ``refresh_rows_per_call`` rows, each
    quantised on its own (per-row quantisation makes slicing exact), and
    each slice is copied in place into one buffer allocated at the first
    slice: no concatenation, so no second full index ever exists, and the
    fp32 transient is one slice. Under a mesh each rank encodes, and
    returns, its contiguous shard of the docs. ``params`` are whole
    weights (the shared embedding and the encoder suffice): under tensor
    parallelism, ``train.state.encoder_weights`` of the state."""

    def refresh(params):
        lo, hi = shard_range(corpus.d_tokens.shape[0], current_mesh())
        rows = hi - lo
        per = max(min(rows, mining.refresh_rows_per_call), 1)
        bufs = None
        for i in range(0, rows, per):
            size = min(i + per, rows) - i
            s0, s1 = lo + i, lo + i + size
            emb = encode_corpus(
                params, model_cfg, corpus.d_tokens[s0:s1],
                None if corpus.d_mask is None else corpus.d_mask[s0:s1],
                batch_size=mining.encode_batch, pad_id=corpus.pad_id)
            leaves = quantize_embeddings(emb) if mining.quantize else (emb,)
            del emb
            if bufs is None:
                bufs = tuple(x.new_empty((rows,) + x.shape[1:])
                             for x in leaves)
            for buf, x in zip(bufs, leaves):
                buf[i:i + size].copy_(x)
        return bufs if mining.quantize else bufs[0]

    return refresh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class OnlineMiningLoop:
    """Training with periodic index refresh, a Python loop over steps.
    ``chunk_size`` keeps its logging meaning (metrics read once a chunk);
    the refresh cadence and the data stream follow the ABSOLUTE step, so
    they survive a restart. Each serial refresh logs ``refresh_seconds``
    (device time included: the next step waits for it anyway). Under a
    mesh, run it inside ``with mesh:`` on every rank (module docstring)."""

    fused_step: Callable  # from make_online_fused_step
    refresh_fn: Callable  # from make_refresh_fn
    num_pairs: int
    batch_size: int
    chunk_size: int = 16
    refresh_every: int = 200  # the single source of truth for the cadence
    seed: int = 0
    eval_fn: Callable | None = None  # state -> {metric: float}
    eval_every_steps: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 0
    # Snapshot the index beside each model checkpoint (step_N/index.pt)
    # and reload it on resume, making a resumed run bit-exact with an
    # uninterrupted one (otherwise the index is re-encoded with the
    # restored weights and pools can differ until the next refresh). Off
    # by default: index-size disk per checkpoint.
    checkpoint_index: bool = False
    exclude_pairs: tuple = ()  # held-out rows never fed to training
    log_mode: str = "last"  # "last" | "mean" | "all" (see TrainLoop)
    # when set, passed to fused_step as its third argument; the pair
    # indices go to its device
    corpus: DeviceCorpus | None = None
    # Overlapped refresh (train/overlap.py): the refresh runs beside
    # training, still with the trigger step's params, and the swap lands
    # ``overlap_delay_chunks`` chunk boundaries later (bounded, explicit
    # index staleness instead of the serial refresh's stall).
    overlap: object | None = None  # OverlappedRefresher
    overlap_delay_chunks: int = 1

    def __post_init__(self):
        if self.checkpoint_index and self.overlap is not None:
            # a snapshot cannot hold a refresh in flight, so a restart
            # would mine from another index than the uninterrupted run
            raise ValueError(
                "checkpoint_index=True is a single-mesh guarantee and is "
                "not supported together with an overlapped refresh "
                "(overlap=...); checkpoint at refresh-quiescent boundaries "
                "or disable one of the two"
            )

    def _index_snapshot_path(self, step: int) -> str:
        mesh = current_mesh()
        name = ("index.pt" if mesh is None or mesh.row_size == 1
                else f"index.shard{mesh.row_rank}of{mesh.row_size}.pt")
        return os.path.join(self.checkpoint_dir, f"step_{step}", name)

    def _save_index(self, embeddings, step: int) -> None:
        leaves = embeddings if isinstance(embeddings, tuple) else (embeddings,)
        path = self._index_snapshot_path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save([x.cpu() for x in leaves], tmp)
        os.replace(tmp, path)

    def _load_index(self, step: int, device: torch.device):
        """None if no snapshot; one tensor is an fp32 index, two the
        (int8 values, scales) pair (the only two shapes refresh_fn
        returns)."""
        path = self._index_snapshot_path(step)
        if not os.path.exists(path):
            return None
        leaves = [x.to(device) for x in
                  torch.load(path, map_location="cpu", weights_only=True)]
        return leaves[0] if len(leaves) == 1 else tuple(leaves)

    def _refresh(self, params, done: int, device, writer):
        t0 = time.perf_counter()
        embeddings = self.refresh_fn(params)
        _sync(device)
        writer.write({"step": done,
                      "refresh_seconds": time.perf_counter() - t0})
        return embeddings

    def run(self, state: TrainState, total_steps: int,
            writer: MetricWriter | None = None) -> TrainState:
        mesh = current_mesh()
        writer = writer_of(mesh, writer)
        stream = pair_index_stream(self.num_pairs, self.batch_size, self.seed,
                                   exclude=self.exclude_pairs)
        device = (self.corpus.device if self.corpus is not None else
                  next(iter(t5.flatten_params(state.params).values())).device)
        start_step = int(state.step)
        for _ in range(start_step):  # resume: skip consumed batches
            next(stream)

        embeddings = None
        if self.checkpoint_index and self.checkpoint_dir and start_step:
            embeddings = self._load_index(start_step, device)
        if embeddings is None:
            embeddings = self._refresh(encoder_weights(state, mesh),
                                       start_step, device, writer)
        carry = (state, embeddings)
        done = start_step
        last_eval = last_ckpt = done
        next_refresh = ((done // self.refresh_every) + 1) * self.refresh_every
        swap_at = None  # overlapped refresh: the step at which it lands
        index_ckpt_step = None  # pending post-refresh index snapshot
        t0 = time.perf_counter()
        while done < total_steps:
            k = min(self.chunk_size, total_steps - done)
            idx = torch.from_numpy(
                np.stack([next(stream) for _ in range(k)]).astype(np.int64)
            ).to(device)
            rows = []
            for t in range(k):
                if self.corpus is not None:
                    carry, m = self.fused_step(carry, idx[t], self.corpus)
                else:
                    carry, m = self.fused_step(carry, idx[t])
                rows.append(m)
            done += k

            write_chunk_metrics(writer, rows, done,
                                done_per_sec(done - start_step, t0),
                                self.log_mode)
            if (self.checkpoint_dir and self.checkpoint_every_steps
                    and done - last_ckpt >= self.checkpoint_every_steps):
                last_ckpt = done
                checkpoint(mesh, os.path.join(self.checkpoint_dir,
                                              f"step_{done}"), carry[0])
                # written at the END of this iteration, after a refresh
                # due at this same boundary: a resumed run schedules its
                # next refresh past this step, so it needs the new index
                index_ckpt_step = done if self.checkpoint_index else None
            if (self.eval_fn is not None and self.eval_every_steps
                    and done - last_eval >= self.eval_every_steps):
                last_eval = done
                ev = self.eval_fn(carry[0])
                writer.write({"step": done,
                              **{f"eval/{n}": v for n, v in ev.items()}})
                writer.flush()
            if self.overlap is not None and swap_at is not None \
                    and done >= swap_at:
                # the overlapped refresh lands at this chunk boundary
                carry = (carry[0], self.overlap.collect(old=carry[1]))
                swap_at = None
            if done >= next_refresh and done < total_steps:
                state = carry[0]
                if self.overlap is not None:
                    if self.overlap.in_flight:  # delay > cadence: land first
                        carry = (state, self.overlap.collect(old=carry[1]))
                    self.overlap.start(encoder_weights(state, mesh))
                    swap_at = done + self.overlap_delay_chunks * self.chunk_size
                else:
                    carry = (state, self._refresh(
                        encoder_weights(state, mesh), done, device, writer))
                next_refresh += self.refresh_every
            if index_ckpt_step is not None:
                self._save_index(carry[1], index_ckpt_step)
                index_ckpt_step = None
        if self.overlap is not None and self.overlap.in_flight:
            # an in-flight refresh nobody will read: dropped, not assembled
            self.overlap.discard()
        writer.write({"step": done, "time": time.perf_counter() - t0})
        writer.flush()
        return carry[0]

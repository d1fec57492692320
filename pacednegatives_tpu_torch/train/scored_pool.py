"""Model-in-the-loop negative selection: the port of train/scored_pool.py.

Every step scores a candidate subsample of each pair's static pool with the
cross-encoder (no gradient), orders the candidates by the model's own
relevance score, and curriculum-samples the n trained negatives from that
order instead of the static retrieval order: the reference's offline
``adhocRestructure`` (util.py:9-18), made online.

Per step (B pairs, C candidates, n trained negatives):

1. C evenly spaced slots of each pair's pool (``balanced_slots``);
2. the B*C candidate prompts scored in chunks of ``score_chunk_rows`` rows
   under ``torch.no_grad()``: ``monot5.score_batch`` in the compute dtype
   (on the card the encoder's self-attention is the fused block K3 when
   ``flash_v3`` is set), or the W8A8 forward of ``models/quant.py``;
3. the candidates ordered easiest (lowest score) to hardest, with a
   stable sort, as ``jnp.argsort`` orders them (ties, which bf16 scores
   make often, keep the slot order);
4. n distinct positions drawn from the paced binomial over that order with
   ``state.generator`` (``ops/sampling.sample_pool_indices_batch``, as
   ``make_fused_step`` draws them);
5. the ordinary train step on the selected negatives.

Where the JAX step runs the chunks under ``lax.map`` and picks each
chunk's bucket width with ``lax.switch``, the port runs a Python loop and
picks the widths on the host, all chunks' widths read in one copy a step
(``score_candidates``).
Under a mesh (parallel/mesh.py) ``pair_idx`` is the global batch on every
rank; each rank assembles every candidate and selects for every pair, so
that the ranks pick the same negatives with the same generator, and hands
its block of the batch's rows to the step. The scoring splits too (the
JAX package's row constraints under ``negative_parallel``,
scored_pool.py:209, 218, 252): each chunk's rows over the row group, after
the length sort, each rank scoring its block and one all-gather of the
scores a step. The port does this whenever a mesh is present, so
``negative_parallel`` is accepted for the JAX signature and changes
nothing (as in ``make_fused_step``).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.monot5 import score_batch
from pacednegatives_tpu_torch.ops.sampling import sample_pool_indices_batch
from pacednegatives_tpu_torch.parallel.collectives import gather_batch
from pacednegatives_tpu_torch.parallel.mesh import current_mesh, local_rows
from pacednegatives_tpu_torch.train.state import TrainState
from pacednegatives_tpu_torch.utils.profiling import host_sync, span


def balanced_slots(n_pool: int, c: int) -> np.ndarray:
    """C evenly-spaced slots over [0, n_pool): the candidate subsample keeps
    the static pool's difficulty span without biasing toward either end
    (reference get_balanced_idx, util.py:34-40)."""
    if not 0 < c <= n_pool:
        raise ValueError(f"candidates must be in (0, {n_pool}], got {c}")
    return np.unique(
        np.round(np.linspace(0, n_pool - 1, c)).astype(np.int32)
    )


def score_candidates(score_fn, ids: torch.Tensor, mask: torch.Tensor, *,
                     chunk_rows: int, buckets: tuple = (),
                     packed: bool = False, mesh=None) -> torch.Tensor:
    """(rows, L) prompts -> (rows,) scores under ``torch.no_grad()``,
    ``score_fn(ids, mask)`` on ``chunk_rows`` rows at a time (rounded down
    to a divisor of rows: every chunk has one shape). With ``buckets``
    (ascending widths; L is appended) the rows are sorted by true length
    and each chunk runs at the smallest width covering its longest row,
    every chunk's width read in one copy to the host; the scores come back
    in row order. Buckets need front-compacted prompts (``packed``). With
    a ``mesh`` each chunk's rows split over its row group (the chunk must
    divide), and every rank gets every score."""
    rows, L = ids.shape
    chunk = min(int(chunk_rows), rows)
    while rows % chunk:
        chunk -= 1
    # bucket widths below L, then L itself: a chunk longer than every
    # bucket runs at the full width
    widths = tuple(b for b in buckets if b < L) + (L,)
    use_buckets = len(widths) > 1
    with span("pnt.scored.score"), torch.no_grad():
        if use_buckets:
            if not packed:
                raise ValueError(
                    "score_buckets requires a front-compacted corpus "
                    "(DeviceCorpus.build(..., packed=True)): the segment "
                    "layout interleaves pads, so a [:, :W] slice would "
                    "drop real tokens"
                )
            lengths = mask.sum(dim=1)
            perm = torch.argsort(lengths, stable=True)
            ids, mask = ids[perm], mask[perm]
            longest = lengths[perm].view(rows // chunk, chunk).amax(dim=1)
            with host_sync("scored.widths"):
                longest = longest.tolist()
            chunk_widths = [widths[bisect.bisect_left(widths, w)]
                            for w in longest]
        else:
            chunk_widths = [L] * (rows // chunk)
        split = ((lambda t: t) if mesh is None
                 else (lambda t: local_rows(t, mesh)))
        raw = torch.cat([
            score_fn(split(ids[c * chunk:(c + 1) * chunk, :W]),
                     split(mask[c * chunk:(c + 1) * chunk, :W]))
            for c, W in enumerate(chunk_widths)
        ])
        if mesh is not None:
            # (row_size, chunks, block) -> each chunk's blocks in row order
            raw = gather_batch(raw.view(1, len(chunk_widths), -1),
                               mesh).transpose(0, 1).reshape(-1)
        if use_buckets:
            raw = torch.empty_like(raw).index_copy_(0, perm, raw)
    return raw


def make_scored_pool_step(
    corpus,  # DeviceCorpus
    step_fn,
    controller,
    model_cfg: t5.T5Config,
    *,
    n_neg_per_example: int,
    candidates: int = 64,
    rel_id: int,
    nrel_id: int,
    # "compute": score in the model's compute dtype; "int8": the W8A8
    # forward (models/quant.py) with an fp32 residual stream; "int8_bf16":
    # the same with a bf16 stream. The weights are quantized once a step.
    score_dtype: str = "compute",
    # JAX's row constraint; the port splits the scoring and the step's
    # rows over data x seq whenever a mesh is present (module docstring)
    negative_parallel: bool = False,
    # upper bound on rows per scoring forward (rounded down to a divisor
    # of B*C, as the JAX step rounds it)
    score_chunk_rows: int = 1024,
    # length-bucketed scoring: ascending encoder widths; the rows are
    # sorted by true length and each chunk runs at the smallest width
    # covering its longest row (the full width is appended). Needs a
    # front-compacted corpus (DeviceCorpus.packed).
    score_buckets: tuple = (),
):
    """Build fused(state, pair_idx[, corpus]) -> (state, metrics) with
    model-scored candidate pools (see the module docstring); a drop-in for
    ``make_fused_step(loss="lce")``. The metrics add ``neg_scored`` (B*C +
    B*n), ``neg_rank_static`` and ``pool_score_spread`` to the step's."""
    del negative_parallel
    n = n_neg_per_example
    if candidates < n:
        raise ValueError(
            f"candidates ({candidates}) must be >= n_neg_per_example ({n})"
        )
    if score_dtype not in ("compute", "int8", "int8_bf16"):
        raise ValueError(
            f"score_dtype must be 'compute', 'int8' or 'int8_bf16', "
            f"got {score_dtype!r}"
        )
    default_corpus = corpus
    slots_np = balanced_slots(int(corpus.n_neg), candidates)
    C = int(slots_np.shape[0])
    buckets = tuple(sorted({int(b) for b in score_buckets}))
    if buckets and buckets[0] <= 0:
        raise ValueError(f"score_buckets must be positive, got {buckets}")

    def fused(state: TrainState, pair_idx: torch.Tensor, corpus=None):
        with span("pnt.step", state.step):
            return scored_step(state, pair_idx,
                               default_corpus if corpus is None else corpus)

    def scored_step(state: TrainState, pair_idx: torch.Tensor, corpus):
        mesh = current_mesh()
        B = pair_idx.shape[0]
        dev = corpus.device
        with span("pnt.step.sample"):
            difficulty = controller.difficulty(state.curriculum)
            with host_sync("scored.slots"):
                slots = torch.from_numpy(slots_np).to(dev, torch.int64)
            q = corpus.query_rows[pair_idx]
            pos_d = corpus.pos_rows[pair_idx]
            cand_d = corpus.pools[pair_idx][:, slots]  # (B, C)
            ids, mask = corpus.assemble(q.repeat_interleave(C),
                                        cand_d.reshape(-1))

        with torch.no_grad():
            if score_dtype in ("int8", "int8_bf16"):
                from pacednegatives_tpu_torch.models.quant import (
                    quantize_scoring_params,
                    score_batch_int8,
                )

                sd = (torch.bfloat16 if score_dtype == "int8_bf16"
                      else torch.float32)
                # the live params quantized once a step, outside the chunks
                qp = quantize_scoring_params(state.params, model_cfg)
                score_fn = lambda i, m: score_batch_int8(
                    qp, model_cfg, i, m, rel_id=rel_id, nrel_id=nrel_id,
                    stream_dtype=sd)
            else:
                score_fn = lambda i, m: score_batch(
                    state.params, model_cfg, i, m, rel_id=rel_id,
                    nrel_id=nrel_id)
        raw = score_candidates(score_fn, ids, mask,
                               chunk_rows=score_chunk_rows, buckets=buckets,
                               packed=corpus.packed, mesh=mesh)
        scores = raw.reshape(B, C)

        with span("pnt.scored.draw"):
            # easiest (lowest relevance) -> hardest (highest), per pair
            order = torch.argsort(scores, dim=1, stable=True)
            means = torch.as_tensor(difficulty, dtype=torch.float32,
                                    device=dev).expand(B)
            sel = sample_pool_indices_batch(state.generator, C, means, n)
            picked = torch.gather(order, 1, sel)  # (B, n) candidate columns
            neg_d = torch.gather(cand_d, 1, picked)  # (B, n) doc rows

            pos_ids, pos_mask = corpus.assemble(q, pos_d)
            neg_ids, neg_mask = corpus.assemble(q.repeat_interleave(n),
                                                neg_d.reshape(-1))
            static_pos = slots.float()[picked.reshape(-1)]
            batch = {
                "pos_ids": pos_ids,
                "pos_mask": pos_mask,
                "pos_labels": corpus.labels(B, True),
                "neg_ids": neg_ids,
                "neg_mask": neg_mask,
                "neg_labels": corpus.labels(B * n, False),
                # model-order position of the drawn negatives (0 = easiest
                # for the current model)
                "neg_rank": (sel.float() / max(C - 1, 1)).reshape(-1),
            }
            if mesh is not None:
                batch = {k: local_rows(v, mesh) for k, v in batch.items()}
        new_state, metrics = step_fn(state, batch)
        with host_sync("scored.neg_scored"):
            neg_scored = torch.tensor(float(B * C + B * n), device=dev)
        metrics = {
            **metrics,
            # candidates scored this step + the trained negatives' scores
            # produced by the gradient pass itself
            "neg_scored": neg_scored,
            # where the selected negatives sit in the static order
            "neg_rank_static": (static_pos
                                / max(corpus.n_neg - 1, 1)).mean(),
            "pool_score_spread": (scores.amax(dim=1)
                                  - scores.amin(dim=1)).mean(),
        }
        return new_state, metrics

    return fused

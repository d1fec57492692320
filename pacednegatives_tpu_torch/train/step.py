"""The train steps: the port of train/step.py.

``make_train_step``: the model's compute-dtype leaves once a step
(``models/interface.py``; T5: the position biases from the two rel_bias
tables, the big weights cast and q|k|v concatenated once), one forward
over [positives; negatives] per microbatch and its backward by autograd,
gradient accumulation over the microbatches in ``grad_accum_dtype``, the
gradients folded back into the parameters' tree (T5: the biases'
cotangent through the gather's backward), the optimizer, then the
curriculum update from the same pass's CE values (step.py:145-330), for
the pair loss (the interp, level, eta and
contrast curricula: one negative an example, per-token signals) and the
LCE loss (n negatives). With ``dropout``, each microbatch draws its masks
from its own seed, taken on the host from ``state.dropout_generator`` (the
JAX step splits its key over the microbatches, step.py:258).

``make_meta_train_step``: the bilevel per-example weight table (NewWrapper
``cheap``, StdWrapper ``std``: a gradient through a virtual SGD step,
``torch.autograd.grad`` with ``create_graph=True``), step.py:416-509.
"""

from __future__ import annotations

from typing import Callable

import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals
from pacednegatives_tpu_torch.curriculum.meta import MetaWeightTable
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.interface import for_config
from pacednegatives_tpu_torch.models.monot5 import relevance_probs
from pacednegatives_tpu_torch.ops.losses import (
    lce_ce,
    lce_ce_flat_tokens,
    token_ce,
    token_ce_per_token,
)
from pacednegatives_tpu_torch.optim import apply_updates
from pacednegatives_tpu_torch.parallel.collectives import (
    gather_batch,
    gather_batch_with_grad,
    mean_over_ranks,
)
from pacednegatives_tpu_torch.parallel.mesh import (
    current_mesh,
    local_rows,
    refuse_tensor_parallel,
)
from pacednegatives_tpu_torch.train.state import TrainState
from pacednegatives_tpu_torch.utils.profiling import span

Batch = dict[str, torch.Tensor]


def make_train_step(
    model_cfg,
    controller,
    tx,
    loss: str = "pair",
    n_neg_per_example: int = 1,
    use_mean: bool = True,
    label_grouping: str = "per_example",
    rel_id: int = 3,
    nrel_id: int = 4,
    dropout: bool = False,
    microbatches: int = 1,
    grad_accum_dtype: str = "fp32",
) -> Callable[[TrainState, Batch], tuple[TrainState, dict]]:
    """Build step(state, batch) -> (state, metrics) for the model of
    ``model_cfg`` (``models.interface.for_config``: a ``T5Config`` or a
    ``DeepseekV3Config``; the latter trains on its verbalizer's CE at the
    last real position, the labels' first column).

    loss="pair": main = mean(pce) + mean(nce); the curriculum signals are
    per label TOKEN, (B*L_label,), with ce = (pce + nce) / 2, and success
    per example (step.py:216-222, 310-323): the reference flattens logits
    to (B*L_label, V) before its CrossEntropyLoss, so eta's weighting, its
    objective and the success rate run over tokens. loss="lce": main =
    mean(pce + agg_n nce); curriculum ce = the same per-example vector (or
    the flat-token regrouping with label_grouping="flat_tokens").

    microbatches=k > 1 splits the batch into k equal example slices, runs
    forward + backward on each in turn and sums the gradients in
    ``grad_accum_dtype`` ("fp32", or "bf16", which rounds once per add):
    each is divided by k in its own dtype, cast to the carry's dtype and
    added, as the JAX scan does; the sum is upcast to fp32 for the
    optimizer. One optimizer and one curriculum update per step.

    Under a mesh (``with mesh:``, parallel/mesh.py) the batch is this
    rank's rows (``make_fused_step`` hands them over) and the step stays
    one global-batch step, as GSPMD computes it: every rank computes the
    loss on every rank's per-token CE rows (gathered with a gradient), the
    fp32 gradients are averaged over the row group before the optimizer,
    and the curriculum signals and metrics are the global batch's on every
    rank, in row order. Under tensor parallelism (``model > 1``) the state
    is a rank's (``shard_train_state``): the forward runs split over the
    model group, the CE and the verbalizer pair are reduced over the vocab
    columns, split leaves keep their slices' gradients (averaged over the
    row group only), whole leaves get the same gradient on every rank of
    the row through the split layers' conjugate Functions, and the
    optimizer takes ``state.param_dims``."""
    if loss not in ("pair", "lce"):
        raise ValueError(loss)
    if label_grouping not in ("per_example", "flat_tokens"):
        raise ValueError(
            f"label_grouping must be 'per_example' or 'flat_tokens', "
            f"got {label_grouping!r}"
        )
    if grad_accum_dtype not in ("fp32", "bf16"):
        raise ValueError(
            f"grad_accum_dtype must be 'fp32' or 'bf16', "
            f"got {grad_accum_dtype!r}"
        )
    if grad_accum_dtype != "fp32" and microbatches <= 1:
        raise ValueError(
            "grad_accum_dtype='bf16' requires microbatches > 1 "
            "(no accumulation carry exists at microbatches=1)"
        )
    n = n_neg_per_example
    k = microbatches
    model = for_config(model_cfg)
    acc_dt = torch.float32 if grad_accum_dtype == "fp32" else torch.bfloat16

    def objective(ce_tok, labels, b):
        """(main loss, (sig_p, sig_n, sig_ce)) of per-token CE rows
        [positives; negatives] with ``b`` positives (step.py:200-232)."""
        count = (labels != -100).sum(dim=-1).clamp_min(1)
        ce_all = ce_tok.sum(dim=-1) / count
        pce, nce = ce_all[:b], ce_all[b:]
        if loss == "pair":
            sig_p, sig_n = ce_tok[:b].reshape(-1), ce_tok[b:].reshape(-1)
            return pce.mean() + nce.mean(), (sig_p, sig_n,
                                              (sig_p + sig_n) / 2.0)
        if label_grouping == "flat_tokens":
            sig_ce = lce_ce_flat_tokens(ce_tok[:b], ce_tok[b:], n, use_mean)
        else:
            sig_ce = lce_ce(pce, nce, n, use_mean)
        return sig_ce.mean(), (pce, nce, sig_ce)

    def loss_fn(mesh, prep, seed, pos_ids, pos_mask, pos_labels,
                neg_ids, neg_mask, neg_labels):
        # one forward over [positives; negatives]
        b = pos_ids.shape[0]
        ids = torch.cat([pos_ids, neg_ids])
        mask = torch.cat([pos_mask, neg_mask])
        labels = torch.cat([pos_labels, neg_labels])
        logits, labels = model.logits(prep, ids, mask, labels, seed,
                                      deterministic=not dropout)
        ce_tok = token_ce_per_token(logits, labels,
                                    vocab_size=model_cfg.vocab_size)
        main, sig = objective(ce_tok, labels, b)
        if mesh is not None:
            # every rank's rows, as one process holds the global batch
            # ([all positives; all negatives]), and the loss on them on
            # every rank (_GatherRows carries the gradient back to each
            # rank's rows)
            def every(t, gather):
                g = gather(t[None], mesh)  # (row_size, rows, ...)
                return torch.cat([g[:, :b].flatten(0, 1),
                                  g[:, b:].flatten(0, 1)])

            main, _ = objective(every(ce_tok, gather_batch_with_grad),
                                every(labels, gather_batch),
                                b * mesh.row_size)
        first = logits[:, 0, :].detach()
        return main, (*(a.detach() for a in sig), first[:b], first[b:])

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        mesh = current_mesh()
        dims = None
        if mesh is not None and mesh.model > 1:
            if state.param_dims is None:
                raise ValueError(
                    "a step under a mesh with model > 1 needs a rank's "
                    "state: train.state.shard_train_state(mesh, state)")
            dims = state.param_dims
        with span("pnt.step.prepare"):
            B = batch["pos_ids"].shape[0]
            prep = model.prepare(state.params, batch["pos_ids"].shape[1],
                                 batch["pos_labels"].shape[1], mesh, dims)
            leaves = prep.leaves
            keys = ("pos_ids", "pos_mask", "pos_labels", "neg_ids",
                    "neg_mask", "neg_labels")
            if k <= 1:
                chunks = [tuple(batch[key] for key in keys)]
            else:
                if B % k:
                    raise ValueError(
                        f"batch {B} not divisible by microbatches {k}")
                m = B // k
                rows = (1, 1, 1, n, n, n)
                chunks = [tuple(batch[key][i * m * r:(i + 1) * m * r]
                                for key, r in zip(keys, rows))
                          for i in range(k)]
            # one dropout seed a microbatch, from the host generator
            seeds = (torch.randint(2**63 - 1, (len(chunks),),
                                   generator=state.dropout_generator).tolist()
                     if dropout else [None] * len(chunks))
            if dropout and mesh is not None:
                # the ranks' generators agree: one stream a rank, so that no
                # two ranks draw the same masks for their rows
                seeds = [(s + mesh.row_rank) % (2**63 - 1) for s in seeds]
        grads = None
        main_loss = torch.zeros((), dtype=torch.float32,
                                device=batch["pos_ids"].device)
        auxes = []
        for chunk, seed in zip(chunks, seeds):
            with span("pnt.step.fwd_bwd"):
                with torch.enable_grad():
                    l_i, aux_i = loss_fn(mesh, prep, seed, *chunk)
                    g_i = torch.autograd.grad(l_i, leaves,
                                              allow_unused=True)
                g_i = [torch.zeros_like(p) if g is None else g
                       for g, p in zip(g_i, leaves)]
                if k <= 1:
                    grads = g_i
                    main_loss = l_i.detach()
                else:
                    # each microbatch's gradient / k in its own dtype, then
                    # into the carry's dtype (step.py:261-297)
                    parts = [(g / k).to(acc_dt) for g in g_i]
                    grads = parts if grads is None else [
                        a.add_(p) for a, p in zip(grads, parts)]
                    main_loss = main_loss + l_i.detach() / k
                auxes.append(aux_i)
        sig_p, sig_n, sig_ce, p_first, n_first = (
            torch.cat(parts) for parts in zip(*auxes))

        # the optimizer and the bias fold run in fp32 (step.py:288-305)
        with span("pnt.step.optimizer"):
            grads = [g.float() for g in grads]
            if mesh is not None:
                # one global-batch step: the ranks' gradients averaged before
                # the optimizer (and so before its clipping)
                grads = mean_over_ranks(grads, mesh)
            grads = model.fold(prep, grads)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params, model_dims=dims)
            params = apply_updates(state.params, updates)

        # curriculum signals from the same pass; success compares each
        # positive with the first of its negatives (step.py:310-323)
        with span("pnt.step.curriculum"):
            with torch.no_grad():
                p_prob = relevance_probs(p_first, rel_id, nrel_id,
                                         model_cfg.vocab_size)
                n_prob = relevance_probs(n_first, rel_id, nrel_id,
                                         model_cfg.vocab_size)
                neg_rank = batch.get("neg_rank")
                if mesh is not None:
                    # the global batch's signals on every rank, in row order,
                    # so that the ranks' curricula stay one
                    sig_p, sig_n, sig_ce, p_prob, n_prob = (
                        gather_batch(t, mesh)
                        for t in (sig_p, sig_n, sig_ce, p_prob, n_prob))
                    if neg_rank is not None:
                        neg_rank = gather_batch(neg_rank, mesh)
                n_prob_first = n_prob.reshape(-1, n)[:, 0] if n > 1 else n_prob
                signals = StepSignals(
                    pce=sig_p,
                    nce=(sig_n if loss == "pair"
                         else sig_n.reshape(-1, n).mean(dim=1)),
                    ce=sig_ce,
                    success=(p_prob > n_prob_first).float(),
                )
            curriculum = controller.update(state.curriculum, signals)
            pair_acc = signals.success.mean()
            metrics = {
                "loss": main_loss,
                "probs": pair_acc,
                "p_true": p_prob.mean(),
                **controller.metrics(curriculum),
            }
            if hasattr(controller, "success_rate"):
                metrics["success_rate"] = controller.success_rate(curriculum,
                                                                  signals)
            else:
                metrics["success_rate"] = pair_acc
            if neg_rank is not None:
                metrics["neg_rank"] = neg_rank.mean()
            if hasattr(controller, "meta_loss"):
                metrics["meta_loss"] = controller.meta_loss(state.curriculum,
                                                            signals)
            new_state = state._replace(params=params, opt_state=opt_state,
                                       curriculum=curriculum,
                                       step=state.step + 1)
        return new_state, metrics

    return step


def make_fused_step(corpus, step_fn, controller, loss: str = "pair",
                    n_neg_per_example: int = 1,
                    negative_parallel: bool = False):
    """fused(state, pair_idx) = difficulty -> negatives -> gather prompts ->
    step, all on the corpus's device (step.py:362-408). LCE draws its n
    negatives with ``state.generator``; the pair loss takes the pool slot
    the difficulty names and draws nothing.

    Under a mesh ``pair_idx`` is the global batch on every rank, and every
    rank draws the global batch's negatives with the same generator state
    (the generators stay one, and the draws are one process's); each rank
    assembles and steps on its rows only: the positives of its block of
    pairs over data x seq and their negatives. That is also the row split
    of JAX's ``negative_parallel`` (B positives and B*n example-major
    negatives, each over data x seq), so the flag is accepted for the JAX
    signature and changes nothing: in the port the seq axis is plain data
    parallelism. The pairs must divide data x seq, or it raises."""
    del negative_parallel
    if loss not in ("pair", "lce"):
        raise ValueError(loss)
    default_corpus = corpus
    n = n_neg_per_example

    def fused(state: TrainState, pair_idx: torch.Tensor, corpus=None):
        corpus = default_corpus if corpus is None else corpus
        with span("pnt.step", state.step):
            with span("pnt.step.sample"):
                difficulty = controller.difficulty(state.curriculum)
                if loss == "lce":
                    rows = (None if current_mesh() is None
                            else local_rows(torch.arange(pair_idx.shape[0])))
                    batch = corpus.lce_batch(state.generator, pair_idx,
                                             difficulty, n, rows=rows)
                else:
                    batch = corpus.pair_batch(local_rows(pair_idx), difficulty)
            return step_fn(state, batch)

    return fused


# ---------------------------------------------------------------------------
# Bilevel per-example weights (StdWrapper / NewWrapper)
# ---------------------------------------------------------------------------


def _refuse_flash_v3(cfg: t5.T5Config) -> None:
    """std takes a gradient through a gradient, and the hand kernels'
    autograd Functions have no double backward: each raises in its own
    backward (``FusedSelfAttention``; ``_FlashCore`` on CUDA). flash_v3
    reaches its Function on every device, so std refuses it when built."""
    if cfg.flash_v3:
        raise NotImplementedError(
            "make_meta_train_step(variant='std') on flash_v3 "
            "(FusedSelfAttention: K3 forward, K4 backward): std takes a "
            "gradient through a gradient, and the hand kernels' autograd "
            "Functions have no double backward (the JAX package fails there "
            "too, in pallas_call's JVP rule). Run std with flash_v3=False "
            "and, on CUDA, flash_kernel=False (the dense or the plain "
            "chunked route)")


def make_meta_train_step(
    model_cfg: t5.T5Config,
    table: MetaWeightTable,
    tx,
    meta_lr_schedule: Callable[[int], float],
    variant: str = "cheap",  # "cheap" (NewWrapper) | "std" (StdWrapper)
    rel_id: int = 3,
    nrel_id: int = 4,
):
    """step(state, batch, batch_idx) -> (state, metrics) with the
    per-example weight-table curriculum (step.py:416-509); ``batch_idx`` is
    the table row, a host int.

    cheap (NewWrapper, pairwrapper.py:219-284): the frozen model's CE (two
    forwards under ``no_grad``) drives the closed-form weight update; the
    main loss is unweighted.

    std (StdWrapper, pairwrapper.py:102-206): the weighted CE's gradient
    with ``create_graph=True``, virtual params theta' = theta - lr * g, and
    the gradient of weighted_CE(theta', v) - sum(v) with respect to v
    through it; the main loss is weighted by the stored row, detached.
    Raises NotImplementedError where the model reaches a hand kernel's
    autograd Function: flash_v3 when built, chunked ``flash_kernel`` on
    CUDA in ``_FlashCore``'s backward.

    Every forward runs on the fp32 master weights (each product casts them
    to the compute dtype), with no precomputed biases and no fused q|k|v,
    as the JAX step runs them; ``rel_id`` / ``nrel_id`` are accepted for
    the JAX signature and unused there too. The generators do not move."""
    del rel_id, nrel_id
    if variant not in ("cheap", "std"):
        raise ValueError(f"variant must be 'cheap' or 'std', got {variant!r}")
    if variant == "std":
        _refuse_flash_v3(model_cfg)
    refuse_tensor_parallel("make_meta_train_step")

    def per_example(params, batch):
        def ce(side):
            logits = t5.forward_logits(params, model_cfg, batch[f"{side}_ids"],
                                       batch[f"{side}_labels"],
                                       batch[f"{side}_mask"])
            return token_ce(logits, batch[f"{side}_labels"])

        return ce("pos"), ce("neg")

    def weighted(pce, nce, v):
        B = v.shape[0]
        return (pce * v).sum() / B + (nce * v).sum() / B

    def leaves_of(params):
        return {k: p.detach().requires_grad_(True)
                for k, p in t5.flatten_params(params).items()}

    def grads_of(loss, leaves, **kw):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, **kw)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, leaves.values())]

    def step(state: TrainState, batch: Batch, batch_idx: int):
        refuse_tensor_parallel("make_meta_train_step")
        device = batch["pos_ids"].device
        lr = torch.full((), float(meta_lr_schedule(state.step)),
                        dtype=torch.float32, device=device)
        v = table.lookup(state.curriculum, batch_idx)

        if variant == "cheap":
            with torch.no_grad():
                pce0, nce0 = per_example(state.params, batch)
            raw = table.cheap_update(v, pce0, nce0, lr)
            curriculum = table.store(state.curriculum, batch_idx, raw)
            v_main = None  # unweighted main (pairwrapper.py:241-257)
        else:
            with torch.enable_grad():
                v_ = v.detach().requires_grad_(True)
                leaves = leaves_of(state.params)
                inner = weighted(*per_example(t5.unflatten_params(leaves),
                                              batch), v_)
                g = grads_of(inner, leaves, create_graph=True)
                virtual = t5.unflatten_params(
                    {k: p - lr * gk
                     for (k, p), gk in zip(leaves.items(), g)})
                outer = weighted(*per_example(virtual, batch), v_) - v_.sum()
                (gv,) = torch.autograd.grad(outer, v_)
            # the second-order graph goes before the main forward's
            del inner, g, virtual, outer
            raw = v - lr * gv
            curriculum = table.store(state.curriculum, batch_idx, raw)
            v_main = table.lookup(curriculum, batch_idx)

        leaves = leaves_of(state.params)
        with torch.enable_grad():
            pce, nce = per_example(t5.unflatten_params(leaves), batch)
            loss = (pce.mean() + nce.mean() if v_main is None
                    else weighted(pce, nce, v_main.detach()))
            grads = grads_of(loss, leaves)
        grads = t5.unflatten_params(dict(zip(leaves, grads)))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        metrics = {
            "loss": loss.detach(),
            **table.metrics(curriculum, batch_idx),
        }
        new_state = state._replace(params=params, opt_state=opt_state,
                                   curriculum=curriculum,
                                   step=state.step + 1)
        return new_state, metrics

    return step

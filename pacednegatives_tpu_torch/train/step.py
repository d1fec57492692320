"""The train steps: the port of train/step.py.

``make_train_step``: compute the position biases once from the two rel_bias
tables, cast the big weights to the compute dtype once (and concatenate
q|k|v once, with fused_qkv), one teacher-forced forward over [positives;
negatives] per microbatch and its backward by autograd, gradient
accumulation over the microbatches in ``grad_accum_dtype``, the biases'
accumulated cotangent folded back into the tables through the gather's
backward, the optimizer, then the curriculum update from the same pass's
CE values (step.py:145-330), for the pair loss (the interp, level, eta and
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
from pacednegatives_tpu_torch.models.monot5 import relevance_probs
from pacednegatives_tpu_torch.ops.losses import (
    lce_ce,
    lce_ce_flat_tokens,
    token_ce,
    token_ce_per_token,
)
from pacednegatives_tpu_torch.optim import apply_updates
from pacednegatives_tpu_torch.train.state import TrainState

Batch = dict[str, torch.Tensor]


def _fold_rel_bias_grad(grads: dict, stack_key: str, g: torch.Tensor) -> None:
    """Add ``g`` into the rel_bias leaf of ``grads[stack_key]`` (the stacked
    layout's top-level ``rel_bias`` or ``block_0.self_attn.rel_bias``), in
    place (step.py:41-54)."""
    stack = grads[stack_key]
    if "rel_bias" in stack:
        stack["rel_bias"] = stack["rel_bias"] + g
    else:
        sa = stack["block_0"]["self_attn"]
        sa["rel_bias"] = sa["rel_bias"] + g


def make_train_step(
    model_cfg: t5.T5Config,
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
    """Build step(state, batch) -> (state, metrics).

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
    optimizer. One optimizer and one curriculum update per step."""
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
    acc_dt = torch.float32 if grad_accum_dtype == "fp32" else torch.bfloat16

    def _pre(p: torch.Tensor) -> torch.Tensor:
        # the big matmul weights in the compute dtype, once per step
        # (step.py:186-198); 1-D scales and the (buckets, H) rel_bias stay
        if p.dim() >= 2 and p.shape[-1] >= 128 and p.dtype == torch.float32:
            p = p.to(model_cfg.dtype)
        return p.detach().requires_grad_(True)

    def loss_fn(params, biases, seed, pos_ids, pos_mask, pos_labels, neg_ids,
                neg_mask, neg_labels):
        # one forward over [positives; negatives] (step.py:200-232)
        b = pos_ids.shape[0]
        ids = torch.cat([pos_ids, neg_ids])
        mask = torch.cat([pos_mask, neg_mask])
        labels = torch.cat([pos_labels, neg_labels])
        logits = t5.forward_logits(params, model_cfg, ids, labels, mask,
                                   deterministic=not dropout,
                                   dropout_seed=seed, pos_biases=biases)
        ce_tok = token_ce_per_token(logits, labels)
        count = (labels != -100).sum(dim=-1).clamp_min(1)
        ce_all = ce_tok.sum(dim=-1) / count
        pce, nce = ce_all[:b], ce_all[b:]
        if loss == "pair":
            main = pce.mean() + nce.mean()
            sig_p, sig_n = ce_tok[:b].reshape(-1), ce_tok[b:].reshape(-1)
            sig_ce = (sig_p + sig_n) / 2.0
        else:
            if label_grouping == "flat_tokens":
                sig_ce = lce_ce_flat_tokens(ce_tok[:b], ce_tok[b:], n,
                                            use_mean)
            else:
                sig_ce = lce_ce(pce, nce, n, use_mean)
            main = sig_ce.mean()
            sig_p, sig_n = pce, nce
        first = logits[:, 0, :]
        aux = (sig_p, sig_n, sig_ce, first[:b], first[b:])
        return main, tuple(a.detach() for a in aux)

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        B = batch["pos_ids"].shape[0]
        # Position biases once per step, not per microbatch (step.py:
        # 165-178): the microbatches differentiate against the bias
        # tensors, whose summed cotangent goes through the bucket gather's
        # backward once, below.
        tables = [t5._rel_bias(state.params[s]).detach().requires_grad_(True)
                  for s in ("encoder", "decoder")]
        with torch.enable_grad():
            full = t5.position_bias_from_tables(
                *tables, model_cfg, batch["pos_ids"].shape[1],
                batch["pos_labels"].shape[1])
        bias_keys = ("enc", "dec_self")
        biases = {key: full[key].detach().requires_grad_(True)
                  for key in bias_keys}
        with torch.no_grad():
            src = (t5.fuse_attention_params(state.params)
                   if model_cfg.fused_qkv else state.params)
        flat = t5.flatten_params(t5.tree_map(_pre, src))
        params_c = t5.unflatten_params(flat)
        leaves = [*flat.values(), *(biases[key] for key in bias_keys)]
        keys = ("pos_ids", "pos_mask", "pos_labels", "neg_ids", "neg_mask",
                "neg_labels")
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
        grads = None
        main_loss = torch.zeros((), dtype=torch.float32,
                                device=batch["pos_ids"].device)
        auxes = []
        for chunk, seed in zip(chunks, seeds):
            with torch.enable_grad():
                l_i, aux_i = loss_fn(params_c, biases, seed, *chunk)
                g_i = torch.autograd.grad(l_i, leaves, allow_unused=True)
            g_i = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(g_i, leaves)]
            if k <= 1:
                grads = g_i
                main_loss = l_i.detach()
            else:
                # each microbatch's gradient / k in its own dtype, then into
                # the carry's dtype (step.py:261-297)
                parts = [(g / k).to(acc_dt) for g in g_i]
                grads = parts if grads is None else [
                    a.add_(p) for a, p in zip(grads, parts)]
                main_loss = main_loss + l_i.detach() / k
            auxes.append(aux_i)
        sig_p, sig_n, sig_ce, p_first, n_first = (
            torch.cat(parts) for parts in zip(*auxes))

        # the optimizer and the bias fold run in fp32 (step.py:288-305)
        grads = [g.float() for g in grads]
        gbias = grads[len(flat):]
        grads = t5.unflatten_params(dict(zip(flat, grads[:len(flat)])))
        if model_cfg.fused_qkv:
            grads = t5.split_attention_grads(grads)
        g_enc, g_dec = torch.autograd.grad(
            [full[key] for key in bias_keys], tables, grad_outputs=gbias)
        _fold_rel_bias_grad(grads, "encoder", g_enc)
        _fold_rel_bias_grad(grads, "decoder", g_dec)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)

        # curriculum signals from the same pass; success compares each
        # positive with the first of its negatives (step.py:310-323)
        with torch.no_grad():
            p_prob = relevance_probs(p_first, rel_id, nrel_id)
            n_prob = relevance_probs(n_first, rel_id, nrel_id)
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
        if "neg_rank" in batch:
            metrics["neg_rank"] = batch["neg_rank"].mean()
        if hasattr(controller, "meta_loss"):
            metrics["meta_loss"] = controller.meta_loss(state.curriculum,
                                                        signals)
        new_state = state._replace(params=params, opt_state=opt_state,
                                   curriculum=curriculum,
                                   step=state.step + 1)
        return new_state, metrics

    return step


def make_fused_step(corpus, step_fn, controller, loss: str = "pair",
                    n_neg_per_example: int = 1):
    """fused(state, pair_idx) = difficulty -> negatives -> gather prompts ->
    step, all on the corpus's device (step.py:362-408). LCE draws its n
    negatives with ``state.generator``; the pair loss takes the pool slot
    the difficulty names and draws nothing."""
    if loss not in ("pair", "lce"):
        raise ValueError(loss)
    default_corpus = corpus

    def fused(state: TrainState, pair_idx: torch.Tensor, corpus=None):
        corpus = default_corpus if corpus is None else corpus
        difficulty = controller.difficulty(state.curriculum)
        if loss == "lce":
            batch = corpus.lce_batch(state.generator, pair_idx, difficulty,
                                     n_neg_per_example)
        else:
            batch = corpus.pair_batch(pair_idx, difficulty)
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

"""The LCE train step: the port of train/step.py.

One step: cast the big weights to the compute dtype once (and concatenate
q|k|v once, with fused_qkv), one teacher-forced forward over
[positives; negatives] per microbatch and its backward by autograd, fp32
gradient accumulation over the microbatches, AdamW, then the curriculum
update from the same pass's CE values. The JAX step's position-bias vjp
(step.py:165-178, 301-305) is autograd's own gradient here (models/t5.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.monot5 import relevance_probs
from pacednegatives_tpu_torch.ops.losses import (
    lce_ce,
    lce_ce_flat_tokens,
    token_ce_per_token,
)
from pacednegatives_tpu_torch.optim import Adam, apply_updates
from pacednegatives_tpu_torch.train.state import TrainState

Batch = dict[str, torch.Tensor]


def _check_slice(loss: str, dropout: bool, grad_accum_dtype: str) -> None:
    if loss == "pair":
        raise NotImplementedError(
            "loss='pair' is not ported yet (ROADMAP.md slice C, with the "
            "interp/level/eta curricula); use loss='lce'"
        )
    if dropout:
        raise NotImplementedError(
            "dropout is not ported yet (ROADMAP.md slice T2)")
    if grad_accum_dtype == "bf16":
        raise NotImplementedError(
            "grad_accum_dtype='bf16' is not ported yet (ROADMAP.md slice "
            "T2); the port accumulates in fp32")


def make_train_step(
    model_cfg: t5.T5Config,
    controller,
    tx: Adam,
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
    """Build step(state, batch) -> (state, metrics) for loss="lce": main =
    mean(pce + agg_n nce); curriculum ce = the same per-example vector
    (or the flat-token regrouping with label_grouping="flat_tokens").

    microbatches=k > 1 splits the batch into k equal example slices, runs
    forward + backward on each in turn and sums the fp32 gradients (each
    divided by k in its own dtype first, as the JAX scan does): one
    optimizer and one curriculum update per step."""
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
    _check_slice(loss, dropout, grad_accum_dtype)
    n = n_neg_per_example
    k = microbatches

    def _pre(p: torch.Tensor) -> torch.Tensor:
        # the big matmul weights in the compute dtype, once per step
        # (step.py:186-198); 1-D scales and the (buckets, H) rel_bias stay
        if p.dim() >= 2 and p.shape[-1] >= 128 and p.dtype == torch.float32:
            p = p.to(model_cfg.dtype)
        return p.detach().requires_grad_(True)

    def loss_fn(params, pos_ids, pos_mask, pos_labels, neg_ids, neg_mask,
                neg_labels):
        # one forward over [positives; negatives] (step.py:200-232)
        b = pos_ids.shape[0]
        ids = torch.cat([pos_ids, neg_ids])
        mask = torch.cat([pos_mask, neg_mask])
        labels = torch.cat([pos_labels, neg_labels])
        logits = t5.forward_logits(params, model_cfg, ids, labels, mask)
        ce_tok = token_ce_per_token(logits, labels)
        count = (labels != -100).sum(dim=-1).clamp_min(1)
        ce_all = ce_tok.sum(dim=-1) / count
        pce, nce = ce_all[:b], ce_all[b:]
        if label_grouping == "flat_tokens":
            sig_ce = lce_ce_flat_tokens(ce_tok[:b], ce_tok[b:], n, use_mean)
        else:
            sig_ce = lce_ce(pce, nce, n, use_mean)
        first = logits[:, 0, :]
        aux = (pce, nce, sig_ce, first[:b], first[b:])
        return sig_ce.mean(), tuple(a.detach() for a in aux)

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        B = batch["pos_ids"].shape[0]
        with torch.no_grad():
            src = (t5.fuse_attention_params(state.params)
                   if model_cfg.fused_qkv else state.params)
        flat = t5.flatten_params(t5.tree_map(_pre, src))
        params_c = t5.unflatten_params(flat)
        leaves = list(flat.values())
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
        grads = None
        main_loss = torch.zeros((), dtype=torch.float32,
                                device=batch["pos_ids"].device)
        auxes = []
        for chunk in chunks:
            with torch.enable_grad():
                l_i, aux_i = loss_fn(params_c, *chunk)
                g_i = torch.autograd.grad(l_i, leaves, allow_unused=True)
            g_i = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(g_i, leaves)]
            if k <= 1:
                grads = [g.float() for g in g_i]
                main_loss = l_i.detach()
            else:
                parts = [(g / k).float() for g in g_i]
                grads = parts if grads is None else [
                    a.add_(p) for a, p in zip(grads, parts)]
                main_loss = main_loss + l_i.detach() / k
            auxes.append(aux_i)
        pce, nce, sig_ce, p_first, n_first = (
            torch.cat(parts) for parts in zip(*auxes))

        grads = t5.unflatten_params(dict(zip(flat, grads)))
        if model_cfg.fused_qkv:
            grads = t5.split_attention_grads(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)

        # curriculum signals from the same pass; success compares each
        # positive with the first of its negatives (step.py:310-323)
        with torch.no_grad():
            p_prob = relevance_probs(p_first, rel_id, nrel_id)
            n_prob = relevance_probs(n_first, rel_id, nrel_id)
            n_prob_first = n_prob.reshape(-1, n)[:, 0] if n > 1 else n_prob
            signals = StepSignals(
                pce=pce,
                nce=nce.reshape(-1, n).mean(dim=1),
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
        new_state = TrainState(params=params, opt_state=opt_state,
                               curriculum=curriculum, step=state.step + 1,
                               generator=state.generator)
        return new_state, metrics

    return step


def make_fused_step(corpus, step_fn, controller, loss: str = "pair",
                    n_neg_per_example: int = 1):
    """fused(state, pair_idx) = difficulty -> sample negatives -> gather
    prompts -> step, all on the corpus's device (step.py:362-408). The
    negatives are drawn with ``state.generator``."""
    if loss != "lce":
        raise NotImplementedError(
            f"loss={loss!r} is not ported yet (ROADMAP.md slice C)")
    default_corpus = corpus

    def fused(state: TrainState, pair_idx: torch.Tensor, corpus=None):
        corpus = default_corpus if corpus is None else corpus
        difficulty = controller.difficulty(state.curriculum)
        batch = corpus.lce_batch(state.generator, pair_idx, difficulty,
                                 n_neg_per_example)
        return step_fn(state, batch)

    return fused


def make_meta_train_step(*args, **kwargs):
    """The bilevel meta-weight step (StdWrapper / NewWrapper)."""
    raise NotImplementedError(
        "make_meta_train_step is not ported yet (ROADMAP.md slice C)")

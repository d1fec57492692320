"""Distillation train steps: the port of distill/train.py.

- MarginMSE (reference distill/train_t5.py:52-70 + loss.py): student = monoT5
  log P(true) per prompt; loss = mean over teachers of MSE between student
  and teacher (pos - neg) margins.
- Baseline CE (reference distill/train_baseline.py): plain seq2seq CE on the
  alternating true/false labels.

One teacher-forced forward over the batch's interleaved prompts, its
backward by autograd over every parameter leaf, then the optimizer, as
``jax.value_and_grad`` + ``tx.update`` + ``optax.apply_updates`` run it.
The batch moves to the parameters' device. With ``model_cfg.flash_v3`` the
encoder's self-attention takes the fused block (K3 forward, K4 backward;
``ops/flash_v3.py``) wherever ``models/t5.py`` routes it there; the
decoder's label positions stay on the dense path.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.monot5 import relevance_log_probs
from pacednegatives_tpu_torch.ops.losses import margin_mse, token_ce
from pacednegatives_tpu_torch.optim import apply_updates, tree_leaves
from pacednegatives_tpu_torch.parallel.mesh import refuse_tensor_parallel


class DistillState(NamedTuple):
    params: Any     # nested dict of fp32 master weights
    opt_state: Any  # the optimizer's (optim.py) state
    step: int


def init_distill_state(params, tx) -> DistillState:
    return DistillState(params=params, opt_state=tx.init(params), step=0)


def make_distill_step(
    model_cfg: t5.T5Config,
    tx,
    objective: str = "margin_mse",  # "margin_mse" | "ce"
    rel_id: int = 3,
    nrel_id: int = 4,
):
    """step(state, batch) -> (state, {"loss"}); ``batch`` holds ids, mask,
    labels (2B, ...) and, for MarginMSE, teachers (2B, T), as tensors or
    numpy arrays (``distill.loader.TeacherBatcher.get_batch``)."""
    if objective not in ("margin_mse", "ce"):
        raise ValueError(
            f"objective must be 'margin_mse' or 'ce', got {objective!r}")
    refuse_tensor_parallel("make_distill_step")

    def step(state: DistillState, batch) -> tuple[DistillState, dict]:
        refuse_tensor_parallel("make_distill_step")
        device = tree_leaves(state.params)[0].device
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        flat = {k: v.detach().requires_grad_(True)
                for k, v in t5.flatten_params(state.params).items()}
        with torch.enable_grad():
            logits = t5.forward_logits(t5.unflatten_params(flat), model_cfg,
                                       b["ids"], b["labels"], b["mask"])
            if objective == "margin_mse":
                student = relevance_log_probs(logits[:, 0, :], rel_id,
                                              nrel_id)
                loss = margin_mse(student, b["teachers"])
            else:
                loss = token_ce(logits, b["labels"]).mean()
            grads = torch.autograd.grad(loss, list(flat.values()),
                                        allow_unused=True)
        grads = t5.unflatten_params({
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(flat.items(), grads)})
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return (DistillState(params, opt_state, state.step + 1),
                {"loss": loss.detach()})

    return step

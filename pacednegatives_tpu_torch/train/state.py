"""Training state and optimizer: the port of train/state.py.

AdamW + the HF linear warmup-decay schedule, with optional global-norm
clipping (optax's arithmetic, see optim.py), and the JAX package's moment
variants: fp32, a bf16 first moment, or the factored second moment with a
bf16 first moment; ``grad_accum_steps > 1`` wraps it in MultiSteps.
Defaults match the legacy transformers.AdamW every reference trainer
imports: eps 1e-6, weight decay 0.0.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.eta import linear_warmup_decay
from pacednegatives_tpu_torch.optim import (
    Adam,
    FactoredAdam,
    MultiSteps,
    tree_leaves,
)


class TrainState(NamedTuple):
    params: Any            # nested dict of fp32 master weights
    opt_state: Any         # the optimizer's (optim.py) state
    curriculum: Any        # the controller's state
    step: int
    generator: torch.Generator  # negative sampling, on the params' device
    # the dropout masks' seeds, one a microbatch, drawn on the host
    dropout_generator: torch.Generator


def make_optimizer(
    lr: float,
    total_steps: int,
    warmup_steps: int | None = None,
    weight_decay: float = 0.0,
    eps: float = 1e-6,
    grad_clip: float | None = 1.0,
    grad_accum_steps: int = 1,
    moments: str = "fp32",
):
    """AdamW + linear warmup-decay (+ global-norm clipping), as the JAX
    package's ``make_optimizer`` builds it in optax: ``moments`` "fp32"
    (exact AdamW), "bf16_mu" (AdamW with a bf16 first moment) or
    "factored" (``FactoredAdam``); ``grad_accum_steps = k > 1`` wraps it in
    ``MultiSteps``, whose schedule counts applied updates (total and warmup
    divided by k)."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 100, 1)
    if grad_accum_steps > 1:
        total_steps = max(total_steps // grad_accum_steps, 1)
        warmup_steps = max(warmup_steps // grad_accum_steps, 1)
    if moments not in ("fp32", "bf16_mu", "factored"):
        raise ValueError(
            f"moments must be 'fp32', 'bf16_mu', or 'factored', got {moments!r}"
        )
    schedule = linear_warmup_decay(lr, warmup_steps, total_steps)
    if moments == "factored":
        tx = FactoredAdam(schedule, eps=eps, weight_decay=weight_decay,
                          clip_norm=grad_clip)
    else:
        tx = Adam(schedule, eps=eps, weight_decay=weight_decay,
                  clip_norm=grad_clip,
                  mu_dtype=(torch.bfloat16 if moments == "bf16_mu"
                            else torch.float32))
    if grad_accum_steps > 1:
        tx = MultiSteps(tx, grad_accum_steps)
    return tx


def init_train_state(params: Any, tx, curriculum_state: Any,
                     seed: int = 42) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        curriculum=curriculum_state,
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
        dropout_generator=torch.Generator().manual_seed(seed),
    )

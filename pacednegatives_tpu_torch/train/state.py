"""Training state and optimizer: the port of train/state.py.

AdamW + the HF linear warmup-decay schedule, with optional global-norm
clipping (optax's arithmetic, see optim.py), fp32 moments. Defaults match
the legacy transformers.AdamW every reference trainer imports: eps 1e-6,
weight decay 0.0.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.eta import linear_warmup_decay
from pacednegatives_tpu_torch.optim import Adam, AdamState, tree_leaves


class TrainState(NamedTuple):
    params: Any            # nested dict of fp32 master weights
    opt_state: AdamState
    curriculum: Any        # the controller's state
    step: int
    generator: torch.Generator  # negative sampling, on the params' device


def make_optimizer(
    lr: float,
    total_steps: int,
    warmup_steps: int | None = None,
    weight_decay: float = 0.0,
    eps: float = 1e-6,
    grad_clip: float | None = 1.0,
    grad_accum_steps: int = 1,
    moments: str = "fp32",
) -> Adam:
    """AdamW + linear warmup-decay (+ global-norm clipping) with fp32
    moments, as ``make_optimizer(moments="fp32")`` builds it in optax."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 100, 1)
    if moments not in ("fp32", "bf16_mu", "factored"):
        raise ValueError(
            f"moments must be 'fp32', 'bf16_mu', or 'factored', got {moments!r}"
        )
    if moments != "fp32":
        raise NotImplementedError(
            f"moments={moments!r} is not ported yet (ROADMAP.md slice T2); "
            "use 'fp32'"
        )
    if grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 (optax.MultiSteps) is not ported yet "
            "(ROADMAP.md slice T2); use microbatches for accumulation "
            "inside one step"
        )
    return Adam(linear_warmup_decay(lr, warmup_steps, total_steps), eps=eps,
                weight_decay=weight_decay, clip_norm=grad_clip)


def init_train_state(params: Any, tx: Adam, curriculum_state: Any,
                     seed: int = 42) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        curriculum=curriculum_state,
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
    )

"""Per-step training signals for the pacing controllers: the port of
curriculum/base.py. A controller is ``init(device)``, ``difficulty(state)``
and ``update(state, signals)`` over a NamedTuple state of tensors on the
device (``metrics(state)`` gives the scalars to log), so the feedback loop
never waits for the host."""

from __future__ import annotations

from typing import Any, NamedTuple, Protocol

import numpy as np
import torch


class StepSignals(NamedTuple):
    """Per-step signals produced by the train step.

    pce / nce: positive / negative CE: per label TOKEN, (B*L_label,), for
        the pair curricula (the reference flattens logits to (B*L, V)
        before CrossEntropyLoss, so eta weighting runs over tokens,
        old/eta_bound.py:69-78); per example, (B,), for LCE (nce averaged
        over each example's n negatives).
    ce: the combined CE the self-paced weights act on: (pce + nce) / 2 in
        the eta wrapper (old/eta_bound.py:73-76), pce + agg(nce) for LCE.
    success: (B,) float 0/1, P_true(pos) > P_true(first negative) per
        example (old/levels.py:35-39).
    """

    pce: torch.Tensor
    nce: torch.Tensor
    ce: torch.Tensor
    success: torch.Tensor


class Controller(Protocol):
    def init(self, device: torch.device | str = "cpu") -> Any: ...

    def difficulty(self, state: Any) -> torch.Tensor: ...

    def update(self, state: Any, signals: StepSignals) -> Any: ...

    def metrics(self, state: Any) -> dict[str, torch.Tensor]:
        """Scalars to log each step (eta, difficulty, ...)."""
        ...


def f32(x: float, device) -> torch.Tensor:
    """A Python number as an fp32 scalar tensor on ``device``: rounded to
    fp32 as JAX rounds a weakly typed Python number, and a tensor operand,
    so that a division by it is a true division on every device (CUDA
    divides by a Python scalar as a product with its reciprocal)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` as JAX computes it: ``jnp.mean`` is a jitted function,
    and XLA rewrites its division by the count (a constant) as a product
    with the count's fp32 reciprocal."""
    return x.sum() * float(np.float32(1.0) / np.float32(x.numel()))

"""Per-step training signals for the pacing controllers: the port of
curriculum/base.py. A controller is ``init()``, ``difficulty(state)`` and
``update(state, signals)`` over its own state, all on the device."""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepSignals(NamedTuple):
    """pce / nce: positive / negative CE, per example (B,) for LCE (nce
    averaged over each example's n negatives); ce: the combined CE the
    self-paced weights act on (pce + agg(nce) for LCE); success: (B,) float
    0/1, P_true(pos) > P_true(first negative)."""

    pce: torch.Tensor
    nce: torch.Tensor
    ce: torch.Tensor
    success: torch.Tensor

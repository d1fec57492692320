"""Pacing controllers (the port of curriculum/): the learnable self-paced
threshold eta, both kinds. Interp, level, contrast and meta are ROADMAP
slice C."""

from pacednegatives_tpu_torch.curriculum.base import StepSignals
from pacednegatives_tpu_torch.curriculum.eta import (
    EtaController,
    EtaState,
    linear_warmup_decay,
    milestone_decay,
)

__all__ = [
    "EtaController",
    "EtaState",
    "StepSignals",
    "linear_warmup_decay",
    "milestone_decay",
]

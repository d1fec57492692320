"""Pacing controllers (the port of curriculum/): fixed interpolation,
success-rate levels, the learnable self-paced threshold eta (both kinds),
eta with level bumps (contrast), and the bilevel meta-weight table."""

from pacednegatives_tpu_torch.curriculum.base import Controller, StepSignals
from pacednegatives_tpu_torch.curriculum.contrast import (
    ContrastController,
    ContrastState,
)
from pacednegatives_tpu_torch.curriculum.eta import (
    EtaController,
    EtaState,
    linear_warmup_decay,
    milestone_decay,
)
from pacednegatives_tpu_torch.curriculum.interp import (
    InterpController,
    InterpState,
)
from pacednegatives_tpu_torch.curriculum.level import (
    LevelController,
    LevelState,
)
from pacednegatives_tpu_torch.curriculum.meta import (
    MetaState,
    MetaWeightTable,
)

CONTROLLERS = {
    "interp": InterpController,
    "level": LevelController,
    "eta": EtaController,
    "contrast": ContrastController,
}

__all__ = [
    "CONTROLLERS",
    "ContrastController",
    "ContrastState",
    "Controller",
    "EtaController",
    "EtaState",
    "InterpController",
    "InterpState",
    "LevelController",
    "LevelState",
    "MetaState",
    "MetaWeightTable",
    "StepSignals",
    "linear_warmup_decay",
    "milestone_decay",
]

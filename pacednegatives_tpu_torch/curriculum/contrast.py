"""Learnable eta and success-rate difficulty bumps: the port of
curriculum/contrast.py.

MetaContrastWrapper (old/meta_contrast copy.py:22-178): eta is learned on
the self-paced objective as ``EtaController`` learns it, while the
difficulty is a ``LevelController`` state bumped by 1/n_neg whenever the
windowed rate of ``ce / ce_scale < eta`` (the post-update eta of the same
step) clears the threshold; unlike eta's controller, the difficulty does
not track eta. For the pair curricula the rate runs over label tokens, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals
from pacednegatives_tpu_torch.curriculum.eta import EtaController, EtaState
from pacednegatives_tpu_torch.curriculum.level import (
    LevelController,
    LevelState,
)


class ContrastState(NamedTuple):
    eta: EtaState
    level: LevelState


@dataclasses.dataclass(frozen=True)
class ContrastController:
    """EtaController for the weight threshold + LevelController for pacing."""

    eta0: float = 0.5
    meta_lr: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 100_000
    eta_min: float = 1e-10
    eta_max: float = 1.0
    n_neg: int = 1000
    threshold: float = 0.5
    rate_check: int = 1000
    ce_scale: float = 1.0
    milestones: tuple = ()

    def _eta(self) -> EtaController:
        return EtaController(
            eta0=self.eta0, meta_lr=self.meta_lr,
            warmup_steps=self.warmup_steps, total_steps=self.total_steps,
            eta_min=self.eta_min, eta_max=self.eta_max,
            ce_scale=self.ce_scale, milestones=self.milestones,
        )

    def _level(self) -> LevelController:
        return LevelController(n_neg=self.n_neg, threshold=self.threshold,
                               check_every=self.rate_check)

    def init(self, device: torch.device | str = "cpu") -> ContrastState:
        return ContrastState(eta=self._eta().init(device),
                             level=self._level().init(device))

    def difficulty(self, state: ContrastState) -> torch.Tensor:
        return state.level.difficulty

    def update(self, state: ContrastState,
               signals: StepSignals) -> ContrastState:
        # eta first, then the level bump driven by the ce < (new) eta rate
        # (old/meta_contrast copy.py:63-64,117,163-170), computed as
        # EtaController.success_rate computes it: the logged success_rate
        # is the rate each window accumulates
        eta_ctrl = self._eta()
        eta = eta_ctrl.update(state.eta, signals)
        below = eta_ctrl.below(eta, signals)
        return ContrastState(
            eta=eta,
            level=self._level().update(state.level,
                                       signals._replace(success=below)),
        )

    def meta_loss(self, state: ContrastState,
                  signals: StepSignals) -> torch.Tensor:
        return self._eta().meta_loss(state.eta, signals)

    def success_rate(self, state: ContrastState,
                     signals: StepSignals) -> torch.Tensor:
        return self._eta().success_rate(state.eta, signals)

    def metrics(self, state: ContrastState) -> dict[str, torch.Tensor]:
        return {
            "eta": state.eta.eta,
            "difficulty": state.level.difficulty,
            **{k: v for k, v in self._level().metrics(state.level).items()
               if k != "difficulty"},
        }

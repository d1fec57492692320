"""Learnable self-paced threshold eta: the port of curriculum/eta.py.

kind="eta", objective="self_paced" (EtaWrapper): eta minimises
mean(pce*v) + mean(nce*v) - sum(v), v = EtaWeights(ce), by Adam.
kind="lce", objective="weighted_ce" (LCEModel): eta minimises mean(v * ce),
v = LCEWeights(ce), by AdamW (eps 1e-6, weight decay 0.0).

The gradient wrt eta is ``torch.autograd.grad`` of the same objective over
the step's CE values (detached), so no extra model forward runs. Both
optimizers and the schedules follow optax's arithmetic (optim.py). See the
JAX module's docstring for ``ce_scale`` and the difficulty caps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals, f32, mean
from pacednegatives_tpu_torch.ops.losses import eta_weight, self_paced_objective
from pacednegatives_tpu_torch.optim import Adam, AdamState, apply_updates


class EtaState(NamedTuple):
    eta: torch.Tensor  # fp32 scalar
    opt_state: AdamState
    step: int


def linear_warmup_decay(peak_lr: float, warmup_steps: int, total_steps: int):
    """HF get_linear_schedule_with_warmup: linear 0 -> peak over warmup, then
    linear decay to 0 at total. The schedule maps a step to an fp32 value
    computed as the JAX schedule computes it (fp32 throughout)."""
    warmup_steps = max(warmup_steps, 1)
    f = np.float32

    def schedule(step) -> np.float32:
        s = f(step)
        warm = s / f(warmup_steps)
        decay = max(f(0.0), (f(total_steps) - s)
                    / f(max(total_steps - warmup_steps, 1)))
        return f(peak_lr) * (warm if s < warmup_steps else decay)

    return schedule


def milestone_decay(base_schedule, milestones: dict[int, float]):
    """Multiply a schedule by a factor from each milestone step onward."""

    def schedule(step) -> np.float32:
        lr = base_schedule(step)
        for at, factor in sorted(milestones.items()):
            lr = lr * np.float32(factor if step >= at else 1.0)
        return lr

    return schedule


@dataclasses.dataclass(frozen=True)
class EtaController:
    eta0: float = 0.5
    meta_lr: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 100_000
    kind: str = "eta"  # weight function: "eta" | "lce"
    objective: str = "self_paced"  # "self_paced" | "weighted_ce"
    eta_min: float = 1e-10
    eta_max: float = 1.0
    clamp: bool = True
    optimizer: str = "adam"  # "adam" (EtaWrapper) | "adamw" (LCEModel)
    ce_scale: float = 1.0
    milestones: tuple = ()

    def _tx(self) -> Adam:
        schedule = linear_warmup_decay(
            self.meta_lr, self.warmup_steps, self.total_steps
        )
        if self.milestones:
            schedule = milestone_decay(schedule, dict(self.milestones))
        if self.optimizer == "adamw":
            # the legacy transformers.AdamW the reference imports
            # (lceT5.py:5,171): eps=1e-6, weight_decay=0.0
            return Adam(schedule, eps=1e-6, weight_decay=0.0)
        return Adam(schedule)  # optax.adam: eps 1e-8

    def init(self, device: torch.device | str = "cpu") -> EtaState:
        eta = torch.tensor(self.eta0, dtype=torch.float32, device=device)
        return EtaState(eta=eta, opt_state=self._tx().init(eta), step=0)

    def difficulty(self, state: EtaState) -> torch.Tensor:
        if self.kind == "eta":
            # EtaWrapper starts at difficulty 0 and follows eta after the
            # first step (old/eta_bound.py:125,164)
            if state.step == 0:
                return torch.zeros_like(state.eta)
            return state.eta.clamp(0.0, 1.0)
        # LCE: ChangeDifficulty's cap, at the fp32-safe 1 - 1e-6
        return state.eta.clamp(0.0, 1.0 - 1e-6)

    def _objective(self, eta: torch.Tensor, signals: StepSignals) -> torch.Tensor:
        s = 1.0 / self.ce_scale
        v = eta_weight(signals.ce * s, eta, self.kind)
        if self.objective == "self_paced":
            return self_paced_objective(signals.pce * s, signals.nce * s, v)
        return (v * signals.ce * s).mean()

    def update(self, state: EtaState, signals: StepSignals) -> EtaState:
        signals = StepSignals(*(t.detach() for t in signals))
        with torch.enable_grad():
            eta = state.eta.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self._objective(eta, signals), eta)
        tx = self._tx()
        updates, opt_state = tx.update(grad, state.opt_state, state.eta)
        eta = apply_updates(state.eta, updates)
        if self.clamp:
            eta = eta.clamp(self.eta_min, self.eta_max)
        return EtaState(eta=eta, opt_state=opt_state, step=state.step + 1)

    def meta_loss(self, state: EtaState, signals: StepSignals) -> torch.Tensor:
        return self._objective(state.eta, signals).detach()

    def below(self, state: EtaState, signals: StepSignals) -> torch.Tensor:
        """1.0 where the scaled CE is below eta, else 0.0 (a true division
        by ``ce_scale`` on every device)."""
        scaled = signals.ce.detach() / f32(self.ce_scale, state.eta.device)
        return (scaled < state.eta).float()

    def success_rate(self, state: EtaState, signals: StepSignals) -> torch.Tensor:
        """Fraction of examples whose (scaled) CE is below the current eta
        (old/eta_bound.py:57-58, against the post-update eta)."""
        return mean(self.below(state, signals))

    def metrics(self, state: EtaState) -> dict[str, torch.Tensor]:
        return {"eta": state.eta, "difficulty": self.difficulty(state)}

"""Heuristic-level pacing: the port of curriculum/level.py.

LevelWrapper (old/levels.py:61-98): every ``check_every`` steps, if the
mean success rate accumulated since the last check exceeds ``threshold``,
difficulty += 1/n_neg (capped at 1.0) and the accumulator resets. The
update runs after each step, so the k-th check sees exactly the k-th
window of rates (the JAX module's docstring has the reference's order).

The state is four scalars on the device (difficulty and the rate sum in
fp32, the counters int32), updated with ``torch.where`` so that no step
waits for the host. Each step's rate is ``jnp.mean``'s arithmetic
(``base.mean``), and every constant an fp32 tensor, as JAX rounds a
weakly typed Python number: the bump compares and adds in fp32 as the JAX
controller does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals, f32, mean


class LevelState(NamedTuple):
    difficulty: torch.Tensor  # fp32 scalar
    success_sum: torch.Tensor  # fp32 scalar
    success_count: torch.Tensor  # int32 scalar
    step: torch.Tensor  # int32 scalar


@dataclasses.dataclass(frozen=True)
class LevelController:
    n_neg: int
    threshold: float = 0.5
    check_every: int = 1000
    start: float = 0.0

    def init(self, device: torch.device | str = "cpu") -> LevelState:
        zero = lambda dt: torch.zeros((), dtype=dt, device=device)
        return LevelState(
            difficulty=f32(self.start, device),
            success_sum=zero(torch.float32),
            success_count=zero(torch.int32),
            step=zero(torch.int32),
        )

    def difficulty(self, state: LevelState) -> torch.Tensor:
        return state.difficulty

    def update(self, state: LevelState, signals: StepSignals) -> LevelState:
        dev = state.difficulty.device
        s_sum = state.success_sum + mean(signals.success.detach())
        s_cnt = state.success_count + 1
        step = state.step + 1

        check = (step % self.check_every == 0) & (s_cnt > 0)
        rate = s_sum / s_cnt.clamp_min(1).float()
        bump = check & (rate > f32(self.threshold, dev))

        difficulty = torch.where(
            bump,
            (state.difficulty + f32(1.0 / self.n_neg, dev)).clamp_max(1.0),
            state.difficulty,
        )
        s_sum = torch.where(check, f32(0.0, dev), s_sum)
        s_cnt = torch.where(check, torch.zeros_like(s_cnt), s_cnt)
        return LevelState(difficulty, s_sum, s_cnt, step)

    def metrics(self, state: LevelState) -> dict[str, torch.Tensor]:
        # the windowed accumulator (reset at each check), named apart from
        # the step's per-batch success_rate
        rate = state.success_sum / state.success_count.clamp_min(1).float()
        return {"difficulty": state.difficulty, "success_rate_window": rate}

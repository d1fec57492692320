"""Fixed-schedule (interpolated) pacing: the port of curriculum/interp.py.

InterpWrapper (old/interp.py:10-18,84): difficulty is a linear ramp from
``start`` to ``end`` over ``num_steps`` examples (the reference passes
``i * batch_size``), capped at ``end`` afterwards; no feedback from the
training signals. The difficulty is computed in fp32 in the JAX module's
order of operations, each constant rounded to fp32 as JAX rounds a weakly
typed Python number, the division a true division on every device:
``difficulty_to_index`` floors ``difficulty * (P - 1)``, so one ulp can
pick another negative. (Inside a jitted step XLA may rewrite that order:
a division by a constant as a product with its reciprocal, a product and
a sum as one FMA on the CPU. The port keeps the module's order.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.base import StepSignals, f32


class InterpState(NamedTuple):
    step: torch.Tensor  # int32 scalar


@dataclasses.dataclass(frozen=True)
class InterpController:
    start: float = 0.0
    end: float = 1.0
    num_steps: int = 10_000  # in examples, to match reference i*batch_size
    batch_size: int = 1

    def init(self, device: torch.device | str = "cpu") -> InterpState:
        return InterpState(step=torch.zeros((), dtype=torch.int32,
                                            device=device))

    def difficulty(self, state: InterpState) -> torch.Tensor:
        dev = state.step.device
        pos = (state.step * self.batch_size).float()
        frac = pos / f32(max(self.num_steps, 1), dev)
        val = f32(self.start, dev) + f32(self.end - self.start, dev) * frac
        lo, hi = sorted((self.start, self.end))
        return val.clamp(lo, hi)

    def update(self, state: InterpState, signals: StepSignals) -> InterpState:
        del signals
        return InterpState(step=state.step + 1)

    def metrics(self, state: InterpState) -> dict[str, torch.Tensor]:
        return {"difficulty": self.difficulty(state)}

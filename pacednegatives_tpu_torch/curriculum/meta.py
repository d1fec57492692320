"""Bilevel meta-learned per-example weight table: the port of
curriculum/meta.py.

``Weights`` (weights.py:80-94) with StdWrapper / NewWrapper
(pairwrapper.py:91-284): a (num_batches, batch_size) fp32 table of example
weights on the device, initialised to 1. Each step the weights v of batch
j take one SGD step on sum(pce*v)/B + sum(nce*v)/B - sum(v), on the frozen
model (NewWrapper, ``cheap_update``'s closed form) or through a virtual
model update (StdWrapper, ``train/step.py`` ``make_meta_train_step``), and
are stored through a sigmoid (weights.py:86-88). Row indices are host
ints: the runner walks the table in order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class MetaState(NamedTuple):
    table: torch.Tensor  # (num_batches, batch_size) fp32


@dataclasses.dataclass(frozen=True)
class MetaWeightTable:
    num_batches: int
    batch_size: int

    def init(self, device: torch.device | str = "cpu") -> MetaState:
        return MetaState(table=torch.ones(
            (self.num_batches, self.batch_size), dtype=torch.float32,
            device=device))

    def lookup(self, state: MetaState, j: int) -> torch.Tensor:
        """Weights v for batch j: (batch_size,)."""
        return state.table[j]

    def store(self, state: MetaState, j: int, raw_v: torch.Tensor) -> MetaState:
        """Store sigmoid(raw_v) at row j (the reference's set_weight applies
        the sigmoid, weights.py:86-88), in a new table."""
        table = state.table.clone()
        table[j] = torch.sigmoid(raw_v.detach())
        return MetaState(table=table)

    @staticmethod
    def cheap_update(v: torch.Tensor, pce: torch.Tensor, nce: torch.Tensor,
                     lr: torch.Tensor) -> torch.Tensor:
        """NewWrapper's update (pairwrapper.py:219-239): one SGD step on the
        frozen-model weighted objective, whose gradient is
        d/dv [sum(pce*v)/B + sum(nce*v)/B - sum(v)] = (pce+nce)/B - 1."""
        B = v.shape[0]
        grad = (pce + nce) / B - 1.0
        return v - lr * grad

    def metrics(self, state: MetaState, j: int) -> dict[str, torch.Tensor]:
        return {"avg_weight": self.lookup(state, j).mean()}

"""What a driver is given and what it hands back.

A driver (``benchmarks/drivers/<name>.py``, named by the traffic file's
``driver``) has ``run(cell: Cell) -> Outcome``. It builds the program's
objects from the configuration and the traffic mix, warms up, measures,
and checks the timed path's outputs against the plain reference. It
reaches the model's architecture only through ``cell.arch``'s hooks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from benchmarks.common.tracing import Counters


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict  # benchmarks/configs/<config>.json
    arch: Any  # benchmarks/arch/<architectures[0]>.py: the model's hooks
    traffic: dict  # benchmarks/traffic/<traffic>.json
    limits: dict  # benchmarks/limits/<workload>.json: {number: limit}
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float  # perf_counter at the harness's start
    out_dir: str  # scratch for the trace, inside the checkout
    # a planted fault, for the harness's own tests and the calibration;
    # the command line never sets it
    fault: Optional[str] = None


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # {metric: value}, host clock, the window's
    setup_s: float
    memory_peak_bytes: int
    # {number: value} compared with cell.limits
    checks: dict = dataclasses.field(default_factory=dict)
    # the traced run's reduced trace and counters (tracing.reduce)
    trace: Optional[dict] = None
    counters: Optional[Counters] = None
    extra: dict = dataclasses.field(default_factory=dict)

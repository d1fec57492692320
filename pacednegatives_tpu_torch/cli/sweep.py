"""Sweep runner: config products in-process (the port of cli/sweep.py).

Replaces the reference's grid_*.py scripts, which paste flags into
subprocess commands (grid_eta.py:10-15). Grids are JSON: a base config plus
lists per swept key; each combination runs in sequence (a crash in one
config is caught and recorded, preserving the reference's crash-isolation
property without process overhead).

Built-in named grids mirror the reference files:
  eta       <- grid_eta.py       (eta0 x meta_lr)
  threshold <- grid_threshold.py (success_threshold x heuristic_step_check)
  interp    <- grid_interp.py    (start x end x frac)
  var       <- grid_var.py       (var x n, eta0 = -log(.5)*.5)

Usage:
  python -m pacednegatives_tpu_torch.cli.sweep --grid eta --total_steps 3200 ...
  python -m pacednegatives_tpu_torch.cli.sweep --grid_file my_grid.json

``--device`` (default cuda; there is no fallback to the CPU, and a missing
card raises before the first run) goes to every run, as in ``cli.train``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import traceback

from pacednegatives_tpu_torch.train.runner import RunConfig, _device, run
from pacednegatives_tpu_torch.utils.config import apply_overrides, parse_cli

GRIDS: dict[str, dict] = {
    # grid_eta.py:6-8
    "eta": {
        "curriculum": ["eta"],
        "eta0": [-math.log(0.5) * 0.5, 0.1, 0.2, 0.3, 0.4, 0.5],
        "meta_lr": [1e-4, 1e-3, 1e-2],
    },
    # grid_threshold.py:5-7
    "threshold": {
        "curriculum": ["level"],
        "success_threshold": [0.0, 0.25, 0.5, 0.75, 1.0],
        "heuristic_step_check": [100, 1000, 10000, 100000000000],
    },
    # grid_interp.py:5-8
    "interp": {
        "curriculum": ["interp"],
        "start_difficulty": [0.0, 0.1, 0.25, 0.5],
        "max_difficulty": [0.6, 0.75, 0.9, 1.0],
        "frac_interpolate": [0.2, 0.3, 0.5],
    },
    # grid_var.py:6-8,22
    "var": {
        "curriculum": ["lce"],
        "eta0": [-math.log(0.5) * 0.5],
        "var": [0.01, 0.05, 0.1],
        "n": [4, 8],
    },
}


def expand(grid: dict) -> list[dict]:
    keys = list(grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*[grid[k] for k in keys])
    ]


def main(argv=None, device: str | None = None) -> list[dict]:
    overrides = parse_cli(argv)
    # checked once, before any run: crash isolation would record a missing
    # card in every config's row instead of raising
    device = _device(overrides.pop("device", None) or device or "cuda")
    grid_name = overrides.pop("grid", None)
    grid_file = overrides.pop("grid_file", None)
    if grid_file:
        with open(grid_file) as f:
            grid = json.load(f)
    elif grid_name:
        grid = GRIDS[grid_name]
    else:
        raise SystemExit("need --grid <name> or --grid_file <path>")

    base = apply_overrides(RunConfig(), overrides)
    results = []
    for i, combo in enumerate(expand(grid)):
        cfg = dataclasses.replace(
            base,
            **combo,
            out_dir=os.path.join(base.out_dir, f"cfg_{i}"),
        )
        rec: dict = {"config": combo, "out_dir": cfg.out_dir}
        try:
            rec.update(run(cfg, device=device))
        except Exception as e:  # crash isolation (grid_eta.py:15 parity)
            rec["error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        results.append(rec)
        print(json.dumps(rec))

    os.makedirs(base.out_dir, exist_ok=True)
    with open(os.path.join(base.out_dir, "sweep.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()

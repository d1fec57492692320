"""Training CLI: ``python -m pacednegatives_tpu_torch.cli.train --curriculum
lce --model base --flash_v3 true --fused_qkv true ...``.

The options are the fields of ``train.runner.RunConfig`` (the JAX CLI's),
plus ``--device`` (default cuda; there is no fallback to the CPU).
``--curriculum`` is one of interp, level, eta, contrast, lce, meta-cheap
and meta-std. The presets set it as the reference's entry points do:
``cli.train_lce`` (train_lce.py), ``cli.train_eta`` (train/eta.py),
``cli.train_level`` (train/level.py), ``cli.train_interp``
(train/interpolate.py) and ``cli.train_std`` (train/std.py, meta-std).
"""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.train.runner import RunConfig, run
from pacednegatives_tpu_torch.utils.config import apply_overrides, parse_cli


def main(preset: dict | None = None, argv=None, device: str | None = None) -> dict:
    overrides = parse_cli(argv)
    device = overrides.pop("device", None) or device or "cuda"
    cfg = apply_overrides(RunConfig(**(preset or {})), overrides)
    summary = run(cfg, device=device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

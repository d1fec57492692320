"""Host-sync audit of the benchmark's cells on the card.

    python3 scripts/torch_sync_audit.py [--cells a,b,...] [--seed N] \
        [--out benchmarks/_out/sync_audit.json]

Runs each cell's traced window (``benchmarks/run.py --trace 1``) with
``torch.cuda.set_sync_debug_mode("warn")`` on over the window alone, and
records every warning it raises (``warnings.simplefilter("always")``:
every sync, not one a line). A warning belongs to the port when its frame
lies in ``pacednegatives_tpu_torch/``. Beside the tally it prints the
port's own ``host_syncs`` counter (``utils.profiling.recorded()``) over
the same window: the two agree when every blocking read and every copy
that waits on the stream is counted. The cells' correctness checks are
skipped (the audit compares no outputs).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PORT = os.sep + "pacednegatives_tpu_torch" + os.sep
CELLS = ("monot5-base.lce-b64", "monot5-base.rerank-d1000",
         "monot5-base.lce-scored-c64", "monot5-large.lce-b32")


def audit(cell: str, seed: int) -> dict:
    import torch

    from benchmarks import run as harness
    from benchmarks.common import tracing

    caught: list = []
    orig_profile, orig_load = tracing.profile, harness.load_module

    def profile(warm, active, **kw):
        def audited():
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    active()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            caught.extend(got)

        return orig_profile(warm, audited, **kw)

    def load_module(path, name):
        mod = orig_load(path, name)
        if hasattr(mod, "check"):
            mod.check = lambda cell, *a, **k: dict.fromkeys(cell.limits, 0.0)
        return mod

    tracing.profile, harness.load_module = profile, load_module
    try:
        from pacednegatives_tpu_torch.utils import profiling

        if hasattr(profiling, "reset"):
            profiling.reset()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = harness.main(["--workload", cell, "--seed", str(seed),
                               "--seconds", "1", "--trace", "1"])
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        tracing.profile, harness.load_module = orig_profile, orig_load
    rec = profiling.recorded() if hasattr(profiling, "recorded") else None
    sync_msgs = [w for w in caught if "synchroniz" in str(w.message)]
    port = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        for w in sync_msgs if PORT in w.filename)
    other = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        for w in sync_msgs if PORT not in w.filename)
    spans = (collections.Counter(s["name"] for s in rec["spans"])
             if rec else {})
    return {
        "cell": cell, "rc": rc,
        "port_warnings": sum(port.values()),
        "host_syncs": rec["counts"].get("host_syncs") if rec else None,
        "port_sites": dict(port.most_common()),
        "other_sites": dict(other.most_common()),
        "other_warnings": [str(w.message)[:160] for w in caught
                           if w not in sync_msgs][:5],
        "steps": spans.get("pnt.step"),
        "requests": spans.get("pnt.rerank.request"),
        "counts": rec["counts"] if rec else None,
        "metrics": result.get("metrics"),
        "idle_gaps": result.get("breakdown", {}).get("idle_gaps"),
        "window_s": result.get("device", {}).get("window_s"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", default=str(ROOT / "benchmarks" / "_out"
                                          / "sync_audit.json"))
    args = ap.parse_args()
    out = []
    for cell in args.cells.split(","):
        r = audit(cell, args.seed)
        out.append(r)
        print(json.dumps({k: r[k] for k in (
            "cell", "rc", "port_warnings", "host_syncs", "steps",
            "requests", "port_sites", "other_sites")}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of a cell's correctness check are set from,
taken on the card at the cell's own size, many seeds in one process.

    python3 benchmarks/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out <file>]

For each seed it prints one JSON line with the check's numbers of a sound
run (``mode: sound``: set-up, the checked steps or a few requests, no
measured window to speak of), of the control (``mode: control``: the
reference computed in float8 put in the program's place), of the
program's own W8A8 path where the cell has one (``mode: int8_path``:
``scored.dtype = "int8"``, or the W8A8 Reranker), and of a planted fault
(``mode: half_batch``: the step trains on half the batch, the mean over
the rest). The benchmark's own runs never run this.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import run as harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    harness.fix_caches()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmarks.common.cell import Cell

    spec = harness.resolve(harness.ROOT, args.workload)
    driver = harness.load_module(spec.driver, spec.traffic["driver"])
    arch = harness.load_module(spec.arch, spec.arch.stem)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None

    def cell(seed, traffic=None, fault=None):
        return Cell(workload=args.workload, config=spec.config, arch=arch,
                    traffic=traffic or spec.traffic, limits=spec.limits,
                    seed=seed, seconds=args.seconds, trace=False,
                    device=torch.device("cuda", 0),
                    t_start=time.perf_counter(),
                    out_dir=str(harness.BENCH / "_out"), fault=fault)

    def emit(mode, seed, checks, t0):
        line = json.dumps({"workload": args.workload, "mode": mode,
                           "seed": seed, "seconds": time.perf_counter() - t0,
                           "checks": checks})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        emit("sound", seed, driver.run(cell(seed)).checks, t0)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit("control", seed, driver.control(cell(seed)), t0)
        # the program's own W8A8 path, for the record
        t0 = time.perf_counter()
        tr = copy.deepcopy(spec.traffic)
        if tr["driver"] == "rerank":
            tr["int8"] = True
        elif tr.get("scored"):
            tr["scored"]["dtype"] = "int8"
        else:
            continue
        emit("int8_path", seed, driver.run(cell(seed, tr)).checks, t0)
    for seed in seeds(args.fault_seeds):
        t0 = time.perf_counter()
        emit("half_batch", seed,
             driver.run(cell(seed, fault="half_batch")).checks, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

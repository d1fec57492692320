"""Run one cell of the benchmark once.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``benchmarks/configs/<config>.json``) and a traffic mix
(``benchmarks/traffic/<traffic>.json``), whose ``driver`` names the module
``benchmarks/drivers/<driver>.py`` that runs it; the configuration's
``architectures[0]`` names the module of the model's hooks,
``benchmarks/arch/<architecture>.py``; the limits of its correctness
check are ``benchmarks/limits/<workload>.json``. With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``benchmarks/metrics/<metric>.py``. The last line of standard output is
the result; the numbers compared with their limits are also the last
lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmarks"
sys.path.insert(0, str(ROOT))


def fix_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before the first CUDA call or compile reads it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(BENCH / "_cache" / sub)

# modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "pacednegatives_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "benchmarks._loaded." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, architecture's hooks, traffic,
    limits and metrics, found by name under ``root``."""
    manifest = load_json(root / "BENCHMARK.json")
    bench = root / "benchmarks"
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    config_file = next(c["file"] for c in manifest["configs"]
                       if c["name"] == w["config"])

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if applies(m) and m["moves"] in e2e_names]
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    config = load_json(root / config_file)
    return SimpleNamespace(
        entry=w, config=config,
        arch=bench / "arch" / f"{config['architectures'][0]}.py",
        traffic=traffic,
        limits=load_json(bench / "limits" / f"{workload}.json"),
        driver=bench / "drivers" / f"{traffic['driver']}.py",
        metrics=bench / "metrics", end_to_end=end_to_end,
        per_layer=per_layer)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, *, root: Path = ROOT, device=None, fault=None) -> int:
    """Run the cell; ``root``, ``device`` and ``fault`` are for the
    harness's own tests (another tree of cells, the CPU, a planted
    fault)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell_spec = resolve(Path(root), args.workload)
    if device is None:
        fix_caches()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chips = cell_spec.entry["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)

    from benchmarks.common.cell import Cell
    from benchmarks.common.flops import peak_flops

    arch = load_module(cell_spec.arch, cell_spec.arch.stem)
    cell = Cell(workload=args.workload, config=cell_spec.config, arch=arch,
                traffic=cell_spec.traffic, limits=cell_spec.limits,
                seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, t_start=T_START,
                out_dir=str(BENCH / "_out"), fault=fault)
    driver = load_module(cell_spec.driver, cell_spec.traffic["driver"])
    outcome = driver.run(cell)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded after the window: {found}",
              file=sys.stderr)
        return 3

    dev = (device_info(torch, chips) if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1})
    dev["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    metrics = {}
    if args.trace:
        sizes = arch.sizes(cell.config)
        ctx = SimpleNamespace(
            outcome=outcome, model=sizes,
            forward_flops=functools.partial(arch.forward_flops, sizes),
            peak_flops=peak_flops(dev["kind"]))
        for m in cell_spec.per_layer:
            reader = load_module(cell_spec.metrics / f"{m['name']}.py",
                                 m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = outcome.trace["busy_s"]
        dev["window_s"] = outcome.trace["window_s"]
    else:
        for m in cell_spec.end_to_end:
            value = (outcome.setup_s if m["name"] == "setup_s"
                     else outcome.end_to_end.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

    # the numbers with a limit are compared; the others are readings
    checks = {k: {"value": float(outcome.checks[k]), "limit": float(v)}
              for k, v in cell.limits.items()}
    readings = {k: v for k, v in outcome.checks.items()
                if k not in cell.limits}
    correct = (bool(checks) and outcome.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": dev}
    if args.trace:
        result["breakdown"] = outcome.trace["breakdown"]
        result["unattributed_kernels"] = outcome.trace["unattributed_kernels"]
    if device.type == "cuda":
        result["power"] = power_limit()
    result["checks"] = checks
    phases = outcome.extra.get("phases", {})
    print("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    print("not compared: " + ", ".join(f"{k} {v!r}"
                                       for k, v in readings.items()),
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Reproduce the rare CPU failures of the port's fp32 parity tests against
the JAX kernels (``test_k2a_plain_matches_jax[fp32-256-128]``,
``test_v3_backward_plain_matches_jax[64-64]``): torch's side moves, JAX's
does not.

    python3 scripts/torch_attention_bwd_parity_sweep.py [--runs 600]
        [--jobs 8] [--load 4] [--out runs/sweep]

Each run is a fresh process (``--child``) that computes K2a's plain
backward (``ops.flash.flash_attention_backward_plain``, fp32 q/k/v) on the
inputs of ``test_k2a_plain_matches_jax[fp32-256-128]`` (B 2, H 2, Lq 256,
Lk 128, dk 64), and apart from it the exponent of its p (s - m: a matmul
and adds) and exp of that. Each is compared bit for bit with the same
computation in this process after a warm-up. Runs take three variants in
turns: ``cold`` (the backward first, as a test does), ``cold_exp_first``
(exp of the exponent first, then the backward) and ``warm`` (first
``torch.exp`` over 2^20 elements, as the two parity test modules do at
import). ``--load`` busy processes (numpy matmuls on all cores) run
beside them: the fault shows under heavy load. One JSON line per run that
moved, as it ends (its variant, each result that moved with its largest
relative move, and the (b, h) slices and query rows of the first), then
one summary line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, LQ, LK, DK, SEED = 2, 2, 256, 128, 64, 256  # the parity test's case
NEG_INF = -1e30
VARIANTS = ("cold", "cold_exp_first", "warm")


def _inputs() -> dict:
    """The parity test's q, k, v, pos, key mask and g (its ``_case``)."""
    rng = np.random.default_rng(SEED)
    q = rng.standard_normal((B, H, LQ, DK)).astype(np.float32)
    k = rng.standard_normal((B, H, LK, DK)).astype(np.float32)
    v = rng.standard_normal((B, H, LK, DK)).astype(np.float32)
    pos = (rng.standard_normal((H, LQ, LK)) * 0.3).astype(np.float32)
    lens = rng.integers(LK // 2, LK + 1, size=B)
    lens[0] = LK
    key_mask = np.where(np.arange(LK)[None] < lens[:, None], 0.0,
                        NEG_INF).astype(np.float32)
    g = rng.standard_normal((B, H, LQ, DK)).astype(np.float32)
    return dict(q=q, k=k, v=v, pos=pos, key_mask=key_mask, g=g)


def _steps(torch, flash, t: dict, exp_first: bool) -> dict:
    """K2a's four outputs, and the exponent of its p and exp of that, in
    the order they ran."""
    s = torch.matmul(t["q"], t["k"].transpose(-1, -2))
    a = (s + t["pos"][None] + t["key_mask"][:, None, None, :]
         - t["m"][..., None])
    steps = {"exponent": a}
    if exp_first:
        steps["exp"] = torch.exp(a)
    out = flash.flash_attention_backward_plain(
        *(t[n] for n in ("q", "k", "v", "pos", "key_mask", "m", "l", "dcap",
                         "g")))
    steps.update(zip(("dq", "dk", "dv", "dpos"), out))
    if not exp_first:
        steps["exp"] = torch.exp(a)
    return steps


def child(path: str, variant: str) -> None:
    import torch

    if variant == "warm":
        torch.exp(torch.zeros(1 << 20))
    sys.path.insert(0, ROOT)
    from pacednegatives_tpu_torch.ops import flash

    ref = np.load(path)
    t = {n: torch.from_numpy(ref["in_" + n]) for n in (
        "q", "k", "v", "pos", "key_mask", "m", "l", "dcap", "g")}
    moved, first = {}, {}
    for name, x in _steps(torch, flash, t,
                          variant == "cold_exp_first").items():
        diff = np.abs(x.numpy() - ref[name])
        if diff.max() > 0:
            moved[name] = float((diff / np.maximum(np.abs(ref[name]),
                                                   1e-30)).max())
            if not first:
                where = np.argwhere(diff > 0)
                first = {"first": name, "elements": int(len(where)),
                         "b_h": sorted({(int(w[0]), int(w[1]))
                                        for w in where})
                         if diff.ndim == 4 else None,
                         "rows": [int(where[:, -2].min()),
                                  int(where[:, -2].max())]}
    print(json.dumps({"moved": moved, **first}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=600)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--load", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "sweep"))
    ap.add_argument("--child", default=None)
    ap.add_argument("--variant", default="cold", choices=VARIANTS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.variant)
        return 0

    import torch

    torch.exp(torch.zeros(1 << 20))
    sys.path.insert(0, ROOT)
    from pacednegatives_tpu_torch.ops import flash

    t = {n: torch.from_numpy(a) for n, a in _inputs().items()}
    s = (torch.matmul(t["q"], t["k"].transpose(-1, -2)) + t["pos"][None]
         + t["key_mask"][:, None, None, :])
    t["m"] = s.max(dim=-1).values
    e = torch.exp(s - t["m"][..., None])
    t["l"] = e.sum(dim=-1)
    t["dcap"] = (t["g"] * ((e / t["l"][..., None]) @ t["v"])).sum(dim=-1)
    ref = {name: x.numpy()
           for name, x in _steps(torch, flash, t, False).items()}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "reference.npz")
    np.savez(path, **ref, **{"in_" + n: x.numpy() for n, x in t.items()})

    load = [subprocess.Popen(
        [sys.executable, "-c", "import numpy as np; a = np.ones((1500, 1500),"
         " np.float32)\nwhile True: a @ a"], stdout=subprocess.DEVNULL)
        for _ in range(args.load)]

    def run(i: int) -> dict:
        variant = VARIANTS[i % len(VARIANTS)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", path,
             "--variant", variant], capture_output=True, text=True,
            timeout=600, check=False)
        line = (proc.stdout.strip().splitlines() or ["{}"])[-1]
        return {"variant": variant, "rc": proc.returncode,
                **json.loads(line)}

    results = []
    try:
        with ThreadPoolExecutor(args.jobs) as pool:
            for fut in as_completed([pool.submit(run, i)
                                     for i in range(args.runs)]):
                results.append(fut.result())
                if results[-1].get("moved") or results[-1]["rc"]:
                    print(json.dumps(results[-1]), flush=True)
    finally:
        for p in load:
            p.kill()
            p.wait()
    for variant in VARIANTS:
        rs = [r for r in results if r["variant"] == variant]
        print(json.dumps({"variant": variant, "runs": len(rs),
                          "failed": sum(1 for r in rs if r["rc"]),
                          "moved": sum(1 for r in rs if r.get("moved")),
                          "results_moved": sorted({
                              n for r in rs for n in r.get("moved") or {}})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

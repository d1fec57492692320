#!/usr/bin/env python3
"""Time the PyTorch port's attention-backward kernels on one NVIDIA GPU, for
one or more checkouts of the repo, in turns.

    python3 scripts/torch_attention_bwd_bench.py [ROOT ...] [--rounds N]
        [--cases k4_core,k2b]

Each ROOT (default: the checkout this script is in) is measured in a
process of its own with ROOT first on ``sys.path``, so the kernels of two
commits (or of a copy with parts of a kernel compiled out) compare on one
card: roots A B run as A B B A (``--rounds 2``). Cases, at the shapes the
training paths give the kernels, t5-base widths:

- ``k4_core``: ``attention_backward`` (K4's core) at (128, 12, 188, 64),
  q/k/v/g as views of fused (B, L, 3, H, dk) / (B, L, H, dk) buffers;
- ``k4_core_dk128``: the same at (32, 12, 512, 128), (B, H, L, dk) buffers;
- ``k2b``: ``flash_attention_backward_v2`` at (16, 12, 512, 64);
- ``k2a``: ``flash_attention_backward`` at (8, 12, 768, 64).

Per case: median CUDA-event ms per call (synchronised after each), per
call of 20 issued back to back, the host microseconds a call takes to
enqueue, each launched kernel's device time by torch.profiler (K2a's: the
g split, the dq pass, the dk/dv pass, the dq chunk and dpos group sums),
and the memory-efficient SDPA backward on the same inputs
(``aten._scaled_dot_product_efficient_attention_backward`` plus the bias
gradient's batch sum, as ``chip_smoke.py`` times it): bf16 operands for
K4's core and K2b, fp32 operands with the kernels' (out, m, l) for K2a,
with its error against K2a's plain version. One JSON line per (root,
case), after the card's name and power limit and a line of each K2b / K2a
case's bound (``chip_smoke.core_bwd_bound``, of this checkout: the same
function for every root).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {  # name: (B, H, Lq, Lk, dk)
    "k4_core": (128, 12, 188, 188, 64),
    "k4_core_dk128": (32, 12, 512, 512, 128),
    "k2b": (16, 12, 512, 512, 64),
    "k2a": (8, 12, 768, 768, 64),
}


def _time(torch, fn, calls=1, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _host_us(torch, fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def _kernel_times(torch, fn, calls=10):
    """Device microseconds per call of each CUDA kernel ``fn`` launches, by
    torch.profiler (None where the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key[:60]] = us / calls
    return out or None


def _library(torch, q, k, v, g, pos, km, dtype=None, stats=None):
    """The SDPA efficient backward and the bias gradient's batch sum, in
    ``dtype`` (default bf16); with ``stats`` = (out, m, l) the op's out and
    logsumexp are the kernels' (K2a's inputs) instead of its forward's."""
    dtype = dtype or torch.bfloat16
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    qc, kc, vc, gc = (t.to(dtype).contiguous() for t in (q, k, v, g))
    bias = torch.empty((B, H, Lq, -(-Lk // 8) * 8), dtype=dtype,
                       device="cuda")[..., :Lk]
    bias.copy_(pos[None] + km[:, None, None, :])
    ops = torch.ops.aten
    out, lse, seed, offset = ops._scaled_dot_product_efficient_attention(
        qc, kc, vc, bias, True, 0.0, False, scale=1.0)
    if stats is not None:
        out = stats[0].to(dtype).contiguous()
        lse = lse.clone()
        lse[..., :Lq] = stats[1] + torch.log(stats[2])

    def run():
        grads = ops._scaled_dot_product_efficient_attention_backward(
            gc, qc, kc, vc, bias, out, lse, seed, offset, 0.0,
            [True, True, True, True], False, scale=1.0)
        return (*grads[:3], grads[3].sum(dim=0))

    return run


def child(root: str, cases: list[str]) -> None:
    sys.path.insert(0, root)
    import torch

    from pacednegatives_tpu_torch.ops import flash

    assert flash.__file__.startswith(os.path.join(root, ""))
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    for name in cases:
        B, H, Lq, Lk, dk = CASES[name]
        if name == "k4_core":
            qkv = rnd(B, Lq, 3, H, dk).to(torch.bfloat16)
            q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
            gout = rnd(B, Lq, H, dk).to(torch.bfloat16).transpose(1, 2)
        else:
            q = rnd(B, H, Lq, dk).to(torch.bfloat16)
            k, v = (rnd(B, H, Lk, dk).to(torch.bfloat16) for _ in range(2))
            gout = rnd(B, H, Lq, dk)
            if name.startswith("k4"):
                gout = gout.to(torch.bfloat16)
        pos = (rnd(H, Lq, Lk) * 0.5).contiguous()
        lens = torch.randint(Lk // 2, Lk + 1, (B,), generator=g,
                             device="cuda")
        km = torch.where(torch.arange(Lk, device="cuda")[None]
                         < lens[:, None], 0.0, flash.NEG_INF).float()
        out, m, l = flash.flash_attention_forward(q, k, v, pos, km,
                                                  torch.float32)
        if name.startswith("k4"):
            fn = lambda: flash.attention_backward(q, k, v, gout, pos, km, m, l)
        else:
            dcap = (gout * out).sum(dim=-1)
            kern = (flash.flash_attention_backward_v2 if name == "k2b"
                    else flash.flash_attention_backward)
            fn = lambda: kern(q, k, v, pos, km, m, l, dcap, gout)
        row = dict(case=name, shape=[B, H, Lq, Lk, dk],
                   ms=_time(torch, fn), ms_back_to_back=_time(
                       torch, fn, calls=20, reps=5),
                   host_us=_host_us(torch, fn))
        if name == "k2a":
            lib = _library(torch, q, k, v, gout, pos, km, torch.float32,
                           stats=(out, m, l))
            ref = flash.flash_attention_backward_plain(q, k, v, pos, km, m,
                                                       l, dcap, gout)
            row.update(library_err_rel={
                n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("dq", "dk", "dv", "dpos"), lib(), ref)})
            del ref
        else:
            lib = _library(torch, q, k, v, gout, pos, km)
        row.update(library_ms=_time(torch, lib),
                   library_ms_back_to_back=_time(torch, lib, calls=20,
                                                 reps=5))
        row["kernels_us"] = _kernel_times(torch, fn)
        print(json.dumps({"root": root, **row}), flush=True)
        del fn, lib
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated subset of " + ", ".join(CASES))
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child), args.cases.split(","))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    sys.path.insert(0, HERE)
    from chip_smoke import core_bwd_bound

    for name in args.cases.split(","):
        if name in ("k2b", "k2a"):
            print(json.dumps({"case": name, "shape": list(CASES[name]),
                              **core_bwd_bound(name, *CASES[name])}),
                  flush=True)
    roots = [os.path.abspath(r) for r in args.roots]
    order = []
    for r in range(args.rounds):
        order += roots if r % 2 == 0 else roots[::-1]
    rc = 0
    for root in order:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root, "--cases", args.cases],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

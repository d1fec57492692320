"""The traced run's instruments: spans that the benchmark opens around the
program's calls, a profiler over a bounded sub-window, and the reduction
of its trace to device time by span, busy and idle time, and a breakdown.

Spans are ``torch.profiler.record_function`` scopes: the benchmark's
own, named ``bench.*``, and the port's, named ``pnt.*``
(``utils/profiling.py``'s ``span``). A kernel belongs to a span when the
host call that launched it (the runtime launch its correlation id names,
or else the host op its external id names) lies inside the span on the
same thread; it counts under every such span, so nested spans count
inclusively, and a name's nested spans count it once. A span opened on
the autograd engine's thread (inside a Function's ``backward``) collects
what that thread launches; the backward of the encoder's self-attention
is the engine's own scope for the block's Function,
``autograd::engine::evaluate_function: FusedSelfAttentionBackward``.
"""

from __future__ import annotations

import bisect
import heapq
import contextlib
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
ATTN_BWD_SCOPE = ("autograd::engine::evaluate_function: "
                  "FusedSelfAttentionBackward")
# the spans that collect device time besides ATTN_BWD_SCOPE
SPAN_PREFIXES = ("bench.", "pnt.")
# scopes that are no host work of their own: the benchmark's spans and the
# profiler's step marker
NOT_HOST_WORK = ("bench.", "ProfilerStep#")


class Counters:
    """What the benchmark's own wrappers count while ``active``."""

    def __init__(self):
        self.active = False
        self.values: dict[str, float] = {}
        self.attn_fwd: list[tuple] = []  # (B, L, d, H, dk) per call
        self.attn_bwd: list[tuple] = []

        self._device: dict[str, torch.Tensor] = {}

    def add(self, key: str, v: float) -> None:
        self.values[key] = self.values.get(key, 0.0) + float(v)

    def add_device(self, key: str, v: torch.Tensor) -> None:
        """Accumulate a device scalar without reading it back."""
        self._device[key] = (v if key not in self._device
                             else self._device[key] + v)

    def resolve(self) -> None:
        """Read the device accumulators back into ``values``."""
        for key, v in self._device.items():
            self.add(key, float(v))
        self._device.clear()


@contextlib.contextmanager
def span(name: str, counters: Counters):
    if counters.active:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


def wrap_attention(counters: Counters):
    """Open ``bench.attn_fwd`` around each call of the port's encoder
    self-attention block (``models/t5.py``'s ``fused_self_attention``) and
    note its shapes; returns the undo."""
    from pacednegatives_tpu_torch.models import t5 as t5m

    orig = t5m.fused_self_attention

    def wrapped(x, wqkv, wo, pos3, key_mask):
        if not counters.active:
            return orig(x, wqkv, wo, pos3, key_mask)
        B, L, d = x.shape
        H = pos3.shape[0]
        shape = (B, L, d, H, wqkv.shape[1] // 3 // H)
        counters.attn_fwd.append(shape)
        if torch.is_grad_enabled() and (x.requires_grad or wqkv.requires_grad):
            counters.attn_bwd.append(shape)
        with torch.profiler.record_function("bench.attn_fwd"):
            return orig(x, wqkv, wo, pos3, key_mask)

    t5m.fused_self_attention = wrapped
    return lambda: setattr(t5m, "fused_self_attention", orig)


class Phases:
    """Host seconds of the named parts of a run, each ended synchronised
    (``mark``), printed to standard error by the harness."""

    def __init__(self, t_start: float, device):
        self.device = device
        self.last = t_start
        self.seconds: dict[str, float] = {}

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def profile(warm, active, counters: Counters, out_dir: str,
            device) -> dict:
    """Run ``warm()`` with the profiler warming up, then ``active()``
    recorded inside ``bench.window`` with ``counters`` on; both end
    synchronised. Returns the reduced trace (``reduce``) with the window's
    host seconds; the trace file is deleted."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace.{os.getpid()}.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        warm()
        sync(device)
        prof.step()
        counters.active = True
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            active()
            sync(device)
            host_s = time.perf_counter() - t0
        counters.active = False
        prof.step()
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    out = reduce(events)
    out["host_window_s"] = host_s
    return out


def _union(intervals):
    """Sorted, merged [(start, end)]."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list) -> dict:
    """Device time by span name, busy and window seconds, and the
    breakdown, from a Chrome trace's events (times in microseconds)."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in X if e.get("name") == "bench.window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device = [e for e in X if e.get("cat") in DEVICE_CATS]
    host = [e for e in X if e.get("cat") in HOST_CATS]
    launches = {}
    by_ext = {}
    for e in host:
        args = e.get("args") or {}
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launches[args["correlation"]] = e
        elif "External id" in args:
            by_ext.setdefault(args["External id"], e)

    # {thread: {span name: (starts, ends)}} of the merged intervals
    scopes: dict = {}
    for e in host:
        name = e.get("name", "")
        if name.startswith(SPAN_PREFIXES) or name == ATTN_BWD_SCOPE:
            scopes.setdefault(e["tid"], {}).setdefault(name, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for by_name in scopes.values():
        for name, ivs in by_name.items():
            merged = _union(ivs)
            by_name[name] = ([s for s, _ in merged], [e for _, e in merged])

    span_names = sorted({name for by_name in scopes.values()
                         for name in by_name})
    span_device_s = {name: 0.0 for name in span_names}
    unattributed = 0
    kernel_s: dict[str, float] = {}
    intervals = []
    for e in device:
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < w0 or s > w1:
            continue
        intervals.append((max(s, w0), min(s + d, w1)))
        if e.get("cat") == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + d / 1e6
        args = e.get("args") or {}
        src = launches.get(args.get("correlation"))
        if src is None:
            src = by_ext.get(args.get("External id"))
        if src is None:
            unattributed += 1
            continue
        t = float(src["ts"])
        for name, (starts, ends) in scopes.get(src["tid"], {}).items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                span_device_s[name] += d / 1e6
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e6

    # idle gaps, named by the host call entered last that covers the gap
    gaps = []
    prev = w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    # a max-heap by start of the calls begun before the gap's midpoint;
    # one that ended before a midpoint covers no later one
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in host
                   if not e.get("name", "").startswith(NOT_HOST_WORK))
    heap: list = []
    i = 0
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while i < len(calls) and calls[i][0] <= mid:
            heapq.heappush(heap, (-calls[i][0], calls[i][1], calls[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "no_host_operation"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "span_device_s": span_device_s,
        "unattributed_kernels": unattributed,
        "breakdown": {"device_ops": top(kernel_s), "idle_gaps": top(idle)},
    }

"""Tracing / profiling / debugging utilities: the port of utils/profiling.py.

Replaces the reference's telemetry surface (SURVEY.md §5): Lightning
``profiler='simple'`` (train/train_lce.py:84), the HF fork's
TrainerMemoryTracker + total_flos accounting (utilities/trainer.py:113,
707-715), and adds what the reference lacks: device traces and NaN
checking. ``trace`` is ``torch.profiler``; ``cost_analysis`` counts the
``aten`` ops a call dispatches; ``debug_nans`` checks every op's output.

``span`` and ``count`` are the port's own instruments, on only while a
``torch.profiler`` records (``trace``, or any other profiler in its active
phase; not in its warm-up): each layer opens ``pnt.<layer>.<part>`` spans,
which lie in the device trace as ``record_function`` scopes and in
``recorded()`` with their parents, ids and host times; ``host_sync`` marks
each blocking device-to-host read, and each copy that waits on the stream,
as a ``pnt.sync.<site>`` span and a ``host_syncs`` count;
``count_device`` sums a count that lives on the device there, read back
once by ``recorded()``. With no profiler recording, each costs one read
of the profiler's flag.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU ops, and CUDA
    kernels when a card is present) and write a Chrome / TensorBoard trace
    (``*.pt.trace.json``) under ``log_dir`` on exit. Yields the profiler,
    whose ``key_averages()`` sums the block's ops and kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class _BytesMode(TorchDispatchMode):
    """Sums the input and output tensor bytes of every ``aten`` op that
    does not return a view (a view moves no data)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


def cost_analysis(fn: Callable, *args, **kwargs) -> dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once and count its cost: flops from
    ``torch.utils.flop_counter.FlopCounterMode`` (the HF fork's
    ``total_flos`` equivalent, from the dispatched ops instead of a hand
    model) and bytes accessed as the sum, over every dispatched ``aten`` op
    that is not a view, of its input and output tensor bytes.

    That byte count is unfused traffic: each op reads its inputs and writes
    its output as if nothing stayed on chip between ops. XLA's count (the
    JAX package's) is taken after fusion, so for a chain of elementwise ops
    it is lower; for one matmul the two agree."""
    flops = FlopCounterMode(display=False)
    with flops, _BytesMode() as mode:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(mode.bytes)}


def t5_forward_flops(cfg, n_seqs: int, l_enc: int, l_dec: int) -> float:
    """Analytic matmul FLOPs for ONE forward pass of the T5 stack.

    MFU convention: useful model FLOPs only (no remat recompute). Encoder
    and decoder token counts are split — monoT5 decodes only the ~2 label
    tokens, so charging decoder params for encoder positions (the
    ``2 * n_params * total_tokens`` shortcut) overstates FLOPs ~2.5x at
    prompt lengths ~190.

    Terms per layer: Q/K/V/O projections, attention scores+values, FFN
    (2 or 3 matmuls for gated), plus cross-attention (K/V projected from
    the l_enc encoder outputs, Q/O and scores on the l_dec positions) and
    the tied LM head.
    """
    h, dk, dm, dff = cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff
    ffn_mats = 3 if cfg.gated_ffn else 2

    def proj(tokens, n_mats):  # (tokens, dm) x (dm, h*dk) matmuls
        return 2.0 * tokens * dm * h * dk * n_mats

    def ffn(tokens):
        return 2.0 * tokens * dm * dff * ffn_mats

    def attn(q_tokens, k_len):  # scores + values
        return 4.0 * q_tokens * k_len * h * dk

    enc = cfg.num_layers * (proj(l_enc, 4) + attn(l_enc, l_enc) + ffn(l_enc))
    dec_self = proj(l_dec, 4) + attn(l_dec, l_dec)
    dec_cross = proj(l_dec, 2) + proj(l_enc, 2) + attn(l_dec, l_enc)
    dec = cfg.num_decoder_layers * (dec_self + dec_cross + ffn(l_dec))
    lm_head = 2.0 * l_dec * dm * cfg.vocab_size
    return float(n_seqs) * (enc + dec + lm_head)


def t5_step_flops(cfg, n_seqs: int, l_enc: int, l_dec: int = 2) -> float:
    """Model FLOPs for one train step: forward + backward = 3x forward."""
    return 3.0 * t5_forward_flops(cfg, n_seqs, l_enc, l_dec)


# dense bf16 peak tensor-core throughput per card, FLOP/s (NVIDIA's public
# data sheets, without sparsity), keyed on a substring of
# torch.cuda.get_device_name
PEAK_FLOPS = {
    "h100 80gb hbm3": 989.4e12,  # H100 SXM5, 80GB HBM3, 700 W
    "h100 pcie": 756e12,  # H100 PCIe, 350 W
}


def device_peak_flops(device=None) -> float | None:
    """Best-effort bf16 peak for ``device`` (default: the current CUDA
    device); None on the CPU or an unknown card."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


# ops whose outputs are uninitialised memory, which may hold NaN bit patterns
_UNINITIALISED = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
                  torch.ops.aten.empty_like, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided}


def _floating(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _floating(x)]
    return []


class _NanMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED:
            for t in _floating(out):
                if torch.isnan(t).any():
                    raise FloatingPointError(
                        f"NaN in the output of {func} (debug_nans)")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking (the counterpart of scoped ``jax_debug_nans``,
    the determinism/sanitizer knob the reference lacks, SURVEY.md §5): any
    ``aten`` op, forward or backward, whose floating output holds a NaN
    raises ``FloatingPointError`` at once. Each check reads the output back
    (a device sync an op). Ops outside the dispatcher (the hand kernels'
    ctypes launches) are checked where the next op reads their output. A
    no-op with ``enable=False``; the previous state returns on exit."""
    if not enable:
        yield
        return
    with _NanMode():
        yield


# -- spans and counters -----------------------------------------------------

_NULL = contextlib.nullcontext()
_spans: list = []  # [name, parent record, id, start ns, end ns, child ns]
_counts: dict[str, float] = {}
_device_counts: dict[str, torch.Tensor] = {}  # sums kept on the device
_count_lock = threading.Lock()  # threads add to one counter
_local = threading.local()  # .stack: the thread's open span records
_clock = time.perf_counter_ns


class _Span:
    __slots__ = ("name", "id", "scope", "rec")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        sid = self.id if self.id is not None or parent is None else parent[2]
        self.scope = torch.profiler.record_function(
            self.name, None if self.id is None else str(self.id))
        self.scope.__enter__()
        self.rec = [self.name, parent, sid, _clock(), None, 0]
        stack.append(self.rec)
        _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[4] = _clock()
        _local.stack.pop()
        if rec[1] is not None:
            rec[1][5] += rec[4] - rec[3]
        self.scope.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a ``torch.profiler`` records now (its active phase)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, id=None):
    """A ``pnt.*`` span over the ``with`` block while a profiler records:
    a ``record_function(name)`` scope (``id`` as its args) and a record of
    its parent (the thread's innermost open span), its id (``id``, else
    the parent's) and its host start and end. The shared null context
    otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, id)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _count_lock:
            _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, n: torch.Tensor) -> None:
    """Add the device scalar ``n`` to the counter ``name`` while a profiler
    records, on the device: no read back (``recorded()`` reads the sum)."""
    if _autograd_profiler._is_profiler_enabled:
        n = n.detach().to(torch.float64)
        with _count_lock:
            acc = _device_counts.get(name)
            _device_counts[name] = n if acc is None else acc + n


def host_sync(site: str, n: int = 1):
    """Span ``pnt.sync.<site>`` around a statement that blocks the host on
    the card: a read back to the host, or a copy from pageable host memory
    that waits on the stream (``n`` of them); each adds to ``host_syncs``.
    The site is counted on every device, so that a CPU run counts what a
    card run would wait on."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    count("host_syncs", n)
    return _Span("pnt.sync." + site, None)


def recorded() -> dict:
    """What the spans and counters recorded since the last ``reset``:
    ``spans``, in the order they opened, each a dict of ``name``,
    ``parent`` (the parent's index in the list, or None), ``id``,
    ``start_ns`` / ``end_ns`` (``time.perf_counter_ns``; ``end_ns`` None
    while open), ``dur_ns`` and ``self_ns`` (the duration less what its
    children cover); and ``counts``, the device sums (``count_device``)
    among them, read back here (one wait on the device)."""
    spans = list(_spans)
    with _count_lock:
        counts = dict(_counts)
        for name, n in _device_counts.items():
            counts[name] = counts.get(name, 0) + float(n)
    index = {id(r): i for i, r in enumerate(spans)}
    out = []
    for name, parent, sid, t0, t1, child in spans:
        dur = None if t1 is None else t1 - t0
        up = None if parent is None else index.get(id(parent))
        out.append({"name": name, "parent": up,
                    "id": sid, "start_ns": t0, "end_ns": t1, "dur_ns": dur,
                    "self_ns": None if dur is None else dur - child})
    return {"spans": out, "counts": counts}


def reset() -> None:
    """Forget every recorded span and count."""
    _spans.clear()
    with _count_lock:
        _counts.clear()
        _device_counts.clear()


class StepTimer:
    """Simple-profiler-style aggregate timings (per section); each section
    is also a ``span`` of its name."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / self.counts[k],
            }
            for k in self.totals
        }

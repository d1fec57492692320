"""Shares that the per-layer readers take from a traced run."""

from __future__ import annotations

from benchmarks.common.flops import attn_block_bwd, attn_block_fwd, bound_s
from benchmarks.common.tracing import ATTN_BWD_SCOPE


def _share(ctx, shapes, work, scope):
    t = ctx.outcome.trace
    if t is None or not shapes or not ctx.peak_flops:
        return None
    device_s = t["span_device_s"].get(scope, 0.0)
    if device_s <= 0:
        return None
    least = sum(bound_s(*work(*s)[::-1], ctx.peak_flops) for s in shapes)
    return 100.0 * least / device_s


def forward_share(ctx):
    return _share(ctx, ctx.outcome.counters.attn_fwd, attn_block_fwd,
                  "bench.attn_fwd")


def backward_share(ctx):
    return _share(ctx, ctx.outcome.counters.attn_bwd, attn_block_bwd,
                  ATTN_BWD_SCOPE)


def idle_share(ctx):
    t = ctx.outcome.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

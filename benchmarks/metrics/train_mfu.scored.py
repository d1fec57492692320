"""train_mfu.scored: model FLOPs of the traced window's training work over its
time and the card's bf16 peak, in percent. Trained rows count 3x their
forward, scored rows 1x, each at its real tokens; no recompute."""

from benchmarks.common.flops import t5_forward_flops


def read(ctx):
    c = ctx.outcome.counters.values
    if ctx.outcome.trace is None or not c.get("train_rows") \
            or not ctx.peak_flops:
        return None
    model = ctx.model
    flops = 3 * t5_forward_flops(model, c["train_rows"], c["train_len"],
                                 c["train_len_sq"], 2)
    if c.get("score_rows"):
        flops += t5_forward_flops(model, c["score_rows"], c["score_len"],
                                  c["score_len_sq"], 1)
    return 100.0 * flops / (ctx.outcome.trace["window_s"] * ctx.peak_flops)

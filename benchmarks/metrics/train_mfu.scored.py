"""train_mfu.scored: model FLOPs of the traced window's training work over its
time and the card's bf16 peak, in percent. Trained rows count 3x their
forward, scored rows 1x, each at its real tokens; no recompute. The
forward's FLOPs are the architecture's (``ctx.forward_flops``)."""


def read(ctx):
    c = ctx.outcome.counters.values
    if ctx.outcome.trace is None or not c.get("train_rows") \
            or not ctx.peak_flops:
        return None
    flops = 3 * ctx.forward_flops(c["train_rows"], c["train_len"],
                                  c["train_len_sq"], trained=True)
    if c.get("score_rows"):
        flops += ctx.forward_flops(c["score_rows"], c["score_len"],
                                   c["score_len_sq"], trained=False)
    return 100.0 * flops / (ctx.outcome.trace["window_s"] * ctx.peak_flops)

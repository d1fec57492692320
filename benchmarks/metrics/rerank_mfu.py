"""rerank_mfu: model FLOPs of the traced window's reranked prompts (one
scoring forward each, at their real tokens) over its time and the card's
bf16 peak, in percent. The forward's FLOPs are the architecture's
(``ctx.forward_flops``)."""


def read(ctx):
    c = ctx.outcome.counters.values
    if ctx.outcome.trace is None or not c.get("rerank_rows") \
            or not ctx.peak_flops:
        return None
    flops = ctx.forward_flops(c["rerank_rows"], c["rerank_len"],
                              c["rerank_len_sq"], trained=False)
    return 100.0 * flops / (ctx.outcome.trace["window_s"] * ctx.peak_flops)

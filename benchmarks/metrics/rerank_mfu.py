"""rerank_mfu: model FLOPs of the traced window's reranked prompts (one
forward each, at their real tokens, one decoder position) over its time
and the card's bf16 peak, in percent."""

from benchmarks.common.flops import t5_forward_flops


def read(ctx):
    c = ctx.outcome.counters.values
    if ctx.outcome.trace is None or not c.get("rerank_rows") \
            or not ctx.peak_flops:
        return None
    flops = t5_forward_flops(ctx.model, c["rerank_rows"], c["rerank_len"],
                             c["rerank_len_sq"], 1)
    return 100.0 * flops / (ctx.outcome.trace["window_s"] * ctx.peak_flops)

"""attn_fwd_roofline.rerank: as attn_fwd_roofline.train, over the rerank
requests of the traced window."""

from benchmarks.common.roofline import forward_share


def read(ctx):
    return forward_share(ctx)

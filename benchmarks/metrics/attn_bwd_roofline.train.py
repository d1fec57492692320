"""attn_bwd_roofline.train: the least time of the encoder self-attention
block's backward work in the traced window (both products of each
projection's gradient and the core's five L x L x dk products, at each
call's shapes) over the device time of the kernels launched inside the
autograd engine's scope of the block's backward, in percent."""

from benchmarks.common.roofline import backward_share


def read(ctx):
    return backward_share(ctx)

"""attn_fwd_roofline.train: the least time of the encoder self-attention
block's forward work in the traced window (each call's QKV projection,
core and output projection at its shapes; bytes or operations, the
larger) over the device time of the kernels launched inside the
benchmark's span around the calls, in percent."""

from benchmarks.common.roofline import forward_share


def read(ctx):
    return forward_share(ctx)

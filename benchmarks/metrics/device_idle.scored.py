"""device_idle.scored: the share of the traced window in which no kernel,
copy or fill ran on the card, in percent."""

from benchmarks.common.roofline import idle_share


def read(ctx):
    return idle_share(ctx)

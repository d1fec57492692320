"""score_ms_per_step.scored: device milliseconds a training step spends in
the kernels launched inside the benchmark's span around the port's
``score_candidates`` (the no-grad scoring of the pool candidates)."""


def read(ctx):
    t = ctx.outcome.trace
    if t is None or "bench.score_candidates" not in t["span_device_s"]:
        return None
    device_s = t["span_device_s"]["bench.score_candidates"]
    if device_s <= 0:
        return None
    return 1e3 * device_s / ctx.outcome.attempted

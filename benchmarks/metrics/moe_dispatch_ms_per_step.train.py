"""moe_dispatch_ms_per_step.train: device milliseconds a ``pnt.step`` of
the kernels launched inside the port's ``pnt.moe.route``,
``pnt.moe.dispatch`` and ``pnt.moe.combine`` spans (the router, the
dispatch plan and gather, the weighted combine; the latter two also in
their Functions' backward), over the traced window."""

from pacednegatives_tpu_torch.utils import profiling

SPANS = ("pnt.moe.route", "pnt.moe.dispatch", "pnt.moe.combine")


def read(ctx):
    t = ctx.outcome.trace
    if t is None:
        return None
    rec = profiling.recorded()
    steps = sum(s["name"] == "pnt.step" for s in rec["spans"])
    if not steps or not any(s["name"] in SPANS for s in rec["spans"]):
        return None
    return 1e3 * sum(t["span_device_s"].get(n, 0.0) for n in SPANS) / steps

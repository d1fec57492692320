"""host_ms_per_step.scored: host milliseconds of a scored-pool step that
the host spends dispatching rather than waiting on the card: each
``pnt.step`` span's duration less its ``pnt.sync.*`` descendants', over
the window's ``pnt.step`` spans. ``utils.profiling.recorded()`` holds the
run's one profiler recording; a program without it reads nothing."""

from pacednegatives_tpu_torch.utils import profiling


def read(ctx):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    steps = {i for i, s in enumerate(spans)
             if s["name"] == "pnt.step" and s["dur_ns"] is not None}
    if not steps:
        return None
    host_ns = sum(spans[i]["dur_ns"] for i in steps)
    for s in spans:
        if s["name"].startswith("pnt.sync.") and s["dur_ns"] is not None:
            up = s["parent"]
            while up is not None and up not in steps:
                up = spans[up]["parent"]
            if up is not None:
                host_ns -= s["dur_ns"]
    return host_ns / 1e6 / len(steps)

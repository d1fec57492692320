"""host_syncs_per_step.train: the port's ``host_syncs`` counter (each
blocking read back to the host, and each copy that waits on the stream,
that ``TrainLoop.run`` makes) over the traced window, per ``pnt.step``
span of the window. ``utils.profiling.recorded()`` holds the run's one
profiler recording; a program without it reads nothing."""

from pacednegatives_tpu_torch.utils import profiling


def read(ctx):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    steps = sum(s["name"] == "pnt.step" for s in rec["spans"])
    if not steps:
        return None
    return rec["counts"].get("host_syncs", 0) / steps

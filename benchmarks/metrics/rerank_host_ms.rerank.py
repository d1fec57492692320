"""rerank_host_ms.rerank: host milliseconds a request spends in the
rerank's own host work, which no kernel overlaps (each block waits on the
last one's scores): the self time of its ``pnt.rerank.plan`` (id lookups,
bucket plan), ``pnt.rerank.assemble`` (prompt assembly) and
``pnt.rerank.order`` (the ranking) spans, over the window's
``pnt.rerank.request`` spans. ``utils.profiling.recorded()`` holds the
run's one profiler recording; a program without it reads nothing."""

from pacednegatives_tpu_torch.utils import profiling

HOST = ("pnt.rerank.plan", "pnt.rerank.assemble", "pnt.rerank.order")


def read(ctx):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    requests = sum(s["name"] == "pnt.rerank.request" for s in spans)
    if not requests:
        return None
    host_ns = sum(s["self_ns"] for s in spans
                  if s["name"] in HOST and s["self_ns"] is not None)
    return host_ns / 1e6 / requests

"""moe_gemm_fwd_roofline.train: the least time of the held experts'
forward GEMMs in the traced window (gate|up and down over the port's
``moe.slots`` token-expert pairs, each expert layer reading its held
experts' weights once; ``benchmarks/common/moe_flops.py``) over the
device time of the kernels launched inside the port's ``pnt.moe.experts``
spans (the grouped GEMM M1 and the SwiGLU between its two calls), in
percent. Nothing to read without those spans and that counter."""

from benchmarks.common.moe_flops import expert_gemms, least_s
from pacednegatives_tpu_torch.utils import profiling


def read(ctx):
    t = ctx.outcome.trace
    if t is None or not ctx.peak_flops or "experts_held" not in ctx.model:
        return None
    rec = profiling.recorded()
    slots = rec["counts"].get("moe.slots")
    calls = sum(s["name"] == "pnt.moe.experts" for s in rec["spans"])
    device_s = t["span_device_s"].get("pnt.moe.experts", 0.0)
    if not slots or not calls or device_s <= 0:
        return None
    return 100.0 * least_s(expert_gemms(ctx.model, slots, calls),
                           ctx.peak_flops) / device_s

"""moe_gemm_bwd_roofline.train: the least time of the held experts'
backward GEMMs in the traced window (dX and dW of gate|up and of down over
the port's ``moe.slots`` pairs; ``benchmarks/common/moe_flops.py``) over
the device time of the kernels launched inside the port's
``pnt.moe.experts.bwd`` spans (opened in the grouped GEMM Function's
backward, on the autograd engine's thread: M1 and the weights'
transposes), in percent."""

from benchmarks.common.moe_flops import expert_gemms_bwd, least_s
from pacednegatives_tpu_torch.utils import profiling


def read(ctx):
    t = ctx.outcome.trace
    if t is None or not ctx.peak_flops or "experts_held" not in ctx.model:
        return None
    rec = profiling.recorded()
    slots = rec["counts"].get("moe.slots")
    calls = sum(s["name"] == "pnt.moe.experts" for s in rec["spans"])
    device_s = t["span_device_s"].get("pnt.moe.experts.bwd", 0.0)
    if not slots or not calls or device_s <= 0:
        return None
    return 100.0 * least_s(expert_gemms_bwd(ctx.model, slots, calls),
                           ctx.peak_flops) / device_s

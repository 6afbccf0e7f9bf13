"""B4's share of its roofline in the compiled step: the least time of its
calls (``mmfbench/kernels.py``, at the configuration's call shapes and
the card's published peaks) over its device time in the profiled stretch
of replays. Nothing where the trace holds another number of launches
than the kernel's counter (a trace that left launches out)."""

from mmfbench import kernels, trace


def read(r):
    compiled = r.get("compiled")
    if not compiled:
        return None
    n, seconds = trace.kernel_time(compiled["ops"], kernels.B4_KERNEL)
    if n == 0 or n != compiled["launches"]["b4"]:
        return None
    least = kernels.least_s_per_step(r["config"], "b4", r["nens"],
                                     r["chunk"]) * compiled["steps"]
    return 100.0 * least / seconds

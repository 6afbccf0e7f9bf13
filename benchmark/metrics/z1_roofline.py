"""Z1's share of its roofline in the compiled step: the least time of the
SPAM dycore's vertical WENO reconstructions (``csrc/weno_z.cu``, the
calls below, the card's published peaks in ``mmfbench/kernels.py``) over
the kernel's device time in the profiled stretch of replays. Nothing
where the trace holds no launch of it (a program without the kernel) or
another number than the calls the steps make (a trace that left launches
out).

A chunk step makes three symplectic evaluations, each reconstructing the
densities on the 50 dual levels and the PV on the 49 primal ones, every
row a (levels + 4, 65) z-padded column plane. The work of a call is the
padded field read once and both edge arrays written once, and per cell
the limiter and edge operations of B1's count (``kernels.weno_x_work``),
as ``pam_tpu_torch/ops/weno_z.py::weno_z_work`` counts them."""

from mmfbench import kernels, spec, trace

Z1_KERNEL = "weno_z_edges_kernel"
NX = 65
# (rows a member, levels) of each call of a chunk step: the densities
# (12 with P3+SHOC's tracers, 5 with Kessler's) and the PV, three times
CALLS = {"mmf_production": [(12, 50), (1, 49)] * 3,
         "mmf_pamc_kessler": [(5, 50), (1, 49)] * 3}


def work(rows: int, nlev: int, itemsize: int) -> tuple:
    """(bytes, flops) of one call on ``rows`` column planes."""
    flops = kernels.weno_x_work(rows * nlev, NX, itemsize)[1]
    return rows * (3 * nlev + 4) * NX * itemsize, flops


def read(r):
    compiled = r.get("compiled")
    calls = CALLS.get(r["config"]["name"])
    if not compiled or not calls:
        return None
    chunks = r["nens"] // r["chunk"]
    n, seconds = trace.kernel_time(compiled["ops"], Z1_KERNEL)
    if n == 0 or n != len(calls) * chunks * compiled["steps"]:
        return None
    dtype = spec.dtype_name(r["config"])
    least = sum(kernels.least_s(*work(rows * r["chunk"], nlev,
                                      kernels.ITEMSIZE[dtype]), dtype)
                for rows, nlev in calls)
    return 100.0 * least * chunks * compiled["steps"] / seconds

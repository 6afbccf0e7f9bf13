"""B3's share of its roofline in the compiled step: the least time of the
AWFL dycore's directional flux (``csrc/awfl_flux.cu``) over its device
time, both over one traced GCM step (``mmfbench/graph_trace.py``).

The least time is that of one acoustic sub-cycle's calls
(``kernels.least_s_per_cycle``: the configuration's
``kernel_calls["b3"]``, the card's published peaks) times the sub-cycles
the stretch took, all chunks (the ``awfl.acoustic`` loop's trips). The
device time is that of the program's ``pam:awfl.flux_x``, ``flux_y`` and
``flux_z`` spans, which the tracer stamps around each call inside the
WHILE node's body, every trip. It is read from those stamps and not from
the profiler's trace because CUPTI records a WHILE body's kernels in its
first trip only: 18 B3 kernels in the trace of 3 compiled steps against
774 launched (43 sub-cycles a step, 6 calls each). Nothing where the
spans or the trips are missing (a SPAM cell, or a program without the
tracer)."""

from mmfbench import graph_trace, kernels

FLUX_SPANS = ("pam:awfl.flux_x", "pam:awfl.flux_y", "pam:awfl.flux_z")


def read(r):
    flux_ms = graph_trace.span_ms_per_step(r, *FLUX_SPANS)
    trips = graph_trace.trips_per_step(r, "awfl.acoustic")
    if not flux_ms or not trips:
        return None
    least = kernels.least_s_per_cycle(r["config"], r["chunk"]) * trips
    return 100.0 * least / (flux_ms / 1e3)

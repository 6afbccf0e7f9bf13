"""Acoustic sub-cycles a CRM step of the AWFL dycore, all chunks: the
trips of its ``awfl.acoustic`` loop, whose count the device decides from
the CFL, added by the program's tracer after each WHILE node, over one
traced GCM step (``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.trips_per_step(r, "awfl.acoustic")

"""Device ms a CRM step of the dycore inside the compiled step: the
program's ``pam:dycore`` span (B1's nodes inside it), stamped in the CUDA
graph, over one traced GCM step (``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:dycore")

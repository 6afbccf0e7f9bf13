"""Device ms a CRM step of the physics inside the compiled step: the
program's ``pam:sgs`` and ``pam:micro`` spans (B4's node and the
microphysics' WHILE nodes inside them), stamped in the CUDA graph, over
one traced GCM step (``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:sgs", "pam:micro")

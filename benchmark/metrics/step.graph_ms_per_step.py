"""Device ms a CRM step of the compiled step: the program's ``pam:step``
span (the whole of ``MmfDriver._crm_phys_step_single``), stamped inside
the CUDA graph by the program's tracer, summed over every replay of one
traced GCM step (``mmfbench/graph_trace.py``), over its CRM steps."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:step")

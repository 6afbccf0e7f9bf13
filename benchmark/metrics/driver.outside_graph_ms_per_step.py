"""Device ms a CRM step outside the compiled step's ``pam:step`` span:
on the tracer's timeline, from one replay's ``pam:step`` end to the next
one's begin, summed (the copies in and out, the counts applied after a
replay, the forcing and the GCM sync's wait), over the CRM steps of one
traced GCM step (``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.outside_ms_per_step(r)

"""Device ms a CRM step of the AWFL dycore's FCT positivity limiting: the
program's ``pam:awfl.fct`` span, stamped in the WHILE body of the
acoustic sub-cycles, once a tendency evaluation, over one traced GCM step
(``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:awfl.fct")

"""Device ms a CRM step of the AWFL dycore's halo and boundary assembly
(``AwflDycore._pad_all``): the program's ``pam:awfl.halo`` span, stamped
in the WHILE body of the acoustic sub-cycles, once a tendency evaluation,
over one traced GCM step (``mmfbench/graph_trace.py``). Nothing from a
program without the span."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:awfl.halo")

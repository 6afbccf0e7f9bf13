"""Device ms a CRM step of the AWFL dycore's SSPRK3 stage updates (each
stage's combination of states and tendencies and its positivity clamp,
``AwflDycore._ssprk3_cycle``): the program's ``pam:awfl.stage`` span,
stamped in the WHILE body of the acoustic sub-cycles, three times a trip,
over one traced GCM step (``mmfbench/graph_trace.py``). Nothing from a
program without the span."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.span_ms_per_step(r, "pam:awfl.stage")

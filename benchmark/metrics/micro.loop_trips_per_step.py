"""Trips a CRM step of the microphysics' loops decided on the device:
P3's combined sedimentation rounds (``p3.sedimentation``) or Kessler's
rain sub-cycles (``kessler.rain``), counted by the program's tracer after
each WHILE node, all chunks, over one traced GCM step
(``mmfbench/graph_trace.py``)."""

from mmfbench import graph_trace


def read(r):
    return graph_trace.trips_per_step(r, "p3.sedimentation", "kessler.rain")

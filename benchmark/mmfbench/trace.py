"""Readings of a ``torch.profiler`` trace, as plain lists and sums: the
device operations (name, start, end in ns), and the device time of the
program's ``pam:`` spans. A trace with no device operation reads as
empty, and the metrics that need one are left out."""

from __future__ import annotations

import collections

from torch.autograd import DeviceType


def device_ops(prof) -> list:
    """(name, start ns, end ns) of every device operation of the trace
    (kernels, copies, sets), read from its raw events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def by_name(ops: list) -> list:
    """[(name, total seconds)], the longest first."""
    total = collections.defaultdict(float)
    for name, s, e in ops:
        total[name] += (e - s) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


def kernel_time(ops: list, kernel: str) -> tuple:
    """(launches, seconds) of the operations whose name holds
    ``kernel``."""
    hits = [(e - s) / 1e9 for name, s, e in ops if kernel in name]
    return len(hits), sum(hits)


def span_device_s(prof, prefix: str = "pam:") -> dict:
    """Device seconds of the kernels that each host span named
    ``prefix...`` launched, children included, summed by name (kernels
    launched through ctypes are attributed to no span)."""
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(prefix):
            t = getattr(e, "device_time_total", None)
            out[e.name] += (e.cuda_time_total if t is None else t) / 1e6
    return dict(out)

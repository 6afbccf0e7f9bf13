"""Observability: module timers and state-diff (dirty-entry) tracing
(port of pam_tpu/utils/observe.py).

Parity reference: PamCoupler::run_module (pam_core/pam_coupler.h:139-160)
wraps every coupler phase with (a) yakl timers (PAM_FUNCTION_TIMERS) and
(b) DataManager dirty-entry tracing (PAM_FUNCTION_TRACE) that prints which
coupler fields each module wrote. Here: a ``torch.profiler``
``record_function`` span per module for device traces, a host wall clock
per module, and a state diff.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..convert import host_array as _host


def _sync(state: dict):
    """Wait for the card if any tensor of ``state`` lives on it."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in state.values()):
        torch.cuda.synchronize()


class ModuleTimers:
    """Accumulates wall-clock time per named module and exposes a
    run_module wrapper mirroring pam_coupler.h:139-160."""

    def __init__(self, trace: bool = False):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.trace = trace
        self.trace_log: list[tuple[str, tuple[str, ...]]] = []

    def run_module(self, name: str, fn: Callable, state: dict) -> dict:
        """state -> state', timed (the device is synchronized before each
        clock read when the state is on it); with trace=True also records
        which entries the module changed (the dirty-entry report)."""
        with record_function(name):
            _sync(state)
            t0 = time.perf_counter()
            out = fn(state)
            _sync(out)
            dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if self.trace:
            self.trace_log.append((name, state_diff(state, out)))
        return out

    def report(self) -> str:
        """Timer-tree style report (analog of the yakl timer printout)."""
        total = sum(self.times.values())
        lines = [f"{'module':24s} {'calls':>6s} {'total s':>10s} {'%':>6s}"]
        for k in sorted(self.times, key=self.times.get, reverse=True):
            pct = 100.0 * self.times[k] / total if total else 0.0
            lines.append(f"{k:24s} {self.counts[k]:6d} "
                         f"{self.times[k]:10.3f} {pct:6.1f}")
        return "\n".join(lines)


def state_diff(before: dict, after: dict) -> tuple[str, ...]:
    """Names of entries whose arrays changed (dirty entries,
    DataManager.h:239-271). Host-side, for debugging."""
    dirty = []
    for k in after:
        if k not in before:
            dirty.append(k)
            continue
        a, b = _host(before[k]), _host(after[k])
        # equal_nan: a field already holding NaN (the blow-up this tool
        # debugs) must not read as dirty in every module
        eq_nan = a.dtype.kind == "f" and b.dtype.kind == "f"
        if a.shape != b.shape or not np.array_equal(a, b, equal_nan=eq_nan):
            dirty.append(k)
    return tuple(dirty)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block (CPU, and the card where there is
    one); writes the Chrome trace ``<logdir>/trace.json`` (open it in
    chrome://tracing or Perfetto) and yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def validate_state(state: dict, positive: tuple[str, ...] = ()) -> dict:
    """NaN/Inf/positivity audit (ref: DataManager validate_all,
    DataManager.h:411-466 + pam_const.h validators). Returns a report dict
    name -> list of failed checks; empty when clean. Host-side."""
    report = {}
    for k, v in state.items():
        arr = _host(v)
        fails = []
        if np.isnan(arr).any():
            fails.append("nan")
        if np.isinf(arr).any():
            fails.append("inf")
        if k in positive and (arr < 0).any():
            fails.append("negative")
        if fails:
            report[k] = fails
    return report

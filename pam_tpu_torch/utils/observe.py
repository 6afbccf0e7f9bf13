"""Observability: module timers and state-diff (dirty-entry) tracing
(port of pam_tpu/utils/observe.py), and the tracer of the compiled step.

Parity reference: PamCoupler::run_module (pam_core/pam_coupler.h:139-160)
wraps every coupler phase with (a) yakl timers (PAM_FUNCTION_TIMERS) and
(b) DataManager dirty-entry tracing (PAM_FUNCTION_TRACE) that prints which
coupler fields each module wrote. Here: a ``torch.profiler``
``record_function`` span per module for device traces, a host wall clock
per module, and a state diff.

The tracer (:func:`span`, :func:`add_trips`, :func:`host_span`,
:func:`enable`, :func:`snapshot`) times the program's layers where
``torch.profiler`` cannot: inside a replayed CUDA graph. Off (the
default) a span is ``record_function(name)`` and nothing else, so a
capture holds exactly the nodes it would hold without it. On, entering
and leaving a span launches a one-thread kernel (``csrc/trace_stamp.cu``)
that reads the card's clock and adds the span's time and count into
device accumulators; under capture the stamps become kernel nodes of the
graph, inside WHILE bodies too, so every replay adds to them with no host
involved. A span outside any loop body also appends (name, begin, end) to
a bounded timeline, one entry a replay. Named loops (``ops/graph.py::
while_loop``) add their trips. Host spans record (name, begin, end) on
``time.perf_counter_ns``; :func:`enable` measures the offset of the
card's clock to it, so the timeline and the host spans share one clock.
On the CPU the same calls take the host's clock. Nothing is read from the
card until :func:`snapshot` (one synchronisation).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
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


# ---------------------------------------------------------------------------
# the tracer of the compiled step
# ---------------------------------------------------------------------------

SLOTS = 64           # span and loop names a process can hold
RING = 1 << 16       # entries of the timeline (and of the host spans)
CALIBRATION = 32     # host brackets a measurement of the clocks' offset


def stamp_kernel(fn, *args):
    """Launch one stamp kernel of ``csrc/trace_stamp.cu`` (``fn``, bound by
    ``_cuda.library``); ``stamp_kernel.launches`` counts the calls: the
    kernels launched eagerly and the nodes put into captured graphs."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
    stamp_kernel.launches += 1


stamp_kernel.launches = 0


class _Layout:
    """The accumulators of :data:`SLOTS` names, one int64 array: begin,
    ns, count and trips a slot, then the timeline's length and its
    (slot, begin, end) entries."""
    BEGIN, NS, COUNT, TRIPS = (k * SLOTS for k in range(4))
    RING_N = 4 * SLOTS
    ENTRIES = RING_N + 1
    CAP = RING
    SIZE = ENTRIES + 3 * CAP


class _DeviceStamps:
    """The accumulators on a card, written by the stamp kernels on the
    current stream. Made once a device and kept for the process: a
    captured graph holds their addresses."""

    clock = "device"

    def __init__(self, device: torch.device):
        from .. import _cuda
        self.device = device
        self.lib = _cuda.library()
        self.buf = torch.zeros(_Layout.SIZE, dtype=torch.int64, device=device)
        self.base = self.buf.data_ptr()
        self.idle = torch.cuda.Stream(device)   # for the clocks' offset
        self.probe = torch.zeros(CALIBRATION + 65, dtype=torch.int64,
                                 device=device)
        # every stamp kernel once on the idle stream, so that none is
        # first loaded inside a capture
        p = self.probe.data_ptr()
        stamp_kernel(self.lib.pam_stamp_begin, p, self.idle.cuda_stream)
        stamp_kernel(self.lib.pam_stamp_end, p, p + 8, p + 16, p + 24, None,
                     _Layout.CAP, 0, self.idle.cuda_stream)
        self.resolution_ns = self._resolution()

    def _at(self, index: int) -> int:
        return self.base + 8 * index

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def begin(self, slot: int):
        stamp_kernel(self.lib.pam_stamp_begin, self._at(_Layout.BEGIN + slot),
                     self._stream())

    def end(self, slot: int, ring: bool):
        stamp_kernel(self.lib.pam_stamp_end, self._at(_Layout.BEGIN + slot),
                     self._at(_Layout.NS + slot),
                     self._at(_Layout.COUNT + slot),
                     self._at(_Layout.RING_N),
                     self._at(_Layout.ENTRIES) if ring else None,
                     _Layout.CAP, slot, self._stream())

    def add_trips(self, slot: int, n):
        self.buf[_Layout.TRIPS + slot].add_(n)

    def zero(self):
        self.buf[_Layout.NS:].zero_()

    def read(self) -> np.ndarray:
        return self.buf.cpu().numpy()

    def _resolution(self) -> int:
        """The median step between successive distinct clock readings."""
        n = 64
        stamp_kernel(self.lib.pam_stamp_ticks, self.probe.data_ptr(), n,
                     self.idle.cuda_stream)
        self.idle.synchronize()
        ticks = self.probe[:n + 1].cpu().numpy()
        if (ticks[:n] < 0).any():
            raise RuntimeError("the card's clock (%globaltimer) did not "
                               "advance")
        return int(np.median(np.diff(np.concatenate([ticks[n:], ticks[:n]]))))

    def calibrate(self) -> tuple:
        """(offset, uncertainty) in ns of the card's clock against
        ``time.perf_counter_ns``: the tightest of :data:`CALIBRATION` host
        brackets around a stamp kernel on an idle stream, the stamp taken
        at the bracket's middle."""
        brackets = []
        for i in range(CALIBRATION):
            self.idle.synchronize()
            t0 = time.perf_counter_ns()
            stamp_kernel(self.lib.pam_stamp_now,
                         self.probe.data_ptr() + 8 * i, self.idle.cuda_stream)
            self.idle.synchronize()
            brackets.append((time.perf_counter_ns() - t0, t0))
        stamps = self.probe[:CALIBRATION].cpu().tolist()
        width, t0 = min(brackets)
        at = stamps[brackets.index((width, t0))]
        return at - (t0 + width // 2), width // 2 + self.resolution_ns


class _HostStamps:
    """The same accumulators on the host's clock, for CPU runs."""

    clock = "host"
    resolution_ns = 1

    def __init__(self):
        self.device = torch.device("cpu")
        self.trips = torch.zeros(SLOTS, dtype=torch.int64)
        self.zero()
        self.begins = [0] * SLOTS

    def begin(self, slot: int):
        self.begins[slot] = time.perf_counter_ns()

    def end(self, slot: int, ring: bool):
        t, b = time.perf_counter_ns(), self.begins[slot]
        self.ns[slot] += t - b
        self.count[slot] += 1
        if ring:
            self.ring_n += 1
            if len(self.ring) < 3 * RING:
                self.ring.extend((slot, b, t))

    def add_trips(self, slot: int, n):
        self.trips[slot].add_(n)

    def zero(self):
        self.ns, self.count = [0] * SLOTS, [0] * SLOTS
        self.trips.zero_()
        self.ring, self.ring_n = [], 0

    def read(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.begins + self.ns + self.count, np.int64),
            self.trips.numpy(), np.asarray([self.ring_n] + self.ring,
                                           np.int64)])

    def calibrate(self) -> tuple:
        return 0, 0


@dataclasses.dataclass(eq=False)
class _Tracer:
    """The tracer's state: on or off, the names' slots, each device's
    accumulators, the host spans and the clocks' offset at
    :func:`enable`."""
    on: bool = False
    slots: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    loops: list = dataclasses.field(default_factory=list)
    backends: dict = dataclasses.field(default_factory=dict)
    stamps: object = None
    host: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=RING))
    host_n: int = 0
    offset: tuple = (0, 0)

    def slot(self, name: str, kind: list) -> int:
        s = self.slots.get(name)
        if s is None:
            if len(self.slots) == SLOTS:
                raise RuntimeError(f"the tracer holds {SLOTS} names; "
                                   f"{name!r} is one more")
            s = self.slots[name] = len(self.slots)
        if name not in kind:
            kind.append(name)
        return s


_T = _Tracer()
# per thread: stamps paused (a capture's warm-up step), the depth of loop
# bodies being run or captured, the spans open
_local = threading.local()
_OFF = contextlib.nullcontext()


def _depth(name: str) -> int:
    return getattr(_local, name, 0)


@contextlib.contextmanager
def _deeper(name: str):
    setattr(_local, name, _depth(name) + 1)
    try:
        yield
    finally:
        setattr(_local, name, _depth(name) - 1)


def paused():
    """Spans and trips inside record nothing but their ``record_function``
    (``ops/graph.py``'s warm-up step before a capture)."""
    return _deeper("paused")


def loop_body():
    """The block is a loop's body (``ops/graph.py::while_loop`` marks it):
    its spans add a trip at a time and append nothing to the timeline.
    Off: nothing."""
    if not _T.on:
        return _OFF
    return _deeper("body")


def active() -> bool:
    """Whether the tracer is on."""
    return _T.on


def _recording() -> bool:
    return _T.on and not _depth("paused")


class _Span:
    __slots__ = ("name", "rf", "slot", "ring")

    def __init__(self, name: str):
        self.name = name
        self.rf = record_function(name)
        self.slot = None

    def __enter__(self):
        self.rf.__enter__()
        if _recording():
            opened = _local.__dict__.setdefault("opened", set())
            if self.name in opened:
                raise RuntimeError(f"span {self.name!r} opened inside itself")
            opened.add(self.name)
            self.slot = _T.slot(self.name, _T.spans)
            self.ring = _depth("body") == 0
            _T.stamps.begin(self.slot)
        return self

    def __exit__(self, *exc):
        if self.slot is not None:
            _local.opened.discard(self.name)
            if exc[0] is None:
                _T.stamps.end(self.slot, self.ring)
        return self.rf.__exit__(*exc)


def span(name: str):
    """A layer of the program, as a context manager. Off: ``torch.profiler
    .record_function(name)`` alone. On: also a stamp kernel on entering and
    one on leaving (the host's clock on the CPU), whose difference adds
    into the span's time and count, on the device, in a captured graph's
    replays too."""
    if not _T.on:
        return record_function(name)
    return _Span(name)


def add_trips(name: str, n):
    """Add a loop's trips ``n`` (an int, or a 0-d integer tensor on the
    device that the loop ran on: under capture, the WHILE node's trip
    count, added after the node in every replay) to the loop ``name``."""
    if _recording():
        _T.stamps.add_trips(_T.slot(name, _T.loops), n)


class _HostSpan:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _T.host.append((self.name, self.t0, time.perf_counter_ns()))
        _T.host_n += 1
        return self.rf.__exit__(*exc)


def host_span(name: str):
    """What the host does (a graph's launch, the copies around it, a
    synchronisation), as a context manager. On: (name, begin, end) on
    ``time.perf_counter_ns`` and a ``record_function``. Off: nothing.
    ``profile_step --compiled`` names the host span over each wide gap
    between replays on the timeline."""
    if not _T.on:
        return _OFF
    return _HostSpan(name)


def enable(device=None):
    """Turn the tracer on for ``device`` (the card where there is one,
    else the CPU): its accumulators made (once a device), the offset of
    its clock to the host's measured. Steps captured while it is on are
    other graphs than those captured while it is off (``MmfDriver.
    _graphed_single``'s key)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stamps = _T.backends.get(device)
    if stamps is None:
        stamps = _T.backends[device] = (_DeviceStamps(device)
                                        if device.type == "cuda"
                                        else _HostStamps())
    _T.stamps = stamps
    _T.offset = stamps.calibrate()
    _T.on = True


def disable():
    """Turn the tracer off; its accumulators keep what they hold."""
    _T.on = False


def reset():
    """Zero every accumulator, the timeline and the host spans."""
    if _T.stamps is not None:
        _T.stamps.zero()
    _T.host.clear()
    _T.host_n = 0


def snapshot() -> dict:
    """Everything the tracer holds, read with one synchronisation:

    - ``spans``: {name: (ns, count)}, the time in each span and its
      entries, summed over eager steps and replays (a span in a loop body
      once a trip);
    - ``trips``: {loop name: trips};
    - ``ring``: [(name, begin, end)] of the spans outside loop bodies, in
      order, on ``time.perf_counter_ns``'s clock; ``ring_dropped`` the
      entries that did not fit (:data:`RING`);
    - ``host``: [(name, begin, end)] of the host spans, the same clock;
      ``host_dropped``;
    - ``clock`` ("device" or "host"), ``resolution_ns`` (the card's clock's
      step), ``offset_ns`` and ``offset_err_ns`` (the card's clock less the
      host's, as :func:`enable` measured it, and its uncertainty), and
      ``drift_ns``: the offset measured now less that.
    """
    stamps = _T.stamps
    if stamps is None:
        raise RuntimeError("observe.snapshot before observe.enable")
    raw = stamps.read()
    offset, err = _T.offset
    out = {"clock": stamps.clock, "device": str(stamps.device),
           "resolution_ns": stamps.resolution_ns, "offset_ns": offset,
           "offset_err_ns": err}
    names = {s: n for n, s in _T.slots.items()}
    out["spans"] = {n: (int(raw[_Layout.NS + _T.slots[n]]),
                        int(raw[_Layout.COUNT + _T.slots[n]]))
                    for n in _T.spans}
    out["trips"] = {n: int(raw[_Layout.TRIPS + _T.slots[n]])
                    for n in _T.loops}
    total = int(raw[_Layout.RING_N])
    kept = min(total, (len(raw) - _Layout.ENTRIES) // 3)
    ring = raw[_Layout.ENTRIES:_Layout.ENTRIES + 3 * kept].reshape(kept, 3)
    out["ring"] = [(names[int(s)], int(b) - offset, int(e) - offset)
                   for s, b, e in ring]
    out["ring_dropped"] = total - kept
    out["host"] = list(_T.host)
    out["host_dropped"] = _T.host_n - len(_T.host)
    out["drift_ns"] = stamps.calibrate()[0] - offset
    return out

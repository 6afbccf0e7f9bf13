"""Loops decided on the device, and a step captured as one CUDA graph.

pam_tpu never runs a CRM step op by op: every route compiles the step into
one XLA program, whose data-dependent loops are ``jax.lax.while_loop``s
(Kessler's rain sub-cycles, P3's sedimentation rounds, AWFL's acoustic
sub-cycles), so no host ever reads their trip counts. XLA provides that
loop; this module is the port's counterpart.

- :func:`while_loop` has ``lax.while_loop``'s contract. Eager (a CPU
  carry, or CUDA with nothing being captured) it is a Python loop that
  reads the predicate every trip. Inside :class:`Graphed`'s capture it is
  a CUDA WHILE node (``csrc/graph_while.cu``): the predicate and the body
  are captured once, on the capture's own stream, and the device decides
  every trip.
- :func:`fori_loop` runs a body a counted number of times. With a count
  that is a device tensor it reads the count once on the eager route
  (the port's eager steps keep their one read a loop) and loops on
  ``i < n`` on the device route.
- :func:`device_loops` says which route the physics takes: the device
  route under capture and inside :func:`no_host_reads`, the guard that
  makes every host read of a tensor raise, outside a while loop's eager
  predicate. On the CPU it runs the device route's code as capture would.
- :func:`count`, :func:`publish` and :func:`check` are how the step hands
  the host what it used to read: launch and trip counts, the last trip
  count, and a range check. Under capture they are recorded, and
  :class:`Graphed` applies them after every replay, on the device.
- :class:`Graphed` captures a function of a dict of tensors (the CRM
  step) into one CUDA graph (``GraphedFunction``: one a keys, shapes,
  dtypes, device and caller's key): static inputs, a warm-up step, the
  capture, then a replay a call that returns fresh tensors, as
  ``jax.jit`` returns new arrays. On CPU tensors it calls the function.
  PyTorch binds no WHILE node, and a body captured on a second stream, as
  its IF node's is, keeps its memory apart from the step's (the caching
  allocator gives a freed block only to the stream that allocated it), so
  the capture is ``csrc/graph_while.cu``'s, on one stream; its tensors
  live in a private pool of PyTorch's caching allocator, as
  ``torch.cuda.graph``'s do.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
import traceback
import weakref

import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

from ..utils import observe

_tls = threading.local()


def _get(name, default=None):
    return getattr(_tls, name, default)


class HostReadError(RuntimeError):
    """A tensor's value was read on the host where the step must leave it
    on the device."""


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

_READS = {torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
          torch.Tensor.__index__, torch.Tensor.item, torch.Tensor.tolist,
          torch.Tensor.numpy, torch.Tensor.cpu}
# host data copied onto a device: a synchronising copy, refused in capture
_FACTORIES = {torch.tensor, torch.as_tensor, torch.asarray}
# an index that is a list or array is such a copy too
_INDEXING = {torch.Tensor.__getitem__, torch.Tensor.__setitem__}


def _host_index(index) -> bool:
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(p, list) or type(p).__module__ == "numpy"
               and getattr(p, "ndim", 0) > 0 for p in parts)


def _caller() -> str:
    """file:line of the innermost frame outside this module and torch."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if frame.filename != __file__ and "/torch/" not in frame.filename:
            return f"{frame.filename}:{frame.lineno} ({frame.line})"
    return "?"


class _NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _get("in_predicate", False):
            if func in _READS:
                raise HostReadError(
                    f"host read of a tensor (Tensor.{func.__name__}) at "
                    f"{_caller()}: the step must keep this value on the "
                    "device")
            if (func in _FACTORIES and kwargs.get("device") is not None
                    and args and not isinstance(args[0], torch.Tensor)):
                raise HostReadError(
                    f"torch.{func.__name__} of host data onto "
                    f"{kwargs['device']} at {_caller()}: a synchronising "
                    "copy in the step; build it once, outside the step")
            if func in _INDEXING and _host_index(args[1]):
                raise HostReadError(
                    f"a list or array index (Tensor.{func.__name__}) at "
                    f"{_caller()}: a host copy of the index in the step")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_reads():
    """Inside the block every host read of a tensor (``bool``, ``int``,
    ``float``, ``item``, ``tolist``, ``numpy``, ``cpu``) and every host copy
    onto a device (``torch.tensor`` of host data, a list or array index)
    raises :class:`HostReadError`, except
    :func:`while_loop`'s eager predicate, and the physics takes the device
    route (:func:`device_loops`). Range checks made inside (:func:`check`)
    are read, and raise, as the block ends."""
    pending = []
    _tls.guard = _get("guard", 0) + 1
    outer, _tls.pending = _get("pending"), pending
    try:
        with _NoHostReads():
            yield
    finally:
        _tls.guard -= 1
        _tls.pending = outer
    for ok, exc, message, values in pending:
        if not bool(ok):
            raise exc(message(*(int(v) for v in values)))


def device_loops() -> bool:
    """Whether the trip counts stay on the device: inside a capture, or
    inside :func:`no_host_reads`."""
    return _get("recorder") is not None or _get("guard", 0) > 0


# ---------------------------------------------------------------------------
# what the host used to read: counts, the last trip count, range checks
# ---------------------------------------------------------------------------

def count(owner, attr: str, n=1):
    """Add ``n`` (an int, or a 0-d tensor on the device) to
    ``owner.attr``: a kernel wrapper's launch count, a loop's trip count.
    Under capture the addition is made after every replay, times the trips
    of the loop whose body is being captured."""
    rec = _get("recorder")
    if rec is not None:
        rec.count(owner, attr, n)
    elif not _get("quiet", False):
        setattr(owner, attr, getattr(owner, attr) + n)


def publish(owner, attr: str, value: torch.Tensor):
    """Set ``owner.attr`` to a 0-d tensor the step computed (Kessler's
    last rainsplit count); under capture, to a copy of its value after
    every replay."""
    rec = _get("recorder")
    if rec is not None:
        rec.publish(owner, attr, value)
    elif not _get("quiet", False):
        setattr(owner, attr, value)


def check(ok: torch.Tensor, exc: type, message, *values):
    """Raise ``exc(message(*values))`` unless the 0-d bool ``ok`` holds,
    with ``values`` (0-d integer tensors) read as ints. Eager: at once.
    Inside :func:`no_host_reads`: as the block ends. Under capture:
    accumulated over replays, raised by :meth:`Graphed.check`."""
    rec = _get("recorder")
    if rec is not None:
        rec.checks.append((ok, exc, message, values))
    elif _get("guard", 0) > 0:
        _tls.pending.append((ok, exc, message, values))
    elif not bool(ok):
        raise exc(message(*(int(v) for v in values)))


@contextlib.contextmanager
def _quiet():
    """count, publish and the tracer's stamps and trips change nothing
    inside (the warm-up steps)."""
    outer, _tls.quiet = _get("quiet", False), True
    try:
        with observe.paused():
            yield
    finally:
        _tls.quiet = outer


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------

def _predicate(pred) -> torch.Tensor:
    if not (isinstance(pred, torch.Tensor) and pred.dim() == 0
            and pred.dtype == torch.bool):
        raise ValueError(
            "while_loop: cond_fn must return a 0-d bool tensor, got "
            + (f"{pred.dtype} of shape {tuple(pred.shape)}"
               if isinstance(pred, torch.Tensor) else type(pred).__name__))
    return pred


def _read(pred) -> bool:
    _tls.in_predicate = True
    try:
        return bool(_predicate(pred))
    finally:
        _tls.in_predicate = False


def while_loop(cond_fn, body_fn, carry, counter=None, name=None):
    """``jax.lax.while_loop``: ``carry = body_fn(carry)`` while
    ``cond_fn(carry)``, a 0-d bool tensor on the carry's device, holds.
    The carry is a tuple, list or dict (nested or not) of tensors whose
    shapes and dtypes the body keeps. ``counter=(owner, attr)`` adds the
    number of trips to ``owner.attr`` (:func:`count`); ``name`` adds them
    to the tracer's loop of that name (``utils/observe.py::add_trips``),
    where the tracer is on."""
    rec = _get("recorder")
    if rec is not None:
        return rec.while_loop(cond_fn, body_fn, carry, counter, name)
    leaves = pytree.tree_leaves(carry)
    if (leaves and leaves[0].is_cuda
            and torch.cuda.is_current_stream_capturing()):
        raise CaptureError("while_loop under a CUDA graph capture that "
                           "ops/graph.py's Graphed did not start")
    trips = 0
    while _read(cond_fn(carry)):
        with observe.loop_body():
            carry = body_fn(carry)
        trips += 1
    if counter is not None:
        count(*counter, trips)
    if name is not None:
        observe.add_trips(name, trips)
    return carry


def fori_loop(n, body_fn, carry, name=None):
    """``carry = body_fn(carry)`` ``n`` times. ``n`` is an int or a 0-d
    integer tensor; the eager route reads such a tensor once, the device
    route (:func:`device_loops`) loops on ``i < n`` with it on the device.
    ``name``: the tracer's loop that the trips add to (:func:`while_loop`).
    """
    if isinstance(n, torch.Tensor):
        if not device_loops():
            n = int(n)
        else:
            i0 = torch.zeros_like(n)
            _, carry = while_loop(lambda c: c[0] < n,
                                  lambda c: (c[0] + 1, body_fn(c[1])),
                                  (i0, carry), name=name)
            return carry
    for _ in range(n):
        with observe.loop_body():
            carry = body_fn(carry)
    if name is not None:
        observe.add_trips(name, n)
    return carry


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _lib():
    from .. import _cuda
    return _cuda.library()


class _Recorder:
    """What one capture records beside its graph: the counts, values and
    checks the host applies after every replay."""

    def __init__(self, device):
        self.device = device
        self.trips = None      # the trip counter of the body being captured
        self.adds = {}         # (id owner, attr, id trips) -> [o, a, t, n]
        self.tensor_adds = {}  # (id owner, attr) -> [owner, attr, tensor]
        self.values = []       # (owner, attr, tensor)
        self.checks = []       # (ok, exc, message, values)

    def count(self, owner, attr, n):
        if isinstance(n, torch.Tensor):
            if self.trips is not None:
                raise CaptureError(f"count({attr}) of a tensor inside a "
                                   "while_loop body under capture")
            self._add_tensor(owner, attr, n)
            return
        key = (id(owner), attr, id(self.trips))
        entry = self.adds.setdefault(key, [owner, attr, self.trips, 0])
        entry[3] += n

    def _add_tensor(self, owner, attr, n):
        """Add the 0-d device tensor ``n`` to ``owner.attr`` after every
        replay; a second tensor for the same counter is summed in the
        graph, so that each counter takes one tensor."""
        n = n.to(torch.int64)
        entry = self.tensor_adds.get((id(owner), attr))
        if entry is None:
            self.tensor_adds[(id(owner), attr)] = [owner, attr, n]
        else:
            entry[2] = entry[2] + n

    def publish(self, owner, attr, value):
        if self.trips is not None:
            raise CaptureError(f"publish({attr}) inside a while_loop body "
                               "under capture")
        self.values.append((owner, attr, value))

    def while_loop(self, cond_fn, body_fn, carry, counter, name):
        """A WHILE node in the graph being captured on the current stream,
        its body captured from ``body_fn`` on the same stream."""
        if self.trips is not None:
            raise CaptureError("nested while_loop under capture")
        leaves, spec = pytree.tree_flatten(carry)
        # the body rewrites fixed addresses: the loop's own copies
        bufs = [t.clone() for t in leaves]
        trips = torch.zeros((), dtype=torch.int64, device=self.device)
        state = pytree.tree_unflatten(bufs, spec)
        pred = _predicate(cond_fn(state))
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        handle = ctypes.c_ulonglong()
        parent, node = ctypes.c_void_p(), ctypes.c_void_p()
        rc = lib.pam_while_begin(stream, pred.data_ptr(), ctypes.byref(handle),
                                 ctypes.byref(parent), ctypes.byref(node))
        if rc != 0:
            raise CaptureError(f"pam_while_begin: CUDA error {rc}")
        self.trips = trips
        ended = False
        try:
            with observe.loop_body():
                new, new_spec = pytree.tree_flatten(body_fn(state))
            if new_spec != spec:
                raise ValueError(f"while_loop: the body returned {new_spec}, "
                                 f"the carry is {spec}")
            for i, (b, n) in enumerate(zip(bufs, new)):
                if n.shape != b.shape or n.dtype != b.dtype:
                    raise ValueError(
                        f"while_loop: carry leaf {i} is {b.dtype}"
                        f"{tuple(b.shape)}, the body returned {n.dtype}"
                        f"{tuple(n.shape)}")
            # a leaf that moved to another place of the carry is copied
            # before its old place is overwritten
            src = [n.clone() if n is not b and any(n is o for o in bufs)
                   else n for b, n in zip(bufs, new)]
            for b, n in zip(bufs, src):
                if n is not b:
                    b.copy_(n)
            trips.add_(1)
            pred2 = _predicate(cond_fn(state))
            rc = lib.pam_while_end(stream, handle.value, pred2.data_ptr(),
                                   parent, node)
            ended = True
            if rc != 0:
                raise CaptureError(f"pam_while_end: CUDA error {rc}")
        finally:
            self.trips = None
            if not ended:
                lib.pam_while_abort(stream, parent, node)
        # the body's counts: trips times each, in the graph after the node
        for key in [k for k, e in self.adds.items() if e[2] is trips]:
            owner, attr, _, n = self.adds.pop(key)
            self._add_tensor(owner, attr, trips * n)
        if counter is not None:
            self.count(*counter, trips)
        if name is not None:
            observe.add_trips(name, trips)
        return state

    def after_replay(self):
        """The recorded counts and values, applied on the host's side: the
        counts the graph computed as one operation for all of them (two
        while a counter still holds a host int), each a new tensor, so
        that a value read before stays as it was."""
        for owner, attr, _, n in self.adds.values():
            setattr(owner, attr, getattr(owner, attr) + n)
        entries = list(self.tensor_adds.values())
        olds = [getattr(o, a) for o, a, _ in entries]
        held = [isinstance(v, torch.Tensor) for v in olds]
        tensors = [i for i, h in enumerate(held) if h]
        ints = [i for i, h in enumerate(held) if not h]
        new = []
        if tensors:
            new += zip(tensors, torch._foreach_add(
                [olds[i] for i in tensors], [entries[i][2] for i in tensors]))
        if ints:
            new += zip(ints, torch._foreach_add(
                [entries[i][2] for i in ints], [olds[i] for i in ints]))
        for i, v in new:
            setattr(entries[i][0], entries[i][1], v)
        for owner, attr, t in self.values:
            setattr(owner, attr, t.clone())


_streams = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The one stream a device that warm-ups and captures run on: PyTorch
    keeps a cuBLAS workspace for every stream that ran a cuBLAS call and
    never frees it, so a new stream a capture would keep one a graph."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


def _release(device, pool, exec_):
    if exec_.value:
        _lib().pam_graph_destroy(exec_)
    torch._C._cuda_releasePool(device.index, pool)


class Graphed:
    """``fn`` (a dict of tensors -> a dict of tensors, on one CUDA device)
    captured into one CUDA graph for the keys, shapes, dtypes and device
    of ``example``. A call copies its inputs into the graph's static
    inputs, replays it and returns fresh tensors; :meth:`check` raises a
    range check that failed in any replay so far.

    The capture is ``csrc/graph_while.cu``'s, on the device's capture
    stream (:func:`_capture_stream`), its
    tensors in a private pool of PyTorch's caching allocator: a warm-up
    step on the stream first (the lazily built tables, kernel libraries
    and library handles come into being outside capture), then the
    capture, under :func:`no_host_reads`. The warm-up step counts and
    publishes nothing, so a kernel's count is its launches in the
    replays.

    With the tracer on (``utils/observe.py``) the capture, each phase of a
    call (the copies in, the launch, the copies out, the counts and checks
    applied after it) and :meth:`check` are host spans."""

    def __init__(self, fn, example: dict):
        with observe.host_span("host:graph.capture"):
            self._capture(fn, example)

    def _capture(self, fn, example: dict):
        device = next(iter(example.values())).device
        for k, v in example.items():
            if not isinstance(v, torch.Tensor) or v.device != device:
                raise CaptureError(f"input {k!r} is not a tensor on {device}")
        t0 = time.perf_counter()
        self.device = device
        self.keys = list(example)
        self.inputs = {k: v.clone() for k, v in example.items()}
        side = _capture_stream(device)
        with _quiet():
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn({k: v.clone() for k, v in self.inputs.items()})
            torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        lib = _lib()
        pool = torch.cuda.graph_pool_handle()
        self.exec = ctypes.c_void_p()
        rec = _Recorder(device)
        cause = None
        with torch.cuda.stream(side):
            stream = side.cuda_stream
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index, pool)
            # the pool goes when the graph does (not at exit: the
            # allocator may be gone by then)
            weakref.finalize(self, _release, device, pool, self.exec).atexit \
                = False
            try:
                graph_ = ctypes.c_void_p()
                rc = lib.pam_capture_begin(stream, ctypes.byref(graph_))
                if rc != 0:
                    raise CaptureError(f"pam_capture_begin: CUDA error {rc}")
                _tls.recorder = rec
                try:
                    with no_host_reads():
                        out = fn(dict(self.inputs))
                except Exception as e:   # reported with the capture's end
                    cause = e
                finally:
                    _tls.recorder = None
                rc = lib.pam_capture_end(stream, graph_, int(cause is None),
                                         ctypes.byref(self.exec))
                if rc != 0 and cause is None:
                    cause = CaptureError(f"pam_capture_end: CUDA error {rc}")
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool)
        if cause is not None:
            raise CaptureError(f"capture of {getattr(fn, '__qualname__', fn)}"
                               f" failed: {cause}") from cause
        for k, v in out.items():
            if not isinstance(v, torch.Tensor):
                raise CaptureError(f"output {k!r} is not a tensor")
        self.outputs = out
        self.recorder = rec
        self.faults = [(torch.zeros((), dtype=torch.bool, device=device),
                        [torch.zeros_like(v) for v in values], ok, values,
                        exc, message)
                       for ok, exc, message, values in rec.checks]
        self.capture_s = time.perf_counter() - t0

    def __call__(self, state: dict) -> dict:
        with observe.host_span("host:graph.copy_in"):
            torch._foreach_copy_([self.inputs[k] for k in self.keys],
                                 [state[k] for k in self.keys])
        with observe.host_span("host:graph.launch"):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = _lib().pam_graph_launch(self.exec, stream)
            if rc != 0:
                raise RuntimeError(f"pam_graph_launch: CUDA error {rc}")
        with observe.host_span("host:graph.copy_out"):
            outs = {k: torch.empty_like(v) for k, v in self.outputs.items()}
            torch._foreach_copy_(list(outs.values()),
                                 list(self.outputs.values()))
        with observe.host_span("host:graph.after_replay"):
            self.recorder.after_replay()
            for bad, first, ok, values, _, _ in self.faults:
                # the values of the first failing replay, then the flag
                for f, v in zip(first, values):
                    f.copy_(torch.where(bad, f, v))
                bad.logical_or_(ok.logical_not())
        return outs

    def check(self):
        """Raise the first range check that failed in a replay so far
        (one host read for all of them)."""
        with observe.host_span("host:graph.check"):
            bads = (torch.stack([f[0] for f in self.faults]).tolist()
                    if self.faults else [])
        for is_bad, (_, first, _, _, exc, message) in zip(bads, self.faults):
            if is_bad:
                raise exc(message(*(int(v) for v in first)))


class GraphedFunction:
    """``fn`` through :class:`Graphed`, one graph a key: the inputs' keys,
    shapes, dtypes and device, and ``key()`` (what else ``fn`` depends
    on). CPU inputs go to ``fn`` itself. A capture that fails raises; it
    never falls back to ``fn``."""

    def __init__(self, fn, key=lambda: ()):
        self.fn = fn
        self.key = key
        self.graphs = {}

    def __call__(self, state: dict) -> dict:
        if not next(iter(state.values())).is_cuda:
            return self.fn(state)
        key = (tuple((k, tuple(v.shape), v.dtype, v.device)
                     for k, v in state.items()), self.key())
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = Graphed(self.fn, state)
        return g(state)

    def check(self):
        """:meth:`Graphed.check` of every graph captured."""
        for g in self.graphs.values():
            g.check()

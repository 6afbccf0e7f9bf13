"""The program under test, ``pam_tpu_torch``, driven as its GCM loop runs
it (``MmfDriver.run`` in ``mb_mode`` "host", as ``run_mmf`` hands it the
state): the state in chunks of the driver's ensemble; at each GCM step the
forcing of every chunk (``MmfDriver._forcing``), then every CRM step
``MmfDriver.step_chunks`` with the compiled step
(``MmfDriver._graphed_single``), and at the GCM step's end its range
checks and a host synchronisation, as the GCM reading the CRMs back.

This module is the benchmark's only importer of the program."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pam_tpu_torch.driver import mmf, standalone


def member_seeds(seed: int, nens: int, chunk: int) -> np.ndarray:
    """The temperature perturbation's seed of each member: the
    deployment's own members (``run_mmf``'s seeds 0 .. nens-1), each
    chunk of ``chunk`` holding the members that ``run_mmf`` gives it, all
    chunks in one order drawn from ``seed``. The driver, built at the
    first chunk, keeps per-member tables that the other chunks take by
    position, so one order for all chunks keeps every member with the
    tables ``run_mmf`` gives it: every run seed steps the same weather,
    the same work (Kessler's rain sub-cycles and P3's sedimentation
    rounds follow it)."""
    order = np.random.default_rng(int(seed)).permutation(chunk)
    return np.concatenate([c0 + order for c0 in range(0, nens, chunk)]
                          ).astype(np.uint64)


def run_settings(config: dict, traffic: dict) -> dict:
    """The configuration's settings as the program's YAML reader takes
    them, with the traffic's ensemble."""
    run = dict(config["run"])
    run["nens"] = int(traffic["nens"])
    run["ens_chunk"] = traffic.get("ens_chunk")
    return run


class HostCopies:
    """Host buffers, pinned on a card, that the loop copies the chunks it
    samples into: made in set-up, so the card holds nothing for the check
    and its memory is the program's alone, whichever steps are sampled."""

    def __init__(self, example: dict, n: int):
        pin = example["temp"].is_cuda
        self.free = []
        for _ in range(n):
            # one allocation a copy: pinning is slow per call
            size = sum(-(-v.nbytes // 64) * 64 for v in example.values())
            raw = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
            views, at = {}, 0
            for k, v in example.items():
                views[k] = raw[at:at + v.nbytes].view(v.dtype).view(v.shape)
                at += -(-v.nbytes // 64) * 64
            self.free.append(views)

    def take(self, state: dict) -> dict:
        """A copy of ``state``, ready once the stream has passed this
        point."""
        buf = self.free.pop()
        return {k: buf[k].copy_(v, non_blocking=True)
                for k, v in state.items()}


@dataclasses.dataclass(eq=False)
class System:
    drv: object
    chunks: list          # the state, in driver-sized chunks
    step: object          # the compiled chunk step
    nens: int
    chunk: int
    ncrm: int             # CRM steps a GCM step
    gridpoints: int       # nens * nx * ny * nz
    copies: HostCopies = None


def build(config: dict, traffic: dict, seed: int, device: str = "cuda"
          ) -> System:
    """The driver and the state as ``run_mmf`` builds them: the driver at
    the chunk (``ens_chunk``: the program's own ``pick_ens_chunk`` for
    "auto"), the state at the ensemble, split into chunks."""
    run = run_settings(config, traffic)
    kw = standalone.mmf_setup_kwargs(run, device)
    nens = kw["nens"]
    chunk = standalone.check_ens_chunk(run, kw) or nens
    seeds = member_seeds(seed, nens, chunk)
    drv, state = mmf.setup_supercell_mmf(**dict(kw, nens=chunk),
                                         perturb_seeds=seeds[:chunk])
    if chunk < nens:
        _, state = mmf.setup_supercell_mmf(**kw, perturb_seeds=seeds,
                                           state_only=True)
        chunks = list(mmf._split_ens(state, nens // chunk))
    else:
        chunks = [state]
    del state
    return System(drv=drv, chunks=chunks, step=drv._graphed_single(),
                  nens=nens, chunk=chunk,
                  ncrm=int(round(drv.dt_gcm / drv.dt_crm_phys)),
                  gridpoints=nens * kw["nx"] * kw["ny"] * kw["nz"])


def warm_up(system: System, n_copies: int = 0):
    """A GCM boundary and two replays on a copy of the first chunk: the
    kernels built or loaded, the step captured for the chunk's shape, the
    forcing run once; the state itself is left as it was. Makes
    ``n_copies`` host copies of a chunk for the loop's samples."""
    w = {k: v.clone() for k, v in system.chunks[0].items()}
    w = system.drv._forcing(w)
    system.copies = HostCopies(w, n_copies)
    for _ in range(2):
        w = system.step(w)
    system.step.check()
    synchronize(system)
    del w


def synchronize(system: System):
    if system.chunks[0]["temp"].is_cuda:
        torch.cuda.synchronize()


def kernel_launches() -> dict:
    """The launch counters of the kernels B1, B3 and B4, read once the
    card has done the work queued so far: B3 launches in AWFL's acoustic
    sub-cycles, a WHILE node of the compiled step whose trips the device
    decides, so the compiled step adds its count on the device (0 where
    no AWFL step ran)."""
    from pam_tpu_torch.ops import awfl_flux, p3_part2, weno_x
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return {"b1": int(weno_x.weno_edges_x_cuda.launches),
            "b3": int(awfl_flux.flux_direction_cuda.launches),
            "b4": int(p3_part2.p3_part2_cuda.launches)}


class _HostMark:
    """A CUDA event's interface on the host's clock (CPU runs in tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def mark(cuda: bool):
    """An event recorded now on the current stream."""
    e = torch.cuda.Event(enable_timing=True) if cuda else _HostMark()
    e.record()
    return e


@dataclasses.dataclass
class Loop:
    """What the GCM loop recorded."""
    step_ms: list = dataclasses.field(default_factory=list)
    snaps: dict = dataclasses.field(default_factory=dict)
    # (label, begin ms, end ms, host seconds) of each span of the window,
    # where the loop records them; ms from the window's start on the
    # device's clock
    spans: list = dataclasses.field(default_factory=list)
    steps_done: int = 0   # every CRM step taken, in the window or after


def gcm_loop(system: System, seconds: float, samples=(), chunk_index=0,
             spans: bool = False, start: int = 0, nsteps: int = None,
             fault=None) -> Loop:
    """CRM steps from step ``start`` (counted from t=0) in the closed loop
    of the GCM: each after the last. ``nsteps`` steps, or as many as end
    within ``seconds`` on the host's clock and then on until every step
    in ``samples`` is taken. ``step_ms`` holds the device interval of each
    step of the window: a step spans every chunk, and a GCM boundary's
    step its forcing and its synchronisation. ``snaps[i]`` holds host
    copies (``system.copies``) of the chunk ``chunk_index`` before step i
    (and its forcing) and after it.
    With ``spans`` each call into the driver and each synchronisation is
    bracketed by events and timed on the host. ``fault(i, stepped,
    chunks)`` (for tests) may change the chunks after step i, ``stepped``
    the chunks that the step took."""
    drv, step, chunks = system.drv, system.step, system.chunks
    cuda = chunks[0]["temp"].is_cuda
    out = Loop()
    pending = set(int(i) for i in samples)
    edges = [mark(cuda)]
    t0 = time.perf_counter()
    i, closed = start, False

    raw = []

    def span(label, fn):
        if not spans or closed:
            return fn()
        h0 = time.perf_counter()
        b = mark(cuda)
        r = fn()
        e = mark(cuda)
        raw.append((label, b, e, time.perf_counter() - h0))
        return r

    def forcing():
        for j in range(len(chunks)):
            chunks[j] = drv._forcing(chunks[j])

    def gcm_sync():
        step.check()
        synchronize(system)

    while True:
        if i in pending:
            before = system.copies.take(chunks[chunk_index])
        if drv.apply_gcm_forcing and i % system.ncrm == 0:
            span("forcing", forcing)
        stepped = list(chunks) if fault is not None else None
        span("step_chunks", lambda: drv.step_chunks(chunks, step))
        if fault is not None:
            fault(i, stepped, chunks)
        if i in pending:
            out.snaps[i] = (before, system.copies.take(chunks[chunk_index]))
            pending.discard(i)
        if (i + 1) % system.ncrm == 0:
            span("gcm_sync", gcm_sync)
        i += 1
        if not closed:
            edges.append(mark(cuda))
            closed = (len(edges) - 1 == nsteps if nsteps is not None
                      else time.perf_counter() - t0 >= seconds)
        if closed and not pending:
            break
    synchronize(system)
    out.step_ms = [a.elapsed_time(b) for a, b in zip(edges, edges[1:])]
    out.spans = [(label, edges[0].elapsed_time(b), edges[0].elapsed_time(e),
                  host_s) for label, b, e, host_s in raw]
    out.steps_done = i - start
    return out


def profiled_compiled(system: System, start: int, nsteps: int) -> dict:
    """``nsteps`` CRM steps of the GCM loop from step ``start`` under
    ``torch.profiler``: the device operations, the steps, and the kernels'
    launches by their counters."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace
    before = kernel_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gcm_loop(system, 0.0, start=start, nsteps=nsteps)
        synchronize(system)
    after = kernel_launches()
    return {"steps": nsteps, "ops": trace.device_ops(prof),
            "launches": {k: after[k] - before[k] for k in after}}


def profiled_eager(system: System) -> dict:
    """One CRM step of every chunk through the eager step
    (``MmfDriver._crm_phys_step_single``, which launches the kernels that
    the graph captures, inside the program's ``pam:`` spans) under
    ``torch.profiler``; the state is left as it was."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in system.chunks:
            system.drv._crm_phys_step_single(dict(c))
        synchronize(system)
    return {"steps": 1, "ops": trace.device_ops(prof),
            "spans": trace.span_device_s(prof)}

"""Probes of the program's tracer on the card, beside the benchmark.

    python3 benchmark/trace_probe.py <probe> <cell> [seconds]

Each probe builds the cell's system as a run builds it (``mmfbench/
program.py``, a fixed member seed a probe), drives the program's compiled
GCM loop and prints JSON lines. The benchmark's runs do not run this.

- ``cost``: from one forced state, the last CRM step of a GCM step and
  the next GCM step's (45 CRM steps, the GCM boundary between the first
  two), untraced and traced in turns (A B B A A B B A): CUDA-event ms a
  step of each, the traced runs' spans, trips and time outside the graph,
  and what the tracer costs, traced less untraced, over all eight.
- ``slow``: the tracer on from the warm-up, the GCM loop for ``seconds``
  (51 by default), a snapshot at each GCM step's sync (which waits
  already): the spans, trips and time outside the graph of every GCM
  step, beside its CUDA-event ms a step. Where a process's slow start
  sits: in a layer, in the trips, or in every span alike.
- ``cupti``: 3 CRM steps traced by the tracer and by ``torch.profiler``
  at once, twice: CUPTI's union of device operations against the
  tracer's ``pam:step``, and the stamp kernels the trace holds against
  those the tracer launched; then the kernels each ``pam:`` span launches
  in one eager step of one chunk (the tracer off).
- ``reconcile``: after ``seconds`` of the loop, one CRM step of every
  chunk from the same state, eager under ``torch.profiler`` (the
  benchmark's eager split: each span's device time, and its kernels) and
  replayed traced, twice (each span's device time inside the graph).
- ``idle2``: after ``seconds`` of the loop, the runner's profiled
  compiled stretch (``program.profiled_compiled``, 3 CRM steps from a GCM
  boundary), the tracer off, on, off, on: CUPTI's busy share, its widest
  gaps and the operations on each side of them, and, traced, the
  tracer's ``pam:step``.
"""

import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from mmfbench import program, spec, stats, trace  # noqa: E402
from pam_tpu_torch.utils import observe  # noqa: E402

TOP = ("pam:forcing", "pam:dycore", "pam:sponge", "pam:sgs", "pam:micro")


def table(snap, steps):
    """(ms a step of each span that ran, trips a step of each loop that
    ran, ms a step between replays on the timeline)."""
    spans = {n: round(ns / 1e6 / steps, 4) for n, (ns, c) in
             snap["spans"].items() if c}
    trips = {n: v / steps for n, v in snap["trips"].items() if v}
    ring = sorted((b, e) for n, b, e in snap["ring"] if n == "pam:step")
    out = sum(b - e for (_, e), (b, _) in zip(ring, ring[1:])) / 1e6
    return spans, trips, out / steps


def force(system):
    for j in range(len(system.chunks)):
        system.chunks[j] = system.drv._forcing(system.chunks[j])


def eager_kernels(prof) -> dict:
    """The device kernels each ``pam:`` span launched, in a profile of
    eager steps."""
    from torch.autograd import DeviceType

    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("pam:"):
            out[e.name] = out.get(e.name, 0) + kernels(e)
    return out


def cost(cell):
    c = spec.cell(cell)
    system = program.build(c.config, c.traffic, 12345)
    program.warm_up(system)
    observe.enable()
    program.warm_up(system)                 # the traced capture
    observe.disable()
    force(system)
    start = [{k: v.clone() for k, v in ch.items()} for ch in system.chunks]
    program.synchronize(system)
    res = []
    for traced in (False, True, True, False, False, True, True, False):
        system.chunks[:] = [{k: v.clone() for k, v in ch.items()}
                            for ch in start]
        program.synchronize(system)
        if traced:
            observe.enable()
            observe.reset()
        loop = program.gcm_loop(system, 0.0, start=system.ncrm - 1,
                                nsteps=system.ncrm)
        row = {"traced": traced,
               "ms": sum(loop.step_ms) / len(loop.step_ms)}
        if traced:
            snap = observe.snapshot()
            observe.disable()
            spans, trips, out = table(snap, len(loop.step_ms))
            row.update(spans=spans, trips=trips, outside=out,
                       err=snap["offset_err_ns"], drift=snap["drift_ns"],
                       res=snap["resolution_ns"])
        res.append(row)
        print(json.dumps(row), flush=True)
    off = [r["ms"] for r in res if not r["traced"]]
    on = [r["ms"] for r in res if r["traced"]]
    d = statistics.mean(on) - statistics.mean(off)
    print(json.dumps({"cell": cell, "untraced": off, "traced": on,
                      "cost_ms": d,
                      "cost_pct": 100 * d / statistics.mean(off)}),
          flush=True)


def slow(cell, seconds):
    c = spec.cell(cell)
    system = program.build(c.config, c.traffic, 777)
    observe.enable()
    program.warm_up(system)
    print(f"set-up {time.perf_counter() - T0:.2f} s", flush=True)
    drv, step, chunks = system.drv, system.step, system.chunks
    observe.reset()
    t0 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True)]
    ev[0].record()
    i = g0 = 0
    while True:
        if i % system.ncrm == 0:
            force(system)
        drv.step_chunks(chunks, step)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        i += 1
        if i % system.ncrm:
            continue
        step.check()
        torch.cuda.synchronize()
        snap = observe.snapshot()
        observe.reset()
        ms = [a.elapsed_time(b) for a, b in zip(ev[g0:], ev[g0 + 1:])]
        g0 = len(ev) - 1
        spans, trips, out = table(snap, system.ncrm)
        print(json.dumps({"gcm": i // system.ncrm,
                          "t": round(time.perf_counter() - t0, 2),
                          "ev_mean": statistics.mean(ms),
                          "ev_median": statistics.median(ms),
                          "outside": out,
                          "top_cover": sum(spans.get(n, 0) for n in TOP)
                          / spans["pam:step"],
                          "spans": spans, "trips": trips}), flush=True)
        if time.perf_counter() - t0 >= seconds:
            break
    observe.disable()


def cupti(cell):
    from torch.profiler import ProfilerActivity, profile
    c = spec.cell(cell)
    system = program.build(c.config, c.traffic, 4242)
    observe.enable()
    program.warm_up(system)
    force(system)
    for n in (3, 3):
        program.synchronize(system)
        observe.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop = program.gcm_loop(system, 0.0, start=1, nsteps=n)
            program.synchronize(system)
        snap = observe.snapshot()
        ops = trace.device_ops(prof)
        busy = stats.union_length([(s, e) for _, s, e in ops]) / 1e6
        window = (max(e for _, _, e in ops) - min(s for _, s, _ in ops)) / 1e6
        ring = [x for x in snap["ring"] if x[0] == "pam:step"]
        print(json.dumps({
            "cell": cell, "steps": n, "event_ms": sum(loop.step_ms),
            "cupti_busy_ms": busy, "cupti_window_ms": window,
            "cupti_busy_share": busy / window,
            "pam_step_ms": snap["spans"]["pam:step"][0] / 1e6,
            "ring_window_ms": (max(e for _, _, e in ring)
                               - min(b for _, b, _ in ring)) / 1e6,
            "n_ops": len(ops),
            "stamp_ops_in_trace": sum(1 for name, _, _ in ops
                                      if "stamp_" in name),
            "stamps_expected": 2 * sum(
                cnt for _, cnt in snap["spans"].values())}), flush=True)
    observe.disable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.drv._crm_phys_step_single(dict(system.chunks[0]))
        program.synchronize(system)
    print(json.dumps({"cell": cell,
                      "eager_kernels_by_span_one_chunk": eager_kernels(prof),
                      "eager_device_ops_one_chunk":
                          len(trace.device_ops(prof))}), flush=True)


def reconcile(cell, seconds):
    from torch.profiler import ProfilerActivity, profile
    c = spec.cell(cell)
    system = program.build(c.config, c.traffic, 99)
    program.warm_up(system)
    loop = program.gcm_loop(system, seconds)
    print(json.dumps({"window_steps": len(loop.step_ms),
                      "window_ms_mean": statistics.mean(loop.step_ms),
                      "last_gcm_median": statistics.median(
                          loop.step_ms[-system.ncrm:])}), flush=True)
    drv = system.drv
    if loop.steps_done % system.ncrm == 0:
        force(system)
    program.synchronize(system)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ch in system.chunks:
            drv._crm_phys_step_single(dict(ch))
        program.synchronize(system)
    eager = trace.span_device_s(prof)
    ops = trace.device_ops(prof)
    n_b1, b1 = trace.kernel_time(ops, "weno_x_kernel")
    n_b4, b4 = trace.kernel_time(ops, "p3_part2_kernel")
    observe.enable()
    step = system.step
    step(dict(system.chunks[0]))          # the traced capture
    program.synchronize(system)
    for rep in range(2):
        observe.reset()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for ch in system.chunks:
            step(dict(ch))
        e1.record()
        snap = observe.snapshot()
        print(json.dumps({"rep": rep, "event_ms": e0.elapsed_time(e1),
                          "graph_ms": {n: ns / 1e6 for n, (ns, cnt)
                                       in snap["spans"].items() if cnt},
                          "trips": snap["trips"]}), flush=True)
    observe.disable()
    print(json.dumps({"cell": cell,
                      "eager_ms": {k: v * 1e3 for k, v in eager.items()},
                      "eager_kernels": eager_kernels(prof),
                      "eager_ops": len(ops),
                      "eager_all_ops_ms": sum(e - s for _, s, e in ops) / 1e6,
                      "b1": [n_b1, b1 * 1e3], "b4": [n_b4, b4 * 1e3]}),
          flush=True)


def idle2(cell, seconds):
    c = spec.cell(cell)
    system = program.build(c.config, c.traffic, 4711)
    program.warm_up(system)
    observe.enable()
    program.warm_up(system)                 # the traced capture
    observe.disable()
    start = program.gcm_loop(system, seconds).steps_done
    for traced in (False, True, False, True):
        if traced:
            observe.enable()
            observe.reset()
        program.synchronize(system)
        compiled = program.profiled_compiled(system, start, 3)
        snap = observe.snapshot() if traced else None
        observe.disable()
        ops = sorted(compiled["ops"], key=lambda o: o[1])
        busy = stats.union_length([(s, e) for _, s, e in ops]) / 1e6
        t0 = ops[0][1]
        window = (max(e for _, _, e in ops) - t0) / 1e6
        gaps, end, last = [], ops[0][2], ops[0][0]
        for name, s, e in ops[1:]:
            if s > end:
                gaps.append(((s - end) / 1e6, round((end - t0) / 1e6, 3),
                             last[:40], name[:40]))
            if e > end:
                end, last = e, name
        gaps.sort(reverse=True)
        row = {"cell": cell, "traced": traced, "start": start,
               "busy_share": busy / window, "busy_ms": busy,
               "window_ms": window, "n_ops": len(ops),
               "gaps_top": gaps[:6], "gaps_total": sum(g[0] for g in gaps),
               "launches": compiled["launches"]}
        if traced:
            row["pam_step_ms"] = snap["spans"]["pam:step"][0] / 1e6
        print(json.dumps(row), flush=True)
        # on to the next GCM boundary, untimed
        start += 3
        nxt = -(-start // system.ncrm) * system.ncrm
        program.gcm_loop(system, 0.0, start=start, nsteps=nxt - start)
        start = nxt


if __name__ == "__main__":
    what, cell = sys.argv[1], sys.argv[2]
    seconds = float(sys.argv[3]) if len(sys.argv) > 3 else 51.0
    {"cost": lambda: cost(cell), "slow": lambda: slow(cell, seconds),
     "cupti": lambda: cupti(cell),
     "reconcile": lambda: reconcile(cell, seconds),
     "idle2": lambda: idle2(cell, seconds)}[what]()

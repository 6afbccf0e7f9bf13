"""One run of a cell: set-up, warm-up, the window, the profiled stretches
of a traced run, the check against the reference, and the result line's
fields. ``run.py`` calls it on the card; tests call it on the CPU at a
tiny size."""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from . import check, program, spec, stats

FORBIDDEN = ("jax", "jaxlib", "flax", "pam_tpu")
TRACE_STEPS = 3          # compiled CRM steps in the profiled stretch
TOP = 10                 # entries of each list of the breakdown


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    """The forbidden packages in sys.modules, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def idle_gaps(spans: list) -> list:
    """The longest stretches of the window in which the device waited on
    the host, named by what the host did: a ``gcm_sync`` span, or the gap
    between two spans ("<span before>-><span after>")."""
    gaps = [(f"gcm_sync@{s:.1f}ms", (e - s) / 1e3)
            for label, s, e, _ in spans if label == "gcm_sync"]
    ordered = sorted(spans, key=lambda r: r[1])
    for a, b in zip(ordered, ordered[1:]):
        if b[1] > a[2]:
            gaps.append((f"{a[0]}->{b[0]}@{a[2]:.1f}ms", (b[1] - a[2]) / 1e3))
    return [list(g) for g in sorted(gaps, key=lambda g: -g[1])[:TOP]]


class ForbiddenImport(RuntimeError):
    pass


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", fault=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``t_start``
    is the process's start on the host's clock (set-up is counted from
    it). ``fault`` goes to the loop (tests)."""
    cuda = device == "cuda"
    system = program.build(cell.config, cell.traffic, seed, device)
    plan = check.plan(seed, cell.traffic, system.ncrm, len(system.chunks))
    program.warm_up(system, 2 * len(plan.samples))
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: seed {seed}, nens {system.nens} in chunks of "
        f"{system.chunk}, set-up {setup_s:.3f} s; compares chunk "
        f"{plan.chunk_index} at steps {plan.samples}")

    loop = program.gcm_loop(system, seconds, samples=plan.samples.values(),
                            chunk_index=plan.chunk_index, spans=trace,
                            fault=fault)
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    steps = len(loop.step_ms)
    window_ms = sum(loop.step_ms)
    log(f"window: {steps} CRM steps in {window_ms:.3f} ms, "
        f"{loop.steps_done} taken in all; peak reserved "
        f"{peak / 2**20:.1f} MiB")
    log("median ms a step, by GCM step: " + " ".join(
        f"{statistics.median(loop.step_ms[g:g + system.ncrm]):.2f}"
        for g in range(0, steps, system.ncrm)))

    readings = {"config": cell.config, "nens": system.nens,
                "chunk": system.chunk, "steps": steps,
                "window_ms": window_ms, "spans": loop.spans,
                "step_ms": loop.step_ms}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and cuda:
        from . import trace as tr
        compiled = program.profiled_compiled(system, loop.steps_done,
                                             TRACE_STEPS)
        readings["compiled"] = compiled
        readings["eager"] = program.profiled_eager(system)
        ops = compiled["ops"]
        device_info["busy_s"] = stats.union_length(
            [(s, e) for _, s, e in ops]) / 1e9
        device_info["window_s"] = ((max(e for _, _, e in ops)
                                    - min(s for _, s, _ in ops)) / 1e9
                                   if ops else 0.0)
        breakdown = {"device_ops": [list(kv) for kv in
                                    tr.by_name(ops)[:TOP]],
                     "idle_gaps": idle_gaps(loop.spans)}

    # the program's state goes before the reference runs; the chunk that
    # is compared stays in the samples
    run = program.run_settings(cell.config, cell.traffic)
    seeds = program.member_seeds(seed, system.nens, system.chunk)
    chunk, gridpoints = system.chunk, system.gridpoints
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = check.Reference(run, seeds, chunk, plan.chunk_index, device)
    found = check.compare(ref, loop.snaps, plan, cell.config["trim"])
    del ref
    values = check.numbers(found)
    correct, rows = check.verdict(values, cell.config["limits"])
    log(f"reference: {time.perf_counter() - t_check:.3f} s; widest gaps "
        f"{check.widest(found)}")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"gridpoint_steps_per_s": stats.rate(gridpoints, loop.step_ms),
               "step_ms_p95": stats.p95(loop.step_ms),
               "peak_reserved_mib": peak / 2**20,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    found_forbidden = forbidden_loaded()
    if found_forbidden:
        raise ForbiddenImport(f"{found_forbidden} loaded in the benchmark's "
                              "process")
    bad = sum(1 for _, v, lim in rows if not v <= lim)
    result = {"correct": bool(correct), "attempted": steps, "failed": bad,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {name: {"value": v, "limit": lim}
                         for name, v, lim in rows}
    for name, v, lim in rows:
        log(f"checked {name}: {v!r} (limit {lim!r})")
    return result

"""The program's tracer over one GCM step of the compiled loop, read by
the per-layer metrics that look inside the CUDA graph
(``metrics/step.graph_ms_per_step.py``, ``dycore.graph_ms_per_step``,
``physics.graph_ms_per_step``, ``driver.outside_graph_ms_per_step``,
``micro.loop_trips_per_step``).

By the time the runner reads its metrics it has let the window's system
go (the reference ran in its place), so the first of these readers builds
the cell's system again as ``program.build`` builds it, turns the
program's tracer on (``pam_tpu_torch.utils.observe``), warms the traced
capture up (``program.warm_up``), computes each chunk's forcing, zeroes
the tracer and runs 45 CRM steps of the loop through ``program.gcm_loop``
from the last step of a GCM step, so that the GCM boundary (its sync,
then the next forcing) lies between two replays; then it snapshots the
tracer and turns it off. Its result, with the stretch's own CUDA-event
ms a step, is kept in ``readings["program"]`` for the others. Nothing
where the run traced no card (no ``compiled`` stretch in the readings)
or where the program has no tracer (a checkout before it)."""

from __future__ import annotations

import gc

import torch

from . import program, runner

SEED = 0                 # member order of the rebuilt system (work alike)
STEP = "pam:step"


def stretch(r: dict):
    """``readings["program"]``, made on the first call: {"snapshot": the
    tracer's snapshot, "step_ms": the stretch's CUDA-event ms of each CRM
    step, "steps": their number, "chunks": chunks a step}; None where
    nothing was traced."""
    if "program" in r:
        return r["program"]
    r["program"] = None
    if not r.get("compiled"):
        return None
    from pam_tpu_torch.utils import observe
    if not hasattr(observe, "enable"):
        return None
    traffic = {"nens": r["nens"], "ens_chunk": r["chunk"]}
    system = program.build(r["config"], traffic, SEED)
    try:
        observe.enable()
        program.warm_up(system)
        drv, chunks = system.drv, system.chunks
        for j in range(len(chunks)):
            chunks[j] = drv._forcing(chunks[j])
        program.synchronize(system)
        observe.reset()
        loop = program.gcm_loop(system, 0.0, start=system.ncrm - 1,
                                nsteps=system.ncrm)
        snap = observe.snapshot()
    finally:
        observe.disable()
    r["program"] = {"snapshot": snap, "step_ms": loop.step_ms,
                    "steps": len(loop.step_ms), "chunks": len(chunks)}
    runner.log(f"traced stretch: {len(loop.step_ms)} CRM steps, "
               f"{sum(loop.step_ms) / len(loop.step_ms):.3f} ms a step by "
               f"CUDA events; pam:step {span_ms_per_step(r, STEP):.3f}, "
               f"outside it {outside_ms_per_step(r)} ms a step; clock step "
               f"{snap['resolution_ns']} ns, offset +-{snap['offset_err_ns']}"
               f" ns, drift {snap['drift_ns']} ns")
    del system, drv, chunks
    gc.collect()
    torch.cuda.empty_cache()
    return r["program"]


def span_ms_per_step(r: dict, *names):
    """Device ms a CRM step in the spans ``names``, summed over every
    replay of the stretch; None where none of them ran."""
    p = stretch(r)
    if p is None:
        return None
    spans = p["snapshot"]["spans"]
    if not any(spans.get(n, (0, 0))[1] for n in names):
        return None
    return sum(spans.get(n, (0, 0))[0] for n in names) / 1e6 / p["steps"]


def outside_ms_per_step(r: dict):
    """Device ms a CRM step between one replay's ``pam:step`` and the
    next one's, on the timeline; None where the timeline lost entries."""
    p = stretch(r)
    if p is None or p["snapshot"]["ring_dropped"]:
        return None
    steps = sorted((b, e) for name, b, e in p["snapshot"]["ring"]
                   if name == STEP)
    if len(steps) < 2:
        return None
    gaps = sum(b - e for (_, e), (b, _) in zip(steps, steps[1:]))
    return gaps / 1e6 / p["steps"]


def trips_per_step(r: dict, *loops):
    """The trips of the loops ``loops`` a CRM step, all chunks; None
    where none of them is known to the tracer."""
    p = stretch(r)
    if p is None:
        return None
    trips = p["snapshot"]["trips"]
    found = [trips[n] for n in loops if n in trips]
    if not found:
        return None
    return sum(found) / p["steps"]

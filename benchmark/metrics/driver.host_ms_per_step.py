"""Host ms a CRM step inside the calls into the driver (``_forcing`` and
``step_chunks``), from the harness's spans over the window of a traced
run (before any profiler starts)."""


def read(r):
    calls = [host_s for label, _, _, host_s in r["spans"]
             if label in ("forcing", "step_chunks")]
    if not calls or not r["steps"]:
        return None
    return 1e3 * sum(calls) / r["steps"]

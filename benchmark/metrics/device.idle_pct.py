"""Share of the window in which the device's stream stood outside every
call into the driver: 100 x (1 - the device intervals between the events
that bracket each ``_forcing`` and ``step_chunks`` call, over the window).
From CUDA events alone, over the window of a traced run."""

from mmfbench import stats


def read(r):
    calls = [e - s for label, s, e, _ in r["spans"]
             if label in ("forcing", "step_chunks")]
    if not calls or r["window_ms"] <= 0:
        return None
    return stats.idle_pct(calls, r["window_ms"])

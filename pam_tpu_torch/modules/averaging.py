"""Horizontal and running-time averages of coupler fields (port of
pam_tpu/modules/averaging.py).

Parity reference: pam_core/modules/{horizontal_average.h, time_average.h}.
Both reference files contain syntax errors and are compiled nowhere
(`r_ncol` undeclared at horizontal_average.h:70; a missing semicolon at
time_average.h:67); these are working re-derivations of their documented
intent, as in pam_tpu.
"""

from __future__ import annotations

import torch

from ..parallel import comm


def horizontal_average(coupler, state, var_names):
    """For each named (nens, nz, ny, nx) field, store its mean over (ny,
    nx) as the (nens, nz) column ``<name>_horizontal_average`` (ref
    intent: horizontal_average.h:25-80)."""
    out = dict(state)
    for name in var_names:
        out[name + "_horizontal_average"] = comm.pmean_h(state[name],
                                                         (-2, -1))
    return out


def time_average(coupler, state, var_names, dt, window):
    """Running average ``<name>_time_average`` over a window of total
    length ``window``; call once per step of size ``dt``. The accumulator
    convention follows time_average.h:39-70 (accumulate var*dt/window; the
    caller resets the accumulator at window boundaries)."""
    out = dict(state)
    w = dt / window
    for name in var_names:
        key = name + "_time_average"
        acc = state.get(key)
        if acc is None:
            acc = torch.zeros_like(state[name])
        out[key] = acc + state[name] * w
    return out


def reset_time_average(state, var_names):
    """Zero the running accumulators at a window boundary."""
    out = dict(state)
    for name in var_names:
        key = name + "_time_average"
        if key in out:
            out[key] = torch.zeros_like(out[key])
    return out

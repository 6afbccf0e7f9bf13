"""Instantaneous saturation adjustment (condensation/evaporation)
(port of pam_tpu/modules/saturation.py; ref pam_core/modules/
saturation_adjustment.h).

A bisection on the condensed/evaporated mass with latent-heat feedback,
run for a fixed number of iterations over every cell at once; both
branches (condense when supersaturated, evaporate when subsaturated
with cloud present) are one signed bisection.
"""

from __future__ import annotations

import torch

from ..core.coupler import Coupler
# one definition of the Bolton svp formula, re-exported here because the
# adjustment is its main consumer
from ..core.profiles import saturation_vapor_pressure  # noqa: F401

_N_ITERS = 40  # bisection: bracket shrinks 2^-40, far below the ref's 1e-6


def latent_heat_condensation(temp):
    tc = temp - 273.15
    return (2500.8 - 2.36 * tc + 0.0016 * tc * tc -
            0.00006 * tc * tc * tc) * 1000.0


def _cp_moist(rho_d, rho_v, rho_c, cp_d, cp_v, cp_l):
    rho = rho_d + rho_v + rho_c
    return (rho_d * cp_d + rho_v * cp_v + rho_c * cp_l) / rho


def compute_adjusted_state(rho, rho_d, rho_v, rho_c, temp, R_v, cp_d, cp_v,
                           cp_l):
    """compute_adjusted_state (saturation_adjustment.h:28-113) over whole
    tensors. Returns (rho_v, rho_c, temp)."""
    svp = saturation_vapor_pressure(temp)
    pv = rho_v * R_v * temp
    condensing = pv > svp
    evaporating = (pv < svp) & (rho_c > 0)
    active = condensing | evaporating
    sign = torch.where(condensing, 1.0, -1.0).to(temp.dtype)
    x_max = torch.where(condensing, rho_v, rho_c)

    def trial(x):
        rv = torch.clamp(rho_v - sign * x, min=0.0)
        rc = torch.clamp(rho_c + sign * x, min=0.0)
        Lv = latent_heat_condensation(temp)
        cp = _cp_moist(rho_d, rv, rc, cp_d, cp_v, cp_l)
        t = temp + sign * x * Lv / (rho * cp)
        return rv, rc, t

    lo, hi = torch.zeros_like(rho), x_max
    for _ in range(_N_ITERS):
        x = 0.5 * (lo + hi)
        rv, rc, t = trial(x)
        need_more = sign * (rv * R_v * t - saturation_vapor_pressure(t)) > 0
        lo = torch.where(need_more, x, lo)
        hi = torch.where(need_more, hi, x)
    x = 0.5 * (lo + hi)
    rv, rc, t = trial(x)
    rv = torch.where(active, rv, rho_v)
    rc = torch.where(active, rc, rho_c)
    t = torch.where(active, t, temp)
    return rv, rc, t


def saturation_adjustment(coupler: Coupler, state, cloud_field: str = None):
    """saturation_adjustment, saturation_adjustment.h:116-151. cloud_field
    defaults to the microphysics' cloud liquid tracer ('cloud_liquid' for
    Kessler, 'cloud_water' for P3)."""
    if cloud_field is None:
        cloud_field = ("cloud_liquid" if "cloud_liquid" in state
                       else "cloud_water")
    c = coupler.const
    out = dict(state)
    rho = state["density_dry"]
    for adds, name in zip(coupler.tracer_adds_mass, coupler.tracer_names):
        if adds:
            rho = rho + state[name]
    rv, rc, temp = compute_adjusted_state(
        rho, state["density_dry"], state["water_vapor"], state[cloud_field],
        state["temp"], c.R_v, c.cp_d, c.cp_v, c.cp_l)
    out["water_vapor"] = rv
    out[cloud_field] = rc
    out["temp"] = temp
    return out

"""GCM<->CRM coupling: relax the column-averaged CRM state toward the GCM
state (port of pam_tpu/modules/gcm_forcing.py:39-158; ref pam_core/
modules/gcm_forcing.h).

The global hole-filling fallback (gcm_forcing.h:254-279) runs
unconditionally: where the per-level pass already balanced, the residual
is zero and the global pass changes nothing.
"""

from __future__ import annotations

import torch

from ..core.coupler import Coupler, hmean
from ..parallel import comm

# (crm_field, gcm_field, tendency) of the number species
_NUM_SPECIES = (("cloud_water_num", "gcm_num_liq", "gcm_forcing_tend_nc"),
                ("ice_num", "gcm_num_ice", "gcm_forcing_tend_ni"),
                ("rain_num", "gcm_num_rain", "gcm_forcing_tend_nr"))


def _get3d(state, name):
    """Field, or zeros if the active microphysics does not carry it."""
    if name in state:
        return state[name]
    return torch.zeros_like(state["density_dry"])


def _liq_name(state) -> str:
    """The cloud-liquid tracer (P3 "cloud_water", Kessler "cloud_liquid")."""
    return "cloud_water" if "cloud_water" in state else "cloud_liquid"


def compute_gcm_forcing_tendencies(coupler: Coupler, state, dt_gcm):
    """Store (gcm - colavg(crm))/dt_gcm forcing columns in a new state
    (compute_gcm_forcing_tendencies, gcm_forcing.h:18-204)."""
    out = dict(state)
    rho_d = state["density_dry"]
    rho_v = _get3d(state, "water_vapor")
    rho_l = _get3d(state, _liq_name(state))
    rho_i = _get3d(state, "ice")
    r_dt = 1.0 / dt_gcm

    out["gcm_forcing_tend_rho_d"] = (state["gcm_density_dry"] -
                                     hmean(rho_d)) * r_dt
    out["gcm_forcing_tend_uvel"] = (state["gcm_uvel"] -
                                    hmean(state["uvel"])) * r_dt
    out["gcm_forcing_tend_vvel"] = (state["gcm_vvel"] -
                                    hmean(state["vvel"])) * r_dt
    out["gcm_forcing_tend_temp"] = (state["gcm_temp"] -
                                    hmean(state["temp"])) * r_dt
    # moist-air mixing-ratio forcing (gcm_forcing.h:108-113, 176-181)
    denom = rho_d + rho_v
    qv = hmean(rho_v / denom)
    ql = hmean(rho_l / denom)
    qi = hmean(rho_i / denom)
    gdenom = state["gcm_density_dry"] + state["gcm_water_vapor"]
    out["gcm_forcing_tend_qv"] = (state["gcm_water_vapor"] / gdenom - qv) * r_dt
    out["gcm_forcing_tend_ql"] = (state["gcm_cloud_water"] / gdenom - ql) * r_dt
    out["gcm_forcing_tend_qi"] = (state["gcm_cloud_ice"] / gdenom - qi) * r_dt
    out["gcm_forcing_tend_qtot"] = (out["gcm_forcing_tend_qv"] +
                                    out["gcm_forcing_tend_ql"] +
                                    out["gcm_forcing_tend_qi"])
    for crm_name, gcm_name, tend_name in _NUM_SPECIES:
        out[tend_name] = (state[gcm_name] -
                          hmean(_get3d(state, crm_name))) * r_dt
    # the diagnostic density forcings are written by apply_...; create
    # them here so the state has the same keys before and after a step
    for name in ("gcm_forcing_tend_rho_v", "gcm_forcing_tend_rho_l",
                 "gcm_forcing_tend_rho_i"):
        if name not in out:
            out[name] = torch.zeros_like(out["gcm_forcing_tend_rho_d"])
    return out


def fill_holes(rho_x, dz):
    """Multiplicative hole filling: clamp negatives to zero and take the
    added mass from the positive cells in proportion, per level first,
    then over the whole column for any residual (fill_holes,
    gcm_forcing.h:207-281). rho_x (nens, nz, ny, nx), dz (nens, nz)."""
    dz4 = dz[:, :, None, None]
    zero = torch.zeros((), dtype=rho_x.dtype, device=rho_x.device)
    one = torch.ones((), dtype=rho_x.dtype, device=rho_x.device)
    neg_mass = comm.psum_h(torch.where(rho_x < 0, -rho_x, zero) * dz4,
                           (-2, -1))  # (nens, nz)
    rho_x = torch.clamp(rho_x, min=0.0)
    pos_mass = comm.psum_h(rho_x * dz4, (-2, -1))
    factor = rho_x * dz4 / torch.where(pos_mass == 0, one,
                                       pos_mass)[:, :, None, None]
    take = torch.where((pos_mass > 0)[:, :, None, None],
                       neg_mass[:, :, None, None] * factor / dz4, zero)
    rho_x = torch.clamp(rho_x - take, min=0.0)
    residual = torch.sum(torch.clamp(neg_mass - pos_mass, min=0.0), dim=1)
    glob_pos = torch.sum(comm.psum_h(rho_x * dz4, (-2, -1)), dim=1)
    gfactor = rho_x * dz4 / torch.where(glob_pos == 0, one,
                                        glob_pos)[:, None, None, None]
    return torch.clamp(rho_x - residual[:, None, None, None] * gfactor / dz4,
                       min=0.0)


def apply_gcm_forcing_tendencies(coupler: Coupler, state, dt, dt_gcm):
    """Apply the stored forcing for one CRM step, with mixing-ratio
    bookkeeping and hole filling (apply_gcm_forcing_tendencies,
    gcm_forcing.h:294-440)."""
    out = dict(state)
    dz = state["vertical_cell_dz"]
    col = lambda name: state[name][:, :, None, None]
    rho_d_old = state["density_dry"]
    rho_v = _get3d(state, "water_vapor")
    liq_name = _liq_name(state)
    rho_l = _get3d(state, liq_name)
    rho_i = _get3d(state, "ice")

    rho_d = rho_d_old + col("gcm_forcing_tend_rho_d") * dt
    out["density_dry"] = rho_d
    out["uvel"] = state["uvel"] + col("gcm_forcing_tend_uvel") * dt
    out["vvel"] = state["vvel"] + col("gcm_forcing_tend_vvel") * dt
    out["temp"] = state["temp"] + col("gcm_forcing_tend_temp") * dt

    denom_old = rho_d_old + rho_v
    qv_new = rho_v / denom_old + col("gcm_forcing_tend_qv") * dt
    ql_new = rho_l / denom_old + col("gcm_forcing_tend_ql") * dt
    qi_new = rho_i / denom_old + col("gcm_forcing_tend_qi") * dt
    rho_v_new = qv_new * rho_d / (1.0 - qv_new)
    rho_l_new = ql_new * (rho_d + rho_v_new)
    rho_i_new = qi_new * (rho_d + rho_v_new)

    # diagnostic density forcings (gcm_forcing.h:424-431)
    r_dt_gcm = 1.0 / dt_gcm
    out["gcm_forcing_tend_rho_v"] = (state["gcm_water_vapor"] -
                                     hmean(rho_v_new)) * r_dt_gcm
    out["gcm_forcing_tend_rho_l"] = (state["gcm_cloud_water"] -
                                     hmean(rho_l_new)) * r_dt_gcm
    out["gcm_forcing_tend_rho_i"] = (state["gcm_cloud_ice"] -
                                     hmean(rho_i_new)) * r_dt_gcm

    if "water_vapor" in state:
        out["water_vapor"] = fill_holes(rho_v_new, dz)
    if liq_name in state:
        out[liq_name] = fill_holes(rho_l_new, dz)
    if "ice" in state:
        out["ice"] = fill_holes(rho_i_new, dz)
    for crm_name, gcm_name, tend_name in _NUM_SPECIES:
        if crm_name in state:
            out[crm_name] = torch.clamp(
                state[crm_name] + col(tend_name) * dt, min=0.0)
    return out

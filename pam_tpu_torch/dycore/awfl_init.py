"""Initial conditions for the AWFL dycore: thermal bubble and supercell
(port of pam_tpu/dycore/awfl_init.py; ref dynamics/awfl/Dycore.h init
paths).

One-time numpy float64 computations (quadrature-projected analytic
states), copied to the coupler's device once at the end:

* thermal: rising dry thermal in a constant-theta hydrostatic background
  (Dycore.h:1021-1088);
* supercell: Weisman-Klemp-like high-CAPE sounding with GLL-quadrature
  hydrostatic pressure integration and the RH cap at qv = 0.014
  (Dycore.h:1096-1276). The sounding itself is
  ``driver.supercell_column.supercell_column_profiles``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coupler import Coupler
from ..driver.supercell_column import supercell_column_profiles
from ..ops import recon_matrices as rm

NGLL = 9


def _gll():
    return rm.gll_points_weights(NGLL)


def _hydro_const_theta(z, c, theta0=300.0):
    """(rho, theta) of the constant-theta hydrostatic background
    (ref: Dycore.h:739-748)."""
    exner = 1.0 - c.grav * z / (c.cp_d * theta0)
    p = c.p0 * exner ** (c.cp_d / c.R_d)
    rt = (p / c.C0) ** (1.0 / c.gamma_d)
    return rt / theta0, np.full_like(np.asarray(z, float), theta0)


def _sample_ellipse_cosine(amp, x, y, z, x0, y0, z0, xr, yr, zr):
    """(ref: Dycore.h:753-766)."""
    d = np.sqrt(((x - x0) / xr) ** 2 + ((y - y0) / yr) ** 2 +
                ((z - z0) / zr) ** 2) * np.pi / 2.0
    return np.where(d <= np.pi / 2.0, amp * np.cos(d) ** 2, 0.0)


def _grid_columns(state):
    """(zmid, zint, dz) of the state as float64 numpy, each (nens, n)."""
    return tuple(state[k].detach().cpu().numpy().astype(np.float64)
                 for k in ("vertical_midpoint_height",
                           "vertical_interface_height", "vertical_cell_dz"))


def _with_fields(coupler: Coupler, state, fields):
    """``state`` with the numpy ``fields`` copied to the coupler's device
    in its dtype; uvel/vvel/wvel default to zero."""
    out = dict(state)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=coupler.dtype, device=coupler.device)
    for k, v in fields.items():
        out[k] = to(v)
    for k in ("uvel", "vvel", "wvel"):
        if k not in fields:
            out[k] = torch.zeros_like(out["density_dry"])
    return out


def init_thermal(coupler: Coupler, state):
    """Dry rising-thermal bubble; fills the coupler state and the
    hydrostatic background (ref: Dycore.h DATA_SPEC_THERMAL, 1021-1088)."""
    c = coupler.const
    nz, ny, nx, nens = coupler.nz, coupler.ny, coupler.nx, coupler.nens
    dx, dy = coupler.dx, coupler.dy
    qp, qw = _gll()
    zmid, _, dz = _grid_columns(state)

    # hydrostatic background cell averages by quadrature (ref: 1035-1047)
    zq = zmid[:, :, None] + qp[None, None, :] * dz[:, :, None]  # (nens,nz,q)
    hr, ht = _hydro_const_theta(zq, c)
    hy_dens = np.einsum('ekq,q->ek', hr, qw)
    hy_pres = np.einsum('ekq,q->ek', c.C0 * (hr * ht) ** c.gamma_d, qw)

    # cell-averaged state by 3-D quadrature (ref: 1050-1086)
    ht_cell = (hy_pres / c.C0) ** (1.0 / c.gamma_d) / hy_dens  # (nens, nz)
    rho = np.broadcast_to(hy_dens[:, :, None, None], (nens, nz, ny, nx)).copy()
    rt = np.zeros((nens, nz, ny, nx))
    for kk in range(NGLL):
        zq1 = zmid + qp[kk] * dz  # (nens, nz)
        for jj in range(NGLL):
            if coupler.sim2d:
                yq1 = np.full((ny,), coupler.ylen / 2.0)
            else:
                yq1 = (np.arange(ny) + 0.5) * dy + qp[jj] * dy
            for ii in range(NGLL):
                xq1 = (np.arange(nx) + 0.5) * dx + qp[ii] * dx
                pert = _sample_ellipse_cosine(
                    2.0,
                    xq1[None, None, None, :], yq1[None, None, :, None],
                    zq1[:, :, None, None],
                    coupler.xlen / 2.0, coupler.ylen / 2.0, 2000.0,
                    2000.0, 2000.0, 2000.0)
                theta = ht_cell[:, :, None, None] + pert
                w = qw[ii] * qw[jj] * qw[kk]
                rt += hy_dens[:, :, None, None] * theta * w
    # dycore state -> coupler conversion (dry: no vapor)
    press = c.C0 * rt ** c.gamma_d
    temp = press / (rho * c.R_d)
    return _with_fields(coupler, state, dict(
        density_dry=rho, temp=temp, hy_dens_cells=hy_dens,
        hy_pressure_cells=hy_pres))


def init_supercell(coupler: Coupler, state):
    """Supercell initial state with GLL-quadrature hydrostatic integration
    (ref: Dycore.h init_supercell, 1096-1276). Returns the state with
    hy_dens_cells / hy_pressure_cells filled."""
    c = coupler.const
    nz, ny, nx, nens = coupler.nz, coupler.ny, coupler.nx, coupler.nens
    z_trop, T_0, T_trop, T_top, p_0 = 12000.0, 300.0, 213.0, 213.0, 1.0e5
    qp, qw = _gll()
    zmid, zint, dz = _grid_columns(state)
    z_top = zint[:, -1]  # (nens,)

    # pressure at GLL points by sequential exponential integration
    # (ref: 1146-1184)
    pGLL = np.empty((nens, nz, NGLL))
    for e in range(nens):
        p = p_0
        for k in range(nz):
            pGLL[e, k, 0] = p
            for kk in range(NGLL - 1):
                zb = zmid[e, k] + qp[kk] * dz[e, k]
                zt = zmid[e, k] + qp[kk + 1] * dz[e, k]
                zm = 0.5 * (zb + zt)
                ddz = dz[e, k] * (qp[kk + 1] - qp[kk])
                zq = zm + ddz * qp  # NGLL quadrature points in sub-interval
                T, p_dry, qv = supercell_column_profiles(
                    zq, c, z_trop, T_0, T_trop, T_top, p_0, z_top[e])
                integ = -(1.0 + qv) * c.grav / (c.R_d + qv * c.R_v) / T
                p = p * np.exp(np.dot(integ, qw) * ddz)
                pGLL[e, k, kk + 1] = p

    # hydrostatic background at GLL points (ref: 1187-1203)
    zq = zmid[:, :, None] + qp[None, None, :] * dz[:, :, None]
    T, p_dry, qv = supercell_column_profiles(zq, c, z_trop, T_0, T_trop,
                                             T_top, p_0)
    dens_dry = pGLL / (c.R_d + qv * c.R_v) / T
    dens_vap = qv * dens_dry
    hy_dens = np.einsum('ekq,q->ek', dens_dry + dens_vap, qw)
    hy_pres = np.einsum('ekq,q->ek', pGLL, qw)
    hy_dens_vap = np.einsum('ekq,q->ek', dens_vap, qw)

    # cell-averaged momentum via quadrature of the shear profile u(z)
    # (ref: 1240-1275); rho is the cell-average hy_dens
    zs, us, uc = 5000.0, 30.0, 15.0
    uq = np.where(zq < zs, us * (zq / zs) - uc, us - uc)  # (nens, nz, q)
    u_cell = np.einsum('ekq,q->ek', uq, qw)

    full = lambda col: np.broadcast_to(col[:, :, None, None],
                                       (nens, nz, ny, nx)).copy()
    rho = full(hy_dens)
    rho_u = full(hy_dens * u_cell)
    rho_t = full((hy_pres / c.C0) ** (1.0 / c.gamma_d))
    rho_v = full(hy_dens_vap)
    # convert to coupler variables (ref: convert_dynamics_to_coupler)
    rho_d = rho - rho_v
    press = c.C0 * rho_t ** c.gamma_d
    temp = press / (rho_d * c.R_d + rho_v * c.R_v)
    return _with_fields(coupler, state, dict(
        density_dry=rho_d, uvel=rho_u / rho, temp=temp, water_vapor=rho_v,
        hy_dens_cells=hy_dens, hy_pressure_cells=hy_pres))

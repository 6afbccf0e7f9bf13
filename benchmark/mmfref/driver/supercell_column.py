"""Supercell initial column for MMF-mode runs (port of
pam_tpu/driver/supercell_column.py, with supercell_column_profiles from
pam_tpu/dycore/awfl_init.py:103; ref standalone/mmf_simplified/
supercell_init.h and dynamics/awfl/Dycore.h:778-830).

5-point GLL hydrostatic integration of the Weisman-Klemp-like sounding
in numpy float64, broadcast into the GCM and reference-state columns
(driver.cpp:19-77).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import Constants
from ..core.coupler import Coupler
from ..ops import recon_matrices as rm


def supercell_column_profiles(zcol, c, z_trop=12000.0, T_0=300.0,
                              T_trop=213.0, T_top=213.0, p_0=1.0e5,
                              z_top=None):
    """Supercell sounding at arbitrary heights: (temperature, dry
    pressure, capped qv) (Dycore.h:778-830 helpers)."""
    z_0 = 0.0
    # the sounding is defined for z >= 0; (-eps)**1.25 would be NaN
    zcol = np.maximum(zcol, 0.0)
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    T = np.where(zcol <= z_trop, T_0 - lapse_lo * (zcol - z_0), T_trop)
    p_trop = p_0 * (T_trop / T_0) ** (c.grav / (c.R_d * lapse_lo))
    p_dry = np.where(zcol <= z_trop,
                     p_0 * (T / T_0) ** (c.grav / (c.R_d * lapse_lo)),
                     p_trop * np.exp(-c.grav * (zcol - z_trop) /
                                     (c.R_d * T_trop)))
    qvs = 380.0 / p_dry * np.exp(17.27 * (T - 273.0) / (T - 36.0))
    relhum = np.where(zcol <= z_trop, 1.0 - 0.75 * (zcol / z_trop) ** 1.25,
                      0.25)
    relhum = np.where(relhum * qvs > 0.014, 0.014 / qvs, relhum)
    qv = np.minimum(0.014, qvs * relhum)
    return T, p_dry, qv


def supercell_init_column(zint: np.ndarray, c: Constants, ngll: int = 5):
    """The supercell column at cell averages, (nz,) numpy arrays rho_d,
    uvel, vvel, wvel, temp, rho_v (supercell_init.h:74-135)."""
    zint = np.asarray(zint, np.float64)
    nz = len(zint) - 1
    dz = np.diff(zint)
    zmid = 0.5 * (zint[:-1] + zint[1:])
    qp, qw = rm.gll_points_weights(ngll)
    z_top = zint[-1]

    # integrate ln(p) along GLL sub-intervals (supercell_init.h:74-92)
    pGLL = np.empty((nz, ngll))
    p = 1.0e5
    for k in range(nz):
        pGLL[k, 0] = p
        for kk in range(ngll - 1):
            zb = zmid[k] + qp[kk] * dz[k]
            zt = zmid[k] + qp[kk + 1] * dz[k]
            zm = 0.5 * (zb + zt)
            ddz = dz[k] * (qp[kk + 1] - qp[kk])
            zq = zm + ddz * qp
            T, p_dry, qv = supercell_column_profiles(zq, c, z_top=z_top)
            integ = -(1.0 + qv) * c.grav / (c.R_d + qv * c.R_v) / T
            p = p * np.exp(np.dot(integ, qw) * ddz)
            pGLL[k, kk + 1] = p

    # cell averages (supercell_init.h:95-135)
    zq = zmid[:, None] + qp[None, :] * dz[:, None]
    T, p_dry, qv = supercell_column_profiles(zq, c, z_top=z_top)
    rho_d = pGLL / (c.R_d + qv * c.R_v) / T
    rho_v = qv * rho_d
    zs, us, uc = 5000.0, 30.0, 15.0
    u = np.where(zq < zs, us * (zq / zs) - uc, us - uc)
    avg = lambda f: np.einsum('kq,q->k', f, qw)
    return dict(rho_d=avg(rho_d), uvel=avg(u), vvel=np.zeros(nz),
                wvel=np.zeros(nz), temp=avg(T), rho_v=avg(rho_v))


def initialize_from_supercell_column(coupler: Coupler, state, zint):
    """Set gcm_* and ref_* columns from the supercell sounding
    (driver.cpp:18-77 initialize_from_supercell_column)."""
    col = supercell_init_column(np.asarray(zint), coupler.const)
    out = dict(state)
    to = lambda a: torch.as_tensor(a, dtype=coupler.dtype,
                                   device=coupler.device).expand(
        coupler.nens, coupler.nz).contiguous()
    zeros = np.zeros(coupler.nz)
    for name, val in (("gcm_density_dry", col["rho_d"]),
                      ("gcm_uvel", col["uvel"]),
                      ("gcm_vvel", col["vvel"]),
                      ("gcm_wvel", col["wvel"]),
                      ("gcm_temp", col["temp"]),
                      ("gcm_water_vapor", col["rho_v"]),
                      ("ref_density_dry", col["rho_d"]),
                      ("ref_density_vapor", col["rho_v"]),
                      ("ref_density_liq", zeros),
                      ("ref_density_ice", zeros),
                      ("ref_temp", col["temp"])):
        out[name] = to(val)
    return out

"""Monin-Obukhov-style surface momentum fluxes for the SGS scheme (port of
pam_tpu/modules/surface_friction.py).

Parity reference: pam_core/modules/surface_friction.h (z0_est roughness
estimate, Businger-function diag_ustar with 8 fixed-point iterations, and
the SAM-style momentum flux computation consumed by SHOC).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.coupler import Coupler
from ..parallel import comm

VONK = 0.4
EPS = 1.0e-10
AM = 4.8
BM = 19.3
PI = 3.14159  # the reference's own truncated pi (surface_friction.h:11)
_C1 = PI / 2.0 - 3.0 * math.log(2.0)


def _psi1_unstable(zeta):
    x = torch.sqrt(torch.sqrt(torch.clamp(1.0 - BM * zeta, min=EPS)))
    return 2.0 * torch.log(1.0 + x) + torch.log(1.0 + x * x) - \
        2.0 * torch.atan(x) + _C1


def z0_est(z, bflx, wnd, ustar):
    """Roughness-height estimate (ref: surface_friction.h:15-29)."""
    rlmo = -bflx * VONK / (ustar ** 3 + EPS)
    zeta = torch.clamp(z * rlmo, max=1.0)
    psi1 = torch.where(zeta >= 0.0, -AM * zeta, _psi1_unstable(zeta))
    lnz = torch.clamp(VONK * wnd / (ustar + EPS) + psi1, min=0.0)
    return z * torch.exp(-lnz)


def diag_ustar(z, bflx, wnd, z0):
    """Friction velocity via Businger similarity, 8 fixed-point iterations
    (ref: surface_friction.h:44-63)."""
    lnz = torch.log(z / z0)
    ustar0 = wnd * VONK / lnz
    ustar = ustar0
    for _ in range(8):
        rlmo = -bflx * VONK / (ustar ** 3 + EPS)
        zeta = torch.clamp(z * rlmo, max=1.0)
        ustar = torch.where(zeta > 0.0, VONK * wnd / (lnz + AM * zeta),
                            wnd * VONK / (lnz - _psi1_unstable(zeta)))
    return torch.where(bflx != 0.0, ustar, ustar0)


def surface_friction_init(coupler: Coupler, state, tau_in, bflx_in):
    """Roughness height and zero momentum-flux fields
    (ref: surface_friction_init, surface_friction.h:66-104).

    tau_in/bflx_in: (nens,) surface stress [N/m2] and buoyancy flux."""
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=coupler.dtype,
                                  device=coupler.device)
    out = dict(state)
    rho_sfc = torch.mean(state["density_dry"][:, 0] +
                         state["water_vapor"][:, 0], dim=(-2, -1))  # (nens,)
    wnd = torch.clamp(torch.sqrt(state["gcm_uvel"][:, 0] ** 2 +
                                 state["gcm_vvel"][:, 0] ** 2), min=1.0)
    ustar = torch.sqrt(T(tau_in) / rho_sfc)
    z0 = z0_est(state["vertical_midpoint_height"][:, 0], T(bflx_in), wnd,
                ustar)
    out["z0"] = torch.clamp(z0, 1.0e-5, 1.0)
    out["sfc_bflx"] = T(bflx_in)
    out["sfc_mom_flx_u"] = coupler._zeros(coupler.nens, coupler.ny,
                                          coupler.nx)
    out["sfc_mom_flx_v"] = coupler._zeros(coupler.nens, coupler.ny,
                                          coupler.nx)
    return out


def compute_surface_friction(coupler: Coupler, state):
    """SAM-style surface momentum fluxes for SHOC
    (ref: compute_surface_friction, surface_friction.h:107-169). As in the
    reference and pam_tpu, the stress is converted with ``* rho_sfc / dz``
    and the result labelled [m2/s2] (surface_friction.h:158-166)."""
    out = dict(state)
    u0 = state["uvel"][:, 0]   # (nens, ny, nx)
    v0 = state["vvel"][:, 0]
    rho0 = state["density_dry"][:, 0] + state["water_vapor"][:, 0]
    u_mean = comm.pmean_h(u0, (-2, -1))[..., None, None]
    v_mean = comm.pmean_h(v0, (-2, -1))[..., None, None]
    rho_mean = comm.pmean_h(rho0, (-2, -1))[..., None, None]
    wnd = torch.clamp(torch.sqrt(u0 ** 2 + v0 ** 2), min=1.0)
    zm0 = state["vertical_midpoint_height"][:, 0][:, None, None]
    ustar = diag_ustar(zm0, state["sfc_bflx"][:, None, None], wnd,
                       state["z0"][:, None, None])
    tau00 = rho_mean * ustar * ustar
    fu = -(u0 - u_mean) / wnd * tau00
    fv = -(v0 - v_mean) / wnd * tau00
    # [kg m/s2] -> [m2/s2]: extrapolate the surface density, divide by dz
    rho_mid = state["density_dry"] + state["water_vapor"]
    rho_int0 = 0.5 * (rho_mid[:, 0] + rho_mid[:, 1])
    rho_int1 = 0.5 * (rho_mid[:, 1] + rho_mid[:, 2])
    rho_sfc = 2.0 * rho_int0 - rho_int1
    dz0 = (state["vertical_interface_height"][:, 1] -
           state["vertical_interface_height"][:, 0])[:, None, None]
    out["sfc_mom_flx_u"] = fu * rho_sfc / dz0
    out["sfc_mom_flx_v"] = fv * rho_sfc / dz0
    return out

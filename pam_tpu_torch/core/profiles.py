"""Idealized analytic hydrostatic profiles, elementwise over tensors
(port of pam_tpu/core/profiles.py).

Parity reference: pam_core/idealized_profiles.h (const-theta, const-BVF,
supercell Weisman-Klemp-like profiles) and the static helpers in
dynamics/awfl/Dycore.h:716-830. Arguments that vary are tensors; the
constants are Python floats.
"""

from __future__ import annotations

import math

import torch


def saturation_vapor_pressure(temp):
    """Bolton-style svp [Pa] (ref: idealized_profiles.h:7-10)."""
    tc = temp - 273.15
    return 610.94 * torch.exp(17.625 * tc / (243.04 + tc))


def const_theta_density(t0, z, Rd, cp, gamma, p0, C0, grav):
    """Hydrostatic density for constant potential temperature
    (ref: idealized_profiles.h:13-19)."""
    exner = 1.0 - grav * z / (cp * t0)
    p = exner ** (cp / Rd) * p0
    rt = (p / C0) ** (1.0 / gamma)
    return rt / t0


def const_theta_pressure(t0, z, Rd, cp, gamma, p0, C0, grav):
    r = const_theta_density(t0, z, Rd, cp, gamma, p0, C0, grav)
    return C0 * (r * t0) ** gamma


def const_bvf_pot_temp(t0, bvf, z, grav):
    """(ref: idealized_profiles.h:36-38)."""
    return t0 * torch.exp(bvf * bvf * z / grav)


def const_bvf_density(t0, bvf, z, Rd, cp, gamma, C0, p0, grav):
    """(ref: idealized_profiles.h:41-48)."""
    t = const_bvf_pot_temp(t0, bvf, z, grav)
    exner = 1.0 - grav * grav / (cp * bvf * bvf) * (t - t0) / (t * t0)
    p = exner ** (cp / Rd) * p0
    rt = (p / C0) ** (1.0 / gamma)
    return rt / t


def supercell_temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top):
    """Piecewise-linear supercell sounding temperature
    (ref: idealized_profiles.h:58-68)."""
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    return torch.where(z <= z_trop,
                       T_0 - lapse_lo * (z - z_0),
                       T_trop - lapse_hi * (z - z_trop))


def supercell_pressure_dry(z, z_0, z_trop, z_top, T_0, T_trop, T_top,
                           p_0, R_d, grav):
    """Dry hydrostatic pressure for the supercell sounding
    (ref: idealized_profiles.h:71-91)."""
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    T = supercell_temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top)
    p_below = p_0 * (T / T_0) ** (grav / (R_d * lapse_lo))
    p_trop = p_0 * (T_trop / T_0) ** (grav / (R_d * lapse_lo))
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    if lapse_hi != 0:
        p_above = p_trop * (T / T_trop) ** (grav / (R_d * lapse_hi))
    else:
        p_above = p_trop * torch.exp(-grav * (z - z_trop) / (R_d * T_trop))
    return torch.where(z <= z_trop, p_below, p_above)


def supercell_relhum(z, z_0, z_trop):
    """(ref: idealized_profiles.h:95-101)."""
    return torch.where(z <= z_trop,
                       1.0 - 0.75 * torch.abs(z / z_trop) ** 1.25,
                       torch.full_like(z, 0.25))


def supercell_sat_mix_dry(press, T):
    """Saturation mixing ratio wrt dry pressure
    (ref: idealized_profiles.h:113-115)."""
    return 380.0 / press * torch.exp(17.27 * (T - 273.0) / (T - 36.0))


def ellipsoid_cosine(x, y, z, x0, y0, z0, xrad, yrad, zrad, amp, pwr=2.0):
    """Cosine-bump ellipsoid perturbation (ref: idealized_profiles.h:141-155;
    Dycore.h sample_ellipse_cosine uses pwr=2 with the half-pi convention —
    cos(pi*d/2)^2 over d<=1 equals ((cos(pi*d)+1)/2)^1; we keep the dycore's
    form: amp*cos(dist)^2 with dist = (pi/2)*d)."""
    xn = (x - x0) / xrad
    yn = (y - y0) / yrad
    zn = (z - z0) / zrad
    dist = torch.sqrt(xn * xn + yn * yn + zn * zn) * math.pi / 2.0
    return torch.where(dist <= math.pi / 2.0, amp * torch.cos(dist) ** 2.0,
                       torch.zeros_like(dist))


def hydro_const_theta(z, grav, C0, cp, p0, gamma, rd, theta0=300.0):
    """Hydrostatic (density, potential temperature) for constant theta
    background (ref: Dycore.h:739-748) — the Dycore-signature wrapper of
    :func:`const_theta_density`."""
    r = const_theta_density(theta0, z, rd, cp, gamma, p0, C0, grav)
    return r, theta0 * torch.ones_like(z)

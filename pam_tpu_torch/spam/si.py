"""Semi-implicit time integration for the SPAM dycore (port of
pam_tpu/spam/si.py: the reference states, the velocity linear system of
the x-z slab, the two pressure linear systems of the slab and of the 3-D
model, the quasi-Newton and fixed-point integrators and the exact
two-point discrete gradient).

Parity reference: ReferenceState + the test cases' set_reference_state
(EulerTestCase extrudedmodel.h:5413-5540, MoistEulerTestCase
:5624-5765, CoupledTestCase :5800-6056); CompressibleVelocityLinearSystem
(extrudedmodel.h:2531-3162: FFT in x + per-wavenumber complex vertical
tridiagonal for I + dt^2/4 L; slab only, :2561-2564);
CompressiblePressureLinearSystem (:3530-3970) and
CompressiblePressureGravityLinearSystem (:3970-4580): a pressure
Helmholtz solve, real FFT in x (and complex FFT in y in 3-D) + a real
vertical tridiagonal per wavenumber, the reference's only SI path for
ndims=2; the quasi-Newton integrator SI_Newton.h:13-150 with the discrete
gradient of time_integrator.h:49-90, PAM-coupled defaults
si_max_iters=3, si_nquad=2 (core/params.h:148-158); the fixed-point
integrator SI_Fixed.h:13-150.

Setup (reference state, linear-system coefficients) is numpy float64, as
in ``pam_tpu``; the coefficients are cast once to the run's dtype (and
complex64 / complex128) on the run's device. The integrators take the
slab layout and the 3-D one, where v and the mass flux F stack (x, y).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import dft
from ..ops.tridiag import pcr, thomas, use_pcr
from ..parallel import comm
from ..parallel.mesh import per_member
from ..utils import observe
from . import operators as op
from .testcases import saturation_vapor_pressure
from .thermo import ConstantKappaVirtualPottemp, IdealGasPottemp

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def gauss_01(n: int):
    """Gauss-Legendre points/weights on [0,1] (set_ref_quad_pts_wts)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def flat_geop(z, g):
    """(models/extrudedmodel.h flat_geop)."""
    return g * z


def profile_n1form(f, geom, nquad: int = 5):
    """Integral of a z-profile over each dual layer times dx (dual n1-form
    values; geometry.h set_profile_n1form_values). numpy (nens, nz)."""
    pts, wts = gauss_01(nquad)
    z0, z1 = geom.zint_d[:, :-1], geom.zint_d[:, 1:]
    dz = z1 - z0
    vals = sum(w * f(z0 + p * dz) for p, w in zip(pts, wts))
    return vals * dz * geom.dx * geom.dy


def _to_di(a):
    """Dual-interface values: boundary copy + midpoint average."""
    mid = 0.5 * (a[..., 1:] + a[..., :-1])
    return np.concatenate([a[..., :1], mid, a[..., -1:]], axis=-1)


def build_reference_state(geom, thermo, varset, refrho_f,
                          refentropicdensity_f, refnsq_f, grav):
    """SI reference-state columns of a dry test case from its profiles
    (EulerTestCase::set_reference_state, extrudedmodel.h:5413-5540;
    pam_tpu/spam/si.py:68-114). numpy float64, keyed like the reference's
    ReferenceState."""
    nz = geom.nz
    dens = np.zeros((varset.ndensity, geom.nens, nz))
    dens[varset.dens_id_mass] = profile_n1form(refrho_f, geom)
    dens[varset.dens_id_entr] = profile_n1form(refentropicdensity_f, geom)
    geop = profile_n1form(lambda z: flat_geop(z, grav), geom)

    # rho_pi / unscaled q_pi at primal levels = Hn1bar (diagonal) of dens
    dzd = geom.dz_d
    dens0 = dens / (geom.dx * geom.dy * dzd)
    rho_pi = dens0[varset.dens_id_mass]
    q_pi = dens0.copy()
    rho_di = _to_di(rho_pi)
    q_di = _to_di(q_pi)
    q_pi = q_pi / rho_pi
    q_di = q_di / rho_di
    # Nsq at primal levels (pointwise)
    Nsq_pi = np.asarray(refnsq_f(np.asarray(geom.zint_p)))
    if Nsq_pi.shape != rho_pi.shape:
        Nsq_pi = np.broadcast_to(Nsq_pi, rho_pi.shape).copy()
    # ref B (fac=-1; compressible_euler.h compute_dHsdx:77-112)
    geop0 = geop / (geom.dx * geom.dy * dzd)
    alpha = 1.0 / rho_pi
    sv = q_pi[varset.dens_id_entr]
    U = np.asarray(thermo.compute_U(alpha, sv))
    p = -np.asarray(thermo.compute_dUdalpha(alpha, sv))
    gexner = np.asarray(thermo.compute_dUdentropic_var(alpha, sv))
    B = np.zeros((varset.ndensity_active, geom.nens, nz))
    B[varset.dens_id_mass] = -(geop0 + U + p * alpha - sv * gexner)
    B[varset.dens_id_entr] = -gexner
    pres_pi = np.asarray(thermo.solve_p(rho_pi, sv))
    pres_di = np.asarray(thermo.solve_p(rho_di, q_di[varset.dens_id_entr]))
    return dict(dens=dens, geop=geop, rho_pi=rho_pi, q_pi=q_pi,
                rho_di=rho_di, q_di=q_di, Nsq_pi=Nsq_pi, B=B,
                pres_pi=pres_pi, pres_di=pres_di)


def build_moist_reference_state(geom, thermo, varset, refdens, refnsq_f,
                                grav):
    """SI reference state from prescribed moist reference-density columns
    (MoistEulerTestCase::set_reference_state, extrudedmodel.h:5624-5765;
    pam_tpu/spam/si.py:117-174): rho and q at primal levels by the
    diagonal Hn1bar, midpoint averages at the dual interfaces, B with
    fac=-1 and the moist chemical potentials. refdens: (ndens, nens, nz)
    twisted n-forms with the mass, entropy and vapour rows set."""
    nz, nens = geom.nz, geom.nens
    refdens = np.asarray(refdens, np.float64)
    vol = geom.dx * geom.dy * geom.dz_d
    geop = profile_n1form(lambda z: flat_geop(z, grav), geom)

    q_pi = refdens / vol                       # unscaled (Hn1bar diagonal)
    rho_pi = q_pi[varset.dens_id_mass].copy()
    q_di = _to_di(q_pi)
    rho_di = _to_di(rho_pi)
    q_pi = q_pi / rho_pi
    q_di = q_di / rho_di

    Nsq_pi = np.asarray(refnsq_f(np.asarray(geom.zint_p)))
    if Nsq_pi.shape != rho_pi.shape:
        Nsq_pi = np.broadcast_to(Nsq_pi, rho_pi.shape).copy()

    # B with fac=-1 (compressible_euler.h compute_dHsdx:304-350)
    geop0 = geop / vol
    sv_pi = q_pi[varset.dens_id_entr]
    qv_pi = q_pi[varset.dens_id_vap]
    qd_pi = 1.0 - qv_pi
    z0 = np.zeros_like(qv_pi)
    alpha_pi = 1.0 / rho_pi
    U = np.asarray(thermo.compute_U(alpha_pi, sv_pi, qd_pi, qv_pi, z0, z0))
    p = -np.asarray(thermo.compute_dUdalpha(alpha_pi, sv_pi, qd_pi, qv_pi,
                                            z0, z0))
    gexner = np.asarray(thermo.compute_dUdentropic_var(
        alpha_pi, sv_pi, qd_pi, qv_pi, z0, z0))
    mu_d, mu_v, _, _ = (np.asarray(m) for m in thermo.compute_dUdq(
        alpha_pi, sv_pi, qd_pi, qv_pi, z0, z0))
    B = np.zeros((varset.ndensity_active, nens, nz))
    B[varset.active_id_mass] = -(geop0 + U + p * alpha_pi - sv_pi * gexner +
                                 qv_pi * (mu_d - mu_v))
    B[varset.active_id_entr] = -gexner

    pres_pi = np.asarray(thermo.solve_p(rho_pi, sv_pi, qd_pi, qv_pi, z0, z0))
    qv_di = q_di[varset.dens_id_vap]
    pres_di = np.asarray(thermo.solve_p(
        rho_di, q_di[varset.dens_id_entr], 1.0 - qv_di, qv_di,
        np.zeros_like(qv_di), np.zeros_like(qv_di)))
    return dict(dens=refdens, geop=geop, rho_pi=rho_pi, q_pi=q_pi,
                rho_di=rho_di, q_di=q_di, Nsq_pi=Nsq_pi, B=B,
                pres_pi=pres_pi, pres_di=pres_di)


def build_coupled_reference_state(state, geom, thermo, varset, grav):
    """SI reference state from the coupler's ``ref_*`` columns
    (CoupledTestCase::set_reference_state, extrudedmodel.h:5800-6056).
    Only the (nens, nz) ref_density_dry/vapor/liq/ice and ref_temp columns
    of ``state`` are read. Returns numpy float64 arrays."""
    nz, nens, ndens = geom.nz, geom.nens, varset.ndensity
    col = lambda k: np.asarray(torch.as_tensor(state[k]).cpu(), np.float64)
    rho_d = col("ref_density_dry")
    rho_v = col("ref_density_vapor")
    rho_l = col("ref_density_liq")
    rho_i = col("ref_density_ice")
    temp = col("ref_temp")
    rho = rho_d + rho_v
    qd, qv = rho_d / rho, rho_v / rho
    ql, qi = rho_l / rho, rho_i / rho
    alpha = 1.0 / rho
    sv = thermo.compute_entropic_var_from_alpha_T(alpha, temp, qd, qv, ql, qi)

    vol = geom.dx * geom.dy * geom.dz_d                          # (nens, nz)
    dens = np.zeros((ndens, nens, nz))
    dens[varset.dens_id_mass] = rho * vol
    dens[varset.dens_id_entr] = sv * rho * vol
    dens[varset.dens_id_vap] = rho_v * vol
    geop = profile_n1form(lambda z: flat_geop(z, grav), geom)

    # unscaled q at primal levels ("Coupled reference state 1", :5850-5882)
    q_pi = np.zeros((ndens, nens, nz))
    q_pi[varset.dens_id_mass] = rho
    q_pi[varset.dens_id_entr] = rho * sv
    q_pi[varset.dens_id_vap] = rho_v
    rho_pi = dens[varset.dens_id_mass] / vol                    # Hn1bar diag

    # interface interpolation with the reference's grid weights
    # ("compute unscaled q_di", :5884-5906), boundaries copied
    wgt = (geom.zint_d[:, 1:nz] - geom.zint_p[:, :nz - 1]) / geom.dz_p

    def to_di(a):
        mid = a[..., :-1] + (a[..., 1:] - a[..., :-1]) * wgt
        return np.concatenate([a[..., :1], mid, a[..., -1:]], axis=-1)

    q_di = to_di(q_pi)
    rho_di = to_di(rho_pi)
    q_pi = q_pi / rho_pi
    q_di = q_di / rho_di

    # moist Brunt-Vaisala frequency ("compute Nsq", :5975-6031)
    c = thermo.cst
    eta = c.Rv / c.Rd
    rv = rho_v / rho_d
    idx_m = np.concatenate([[0], np.arange(nz - 1)])        # k-1 clamped
    idx_p = np.concatenate([np.arange(1, nz), [nz - 1]])    # k+1 clamped
    dzp = geom.dz_p
    dz = np.empty((nens, nz))
    dz[:, 0] = dzp[:, 0]
    dz[:, -1] = dzp[:, -1]
    dz[:, 1:-1] = dzp[:, 1:] + dzp[:, :-1]
    dTdz = (temp[:, idx_p] - temp[:, idx_m]) / dz
    drvdz = (rv[:, idx_p] - rv[:, idx_m]) / dz
    T = temp
    Tv = T * (1 + eta * rv) / (1 + rv)
    es = saturation_vapor_pressure(T)
    rsw = (es / (c.Rd * T) - 1) * c.Rd / c.Rv
    qsw = rsw / (1 + rsw)
    D1w = 1 + (1 + eta * rsw) * c.Lvr * qsw / (c.Rd * Tv)
    D2w = 1 + (1 + eta * rsw) * c.Lvr * c.Lvr * qsw / (c.Cpd * c.Rv * T * T)
    gamma_m = grav / c.Cpd * D1w / D2w
    Nsq_pi = grav / T * D1w * (dTdz + gamma_m) - grav / (1 + rv) * drvdz

    # ref B with fac=-1 (compute_dHsdx, compressible_euler.h:304-350)
    geop0 = geop / vol
    sv_pi = q_pi[varset.dens_id_entr]
    qv_pi = q_pi[varset.dens_id_vap]
    qd_pi = 1.0 - qv_pi
    z0 = np.zeros_like(qv_pi)
    alpha_pi = 1.0 / rho_pi
    U = thermo.compute_U(alpha_pi, sv_pi, qd_pi, qv_pi, z0, z0)
    p = -thermo.compute_dUdalpha(alpha_pi, sv_pi, qd_pi, qv_pi, z0, z0)
    gexner = thermo.compute_dUdentropic_var(alpha_pi, sv_pi, qd_pi, qv_pi,
                                            z0, z0)
    mu_d, mu_v, _, _ = thermo.compute_dUdq(alpha_pi, sv_pi, qd_pi, qv_pi,
                                           z0, z0)
    B = np.zeros((varset.ndensity_active, nens, nz))
    B[varset.active_id_mass] = -(geop0 + U + p * alpha_pi - sv_pi * gexner +
                                 qv_pi * (mu_d - mu_v))
    B[varset.active_id_entr] = -gexner

    # reference pressure profiles (":Compute refstate pres_pi/di", :6033-6056)
    pres_pi = thermo.solve_p(rho_pi, sv_pi, qd_pi, qv_pi, z0, z0)
    qv_di = q_di[varset.dens_id_vap]
    pres_di = thermo.solve_p(rho_di, q_di[varset.dens_id_entr], 1.0 - qv_di,
                             qv_di, np.zeros_like(qv_di),
                             np.zeros_like(qv_di))
    return dict(dens=dens, geop=geop, rho_pi=rho_pi, q_pi=q_pi,
                rho_di=rho_di, q_di=q_di, Nsq_pi=Nsq_pi, B=B,
                pres_pi=pres_pi, pres_di=pres_di)


# ---------------------------------------------------------------------------
# Compressible velocity linear system
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class CompressibleVelocityLinearSystem:
    """(I + dt^2/4 L)^-1 for the linearized compressible system
    (extrudedmodel.h:2531-3162), coefficients precomputed for a fixed dt.
    Real coefficients are in the run dtype, complex ones in the matching
    complex dtype, all on the run device."""
    geom: Any
    varset: Any
    dt: float
    Blin: torch.Tensor = per_member(2)  # (2, 2, nens, ni_p)
    vcoeff0: torch.Tensor = per_member(0)  # (nens, ni_p, nx) complex
    tri_l: torch.Tensor = per_member(0)  # (nens, nl_p, nx) complex
    tri_d: torch.Tensor = per_member(0)
    tri_u: torch.Tensor = per_member(0)
    # (nens, nl_p, nx) complex (w-rhs coupling)
    a_kp1: torch.Tensor = per_member(0)
    a_k: torch.Tensor = per_member(0)
    # (nens, ni_p, nx) complex (vhat recovery)
    g_up: torch.Tensor = per_member(0)
    g_dn: torch.Tensor = per_member(0)
    q_pi: torch.Tensor = per_member(1)  # (ndens, nens, ni_p)
    q_di: torch.Tensor = per_member(1)  # (ndens, nens, ni_d)
    rho_pi: torch.Tensor = per_member(0)  # (nens, ni_p)
    rho_di: torch.Tensor = per_member(0)  # (nens, ni_d)

    @staticmethod
    def build(geom, thermo, varset, refstate, dt, grav=9.80616):
        """compute_coefficients (extrudedmodel.h:2605-2844), numpy float64."""
        nz, nx, nens = geom.nz, geom.nx, geom.nens
        ni, nl = nz, nz - 1                 # primal levels / layers
        dtf2 = dt * dt / 4.0

        rho_pi = refstate["rho_pi"]         # (nens, ni)
        q_pi = refstate["q_pi"][:2]         # dycore densities only
        rho_di = refstate["rho_di"]
        q_di = refstate["q_di"][:2]
        Nsq = refstate["Nsq_pi"]

        # Blin_coeff (:2643-2696)
        alpha = 1.0 / rho_pi
        s_ref = q_pi[1]
        dpds = thermo.compute_dpdentropic_var(alpha, s_ref)
        cref = thermo.compute_soundspeed(alpha, s_ref)
        cref2 = cref ** 2
        g2 = grav * grav
        rho2 = rho_pi ** 2
        dpds2 = dpds ** 2
        b0_s = dpds / rho_pi - dpds2 * s_ref / (cref2 * rho2) - \
            dpds2 * g2 * s_ref / (Nsq * cref2 * cref2 * rho2)
        b0_rho = (cref2 * rho_pi - dpds * s_ref) / rho2 - \
            s_ref / rho_pi * b0_s
        b0_S = b0_s / rho_pi
        b1_s = dpds2 * (Nsq * cref2 + g2) / (Nsq * cref2 * cref2 * rho2)
        b1_rho = dpds / rho2 - s_ref / rho_pi * b1_s
        b1_S = b1_s / rho_pi
        Blin = np.stack([np.stack([b0_rho, b0_S]),
                         np.stack([b1_rho, b1_S])])   # (2,2,nens,ni)

        # fourier symbols (ext_deriv.h:929-979), m over full fft bins
        th = 2.0 * np.pi * np.arange(nx) / nx
        fD0 = 1.0 - np.exp(-1j * th)
        fDnm1bar = np.exp(1j * th) - 1.0
        fD0Dnm1bar = 2.0 * (np.cos(th) - 1.0)

        dzd, dzp = geom.dz_d, geom.dz_p
        fH2bar = 1.0 / (geom.dx * dzd)                 # (nens, ni)
        fH1h = dzd / geom.dx
        # H01 diagonal at dual interfaces k=1..nz-1; boundaries unused -> 0
        H01d = np.zeros((nens, nz + 1))
        H01d[:, 1:nz] = geom.dx / dzp
        gamma_fac = rho_di * H01d                      # (nens, ni_d)

        # vcoeff (:2698-2740)
        he = rho_pi
        qBq = np.einsum('aek,abek,bek->ek', q_pi, Blin, q_pi)
        c1 = 1.0 - dtf2 * (fH2bar * fH1h * he * qBq)[:, :, None] * \
            fD0Dnm1bar[None, None, :]                  # (nens, ni, nx)
        vcoeff0 = 1.0 / c1
        qB = np.einsum('bek,baek->aek', q_pi, Blin)    # (2, nens, ni)
        vcoeff_d = (dtf2 * (fH2bar[None] * qB)[:, :, :, None] *
                    fD0[None, None, None, :]) / c1[None]

        # vertical tridiagonal (:2742-2786), k = 0..nl-1
        k = np.arange(nl)
        tri_u = np.zeros((nens, nl, nx), np.complex128)
        tri_d = np.ones((nens, nl, nx), np.complex128)
        tri_l = np.zeros((nens, nl, nx), np.complex128)
        A_kp1 = q_di[:, :, k + 1]                      # (2, nens, nl)
        beta = Blin * fH2bar[None, None]
        b_kp1 = beta[:, :, :, k + 1]
        b_k = beta[:, :, :, k]
        g_kp2 = gamma_fac[:, k + 2] * q_di[:, :, k + 2]
        g_kp1 = gamma_fac[:, k + 1] * q_di[:, :, k + 1]
        g_k = gamma_fac[:, k] * q_di[:, :, k]
        tri_u += (-dtf2 * np.einsum('aek,abek,bek->ek', A_kp1, b_kp1,
                                    g_kp2))[..., None]
        tri_d += (dtf2 * np.einsum('aek,abek,bek->ek', A_kp1, b_kp1 + b_k,
                                   g_kp1))[..., None]
        tri_l += (-dtf2 * np.einsum('aek,abek,bek->ek', A_kp1, b_k,
                                    g_k))[..., None]

        # horizontal contribution (:2788-2843)
        def beta_h(kidx):
            core = np.einsum('abek,bek->aek', Blin[:, :, :, kidx],
                             q_pi[:, :, kidx]) * \
                (fH2bar * he * fH1h)[None, :, kidx]
            return core[..., None] * fDnm1bar[None, None, None, :]

        bh_kp1 = beta_h(k + 1)
        bh_k = beta_h(k)
        vc_kp1 = vcoeff_d[:, :, k + 1, :]
        vc_k = vcoeff_d[:, :, k, :]
        alpha_kp1 = dtf2 * q_di[:, :, k + 1]
        tri_u += -np.einsum('aek,aekm,cekm,cek->ekm', alpha_kp1, bh_kp1,
                            vc_kp1, g_kp2)
        tri_d += np.einsum('aek,aekm,cekm,cek->ekm', alpha_kp1, bh_kp1,
                           vc_kp1, g_kp1) + \
            np.einsum('aek,aekm,cekm,cek->ekm', alpha_kp1, bh_k, vc_k, g_kp1)
        tri_l += -np.einsum('aek,aekm,cekm,cek->ekm', alpha_kp1, bh_k,
                            vc_k, g_k)

        # w-rhs coupling (solve:2970-3023)
        a_kp1 = np.einsum('aek,aekm->ekm', dtf2 * q_di[:, :, k + 1],
                          bh_kp1) * vcoeff0[:, k + 1, :]
        a_k = np.einsum('aek,aekm->ekm', dtf2 * q_di[:, :, k + 1],
                        bh_k) * vcoeff0[:, k, :]

        # vhat recovery (solve:3052-3077)
        ki = np.arange(ni)
        g_up = np.einsum('aekm,aek->ekm', vcoeff_d,
                         gamma_fac[:, ki + 1] * q_di[:, :, ki + 1])
        g_dn = np.einsum('aekm,aek->ekm', vcoeff_d,
                         gamma_fac[:, ki] * q_di[:, :, ki])

        R = lambda a: torch.as_tensor(a, dtype=geom.dtype, device=geom.device)
        C = lambda a: torch.as_tensor(a, dtype=_COMPLEX[geom.dtype],
                                      device=geom.device)
        return CompressibleVelocityLinearSystem(
            geom=geom, varset=varset, dt=dt, Blin=R(Blin), vcoeff0=C(vcoeff0),
            tri_l=C(tri_l), tri_d=C(tri_d), tri_u=C(tri_u), a_kp1=C(a_kp1),
            a_k=C(a_k), g_up=C(g_up), g_dn=C(g_dn), q_pi=R(refstate["q_pi"]),
            q_di=R(refstate["q_di"]), rho_pi=R(rho_pi), rho_di=R(rho_di))

    # ------------------------------------------------------------------
    def _tridiag(self, rhs):
        """Complex tridiagonal solve over the nl levels, batched over
        (nens, nx): the Thomas recurrence (extrudedmodel.h:3025-3050) or
        PCR (ops/tridiag.py::use_pcr)."""
        mv = lambda a: a.movedim(1, 0)
        solve = pcr if use_pcr(rhs) else thomas
        return solve(mv(self.tri_l), mv(self.tri_d), mv(self.tri_u),
                     mv(rhs)).movedim(0, 1)

    def solve(self, rhs_dens, rhs_v, rhs_w):
        """(extrudedmodel.h solve:2846-3161). rhs_dens (ndens,nens,nz,nx),
        rhs_v (nens,nz,nx), rhs_w (nens,nz-1,nx) -> solutions, same shapes."""
        g = self.geom
        nz = g.nz
        dtf = self.dt / 2.0
        q_pi, q_di = self.q_pi, self.q_di

        # rhs 1 - B (:2909-2926)
        rhs0 = op.Hn1bar(rhs_dens[:2], g)              # (2, nens, nz, nx)
        bvar = -dtf * torch.einsum('abek,bekx->aekx', self.Blin, rhs0)
        # rhs 2 - v/w transforms (:2930-2946)
        mod_v = torch.einsum('aek,aekx->ekx', q_pi[:2],
                             bvar - op.rollm(bvar, -1))
        v_t = rhs_v + mod_v
        mod_w = torch.einsum('aek,aekx->ekx', q_di[:2, :, 1:nz],
                             bvar[:, :, 1:, :] - bvar[:, :, :-1, :])
        w_t = rhs_w + mod_w

        # under x sharding the forward transform is the psum-DFT (the
        # spectrum comes out whole on every x rank, the tridiagonal runs
        # on it redundantly) and the inverse needs no communication
        # (ops/dft.py; pam_tpu/spam/si.py:501-522)
        vhat = dft.fft_sh(v_t)
        what = dft.fft_sh(w_t)
        # modify wrhs (:2970-3023)
        what = what + self.a_kp1 * vhat[:, 1:, :] - self.a_k * vhat[:, :-1, :]
        what = self._tridiag(what)
        # compute vhat (:3052-3077)
        zrow = torch.zeros_like(what[:, :1, :])
        w_up = torch.cat([what, zrow], dim=1)          # w(k) for k<ni-1
        w_dn = torch.cat([zrow, what], dim=1)          # w(k-1) for k>0
        vhat = self.vcoeff0 * vhat + self.g_up * w_up - self.g_dn * w_dn
        sol_v = dft.ifft_real_sh(vhat)
        sol_w = dft.ifft_real_sh(what)

        # recover densities (:3085-3159)
        F = op.H10(sol_v, g) * self.rho_pi[:, :, None]
        FW_in = sol_w * (g.dx / g.dz_p_t[:, :, None]) * \
            self.rho_di[:, 1:nz, None]
        zr = torch.zeros_like(FW_in[:, :1, :])
        FW = torch.cat([zr, FW_in, zr], dim=1)         # (nens, nz+1, nx)
        ddens = torch.einsum('aek,ekx->aekx', q_pi, op.rollm(F, 1) - F) + \
            torch.einsum('aek,ekx->aekx', q_di[:, :, 1:], FW[:, 1:, :]) - \
            torch.einsum('aek,ekx->aekx', q_di[:, :, :-1], FW[:, :-1, :])
        sol_dens = rhs_dens - (self.dt / 2.0) * ddens
        return sol_dens, sol_v, sol_w


# ---------------------------------------------------------------------------
# SI (quasi-Newton) time integrator
# ---------------------------------------------------------------------------

def gamma_avg(a, b, gamma):
    """Exact discrete-gradient average of x^(gamma-1),
    (a^g - b^g) / (g (a - b)), with its series near a == b
    (compressible_euler.h gamma_avg:10-23). Both branches are evaluated;
    the exact one divides by 1 where the series is taken, so neither
    carries a NaN into the select."""
    f = (a - b) / (a + b)
    v = f * f
    c1 = (gamma - 1.0) * (gamma - 2.0) / 6.0
    c2 = (gamma - 3.0) * (gamma - 4.0) / 20.0
    c3 = (gamma - 5.0) * (gamma - 6.0) / 42.0
    x = (0.5 * (a + b)) ** (gamma - 1.0)
    series = x * (1.0 + c1 * v * (1.0 + c2 * v * (1.0 + c3 * v)))
    near = v < 1e-4
    denom = torch.where(near, torch.ones_like(a), gamma * (a - b))
    exact = (a ** gamma - b ** gamma) / denom
    return torch.where(near, series, exact)


def two_point_discrete_gradient(tend, x1, x2, geop):
    """The exact two-point discrete gradient of the CE/MCE Hamiltonians
    with the pottemp-family potentials (compute_two_point_discrete_gradient,
    extrudedmodel.h:2086-2172 + compressible_euler.h:114-157, 260-304):

      F = 1/4 (he1 + he2)(u1 + u2);  FW likewise;  K = (K1 + K2)/2
      B_mass = Hn1bar(geop) + Hn1bar(K)   (U + p alpha - sv Pi == 0 for
               these potentials; moist species decouple)
      B_entr = Cpd (Rd/pr)^(gamma-1) gamma_avg(Tht1, Tht2, gamma)

    One evaluation in place of the nquad-point quadrature; it makes the
    implicit-midpoint energy balance exact (si_two_point_discrete_gradient,
    params.h:158)."""
    g, vs, th = tend.geom, tend.varset, tend.thermo
    if x1[0].ndim != 4:
        raise ValueError("the two-point discrete gradient is slab-only, as "
                         "in pam_tpu (si.py:576)")
    if not isinstance(th, (IdealGasPottemp, ConstantKappaVirtualPottemp)):
        raise NotImplementedError(
            "two-point discrete gradient not implemented for this "
            f"hamiltonian/thermo combination ({type(th).__name__}); the "
            "reference throws likewise (extrudedmodel.h:2100-2103)")

    def he_u_K(dens, v, w):
        rho0 = op.Hn1bar_ho(vs.get_total_density(dens), g, tend.diff_ord)
        he = op.phi_x(rho0)
        hew = op.phi_z_iface(op.mirror_layer(rho0, 1))
        u = op.H10_ho(v, g, tend.diff_ord)
        uw = op.H01(w, g)
        Kh = 0.5 * (v * u + op.rollm(v, 1) * op.rollm(u, 1))
        w_pad = op.mirror_layer(w, 1)
        Kv = 0.5 * (w_pad[..., :-1, :] * uw[..., :-1, :] +
                    w_pad[..., 1:, :] * uw[..., 1:, :])
        return he, hew, u, uw, 0.5 * (Kh + Kv)

    he1, hew1, u1, uw1, K1 = he_u_K(*x1)
    he2, hew2, u2, uw2, K2 = he_u_K(*x2)
    F = 0.25 * (he1 + he2) * (u1 + u2)
    FW = 0.25 * (hew1 + hew2) * (uw1 + uw2)
    K = 0.5 * (K1 + K2)
    area = g.area_n1_t[:, :, None]
    Tht1 = x1[0][vs.dens_id_entr] / area
    Tht2 = x2[0][vs.dens_id_entr] / area
    cst = th.cst
    gexner = cst.Cpd * (cst.Rd / cst.pr) ** (cst.gamma_d - 1.0) * \
        gamma_avg(Tht1, Tht2, cst.gamma_d)
    B_mass = op.Hn1bar(geop, g) + op.Hn1bar(K, g)
    return F, FW, torch.stack([B_mass, gexner])


def _discrete_gradient(tend, x, xn, geop, pts, wts):
    """Quadrature-averaged functional derivatives between x and xn
    (time_integrator.h compute_discrete_gradient:51-70), one quadrature
    point after another."""
    Fa = FWa = Ba = None
    for p, wt in zip(pts, wts):
        xq = [(1 - p) * a + p * b for a, b in zip(x, xn)]
        Fq, FWq, _, Bq = tend.functional_derivatives(*xq, geop)
        if Fa is None:
            Fa, FWa, Ba = wt * Fq, wt * FWq, wt * Bq
        else:
            Fa, FWa, Ba = Fa + wt * Fq, FWa + wt * FWq, Ba + wt * Bq
    return Fa, FWa, Ba


def _apply_symplectic_full(tend, xm, Fa, FWa, Ba, dt):
    """apply_symplectic with the recon upwinding on the MIDPOINT mass
    fluxes he(xm)*u(xm) while FCT and the final tendencies keep the
    averaged Fa/FWa (SI_Newton.h:86-89, extrudedmodel.h:2188-2204), then
    the model's post hook where it has one (the anelastic rho pinning and
    pressure projection, add_pressure_perturbation; pam_tpu/spam/si.py:
    653-655)."""
    F2, FW2, _, _ = tend.functional_derivatives(xm[0], xm[1], xm[2],
                                                torch.zeros_like(xm[0][0]))
    out = tend.apply_symplectic(xm[0], xm[1], xm[2], Fa, FWa, Ba, dt,
                                F_recon=F2, FW_recon=FW2)
    post = getattr(tend, "post_symplectic", None)
    return out if post is None else post(*out)


def _quadrature(nquad):
    pts, wts = gauss_01(nquad)
    return [float(p) for p in pts], [float(q) for q in wts]


def _newton_update(tend, linsys, dens, v, w, geop, dt, res, xn, pts, wts,
                   two_point):
    """One quasi-Newton iteration (SI_Newton.h:60-106): solve, update xn,
    evaluate the discrete gradient between (dens, v, w) and xn, return
    (xn, new residual)."""
    with observe.span("pam:si.solve"):
        sol = linsys.solve(*res)
    xn = tuple(a + b for a, b in zip(xn, sol))
    with observe.span("pam:si.discrete_gradient"):
        if two_point:
            Fa, FWa, Ba = two_point_discrete_gradient(tend, (dens, v, w),
                                                      xn, geop)
        else:
            Fa, FWa, Ba = _discrete_gradient(tend, (dens, v, w), xn, geop,
                                             pts, wts)
    xm = tuple(0.5 * (a + b) for a, b in zip((dens, v, w), xn))
    with observe.span("pam:si.symplectic"):
        dxd, dxv, dxw = _apply_symplectic_full(tend, xm, Fa, FWa, Ba, dt)
    res = (dens - xn[0] - dt * dxd, v - xn[1] - dt * dxv,
           w - xn[2] - dt * dxw)
    return xn, res


def si_step(tend, linsys, dens, v, w, geop, dt, max_iters: int = 3,
            nquad: int = 2, two_point: bool = False):
    """One semi-implicit step (SI_Newton.h step_forward:31-149) with the
    PAM-coupled fixed iteration count: compute_rhs, max_iters-1
    quasi-Newton evaluations, max_iters linear solves. two_point takes the
    exact two-point discrete gradient in place of the nquad-point
    quadrature (si_two_point_discrete_gradient, params.h:158; off by
    default, as in the reference)."""
    pts, wts = _quadrature(nquad)
    with observe.span("pam:si.compute_rhs"):
        dxd, dxv, dxw = tend.compute_rhs(dens, v, w, geop, dt)
    xn = (dens, v, w)
    res = (-dt * dxd, -dt * dxv, -dt * dxw)
    for _ in range(max_iters - 1):
        xn, res = _newton_update(tend, linsys, dens, v, w, geop, dt, res, xn,
                                 pts, wts, two_point)
    with observe.span("pam:si.solve"):
        sol = linsys.solve(*res)
    return tuple(a + b for a, b in zip(xn, sol))


def _res_norm(res):
    """Max-abs norm over every prognostic field (time_integrator.h
    norm:9-17)."""
    return torch.maximum(torch.maximum(res[0].abs().max(), res[1].abs().max()),
                         res[2].abs().max())


def si_step_monitored(tend, linsys, dens, v, w, geop, dt,
                      max_iters: int = 3, nquad: int = 2,
                      two_point: bool = False):
    """si_step with the residual norm of each iteration, the reference's
    si_monitor_convergence > 0 diagnostic (SI_Newton.h:52-106). Returns
    (xn, norms): norms[0] the initial residual, norms[i] the residual after
    iteration i (max_iters + 1 entries; norms[i] / norms[0] is compared
    with si_tolerance). Every iteration ends with its evaluation, so xn is
    the state after max_iters solves."""
    pts, wts = _quadrature(nquad)
    dxd, dxv, dxw = tend.compute_rhs(dens, v, w, geop, dt)
    xn = (dens, v, w)
    res = (-dt * dxd, -dt * dxv, -dt * dxw)
    norms = [_res_norm(res)]
    for _ in range(max_iters):
        xn, res = _newton_update(tend, linsys, dens, v, w, geop, dt, res, xn,
                                 pts, wts, two_point)
        norms.append(_res_norm(res))
    return xn, torch.stack(norms)


def si_fixed_step(tend, dens, v, w, geop, dt, max_iters: int = 5,
                  nquad: int = 2):
    """One fixed-point semi-implicit step (SIFixedTimeIntegrator,
    SI_Fixed.h:13-150): x^{n+1} <- x^n - dt J((x + xn)/2) dH~(x, xn), with
    no linear solve and a fixed iteration count (the fixed-point rhs is
    evaluated max_iters-1 times, SI_Fixed.h:77-107)."""
    pts, wts = _quadrature(nquad)
    x = (dens, v, w)
    dx = tend.compute_rhs(dens, v, w, geop, dt)
    for _ in range(max_iters - 1):
        xn = tuple(a - dt * b for a, b in zip(x, dx))
        Fa, FWa, Ba = _discrete_gradient(tend, x, xn, geop, pts, wts)
        xm = tuple(0.5 * (a + b) for a, b in zip(x, xn))
        dx = _apply_symplectic_full(tend, xm, Fa, FWa, Ba, dt)
    return tuple(a - dt * b for a, b in zip(x, dx))


# ---------------------------------------------------------------------------
# Compressible PRESSURE linear systems (the reference default,
# params.linear_system == "pressure", and its gravity-aware variant);
# slab (ndims=1) and 3-D (ndims=2) layouts
# ---------------------------------------------------------------------------

def _tridiag_real(L, D, U, R):
    """Tridiagonal solve along level axis 1 with real (nens, nz, ...)
    coefficients (broadcastable against R) and a real or complex rhs R:
    the Thomas recurrence, whose elimination factors stay real
    (extrudedmodel.h solve_for_pressure:3806-3830), or PCR
    (ops/tridiag.py::use_pcr) on the coefficients cast to R's dtype, as
    pam_tpu casts them."""
    mv = lambda a: a.movedim(1, 0)
    if use_pcr(R):
        L, D, U = (a.to(R.dtype) for a in (L, D, U))
        return pcr(mv(L), mv(D), mv(U), mv(R)).movedim(0, 1)
    return thomas(mv(L), mv(D), mv(U), mv(R)).movedim(0, 1)


def _zslice(ndim, za, sl):
    """Index of slice ``sl`` along axis ``za`` of an ndim-dim tensor."""
    idx = [slice(None)] * ndim
    idx[za] = sl
    return tuple(idx)


def _horizontal_symbol(geom, ndims, dzd):
    """Fourier symbol of the horizontal part of the pressure operator per
    (member, level, [ky,] kx): the rfft bins along x (and the full fft
    bins along y in 3-D) of cw D0 Dnm1bar, weighted by the H1 stars.
    Returns (symbol, trailing index that broadcasts a (nens, nz) column
    against it)."""
    thx = 2.0 * np.pi * np.arange(geom.nx // 2 + 1) / geom.nx  # rfft bins
    fDDx = 2.0 * (np.cos(thx) - 1.0)
    fH1x = dzd * geom.dy / geom.dx
    if ndims == 2:
        thy = 2.0 * np.pi * np.arange(geom.ny) / geom.ny
        fDDy = 2.0 * (np.cos(thy) - 1.0)
        fH1y = dzd * geom.dx / geom.dy
        horiz = (fH1x[:, :, None, None] * fDDx[None, None, None, :] +
                 fH1y[:, :, None, None] * fDDy[None, None, :, None])
        return horiz, (Ellipsis, None, None)
    return fH1x[:, :, None] * fDDx[None, None, :], (Ellipsis, None)


@dataclasses.dataclass(frozen=True, eq=False)
class CompressiblePressureLinearSystem:
    """(I + dt^2/4 L)^-1 by a pressure Helmholtz solve: horizontal FFT +
    a real vertical tridiagonal in p per wavenumber, then the velocity
    and density updates (extrudedmodel.h:3530-3970). The slab layout
    (nens, nz, nx) and the 3-D layout (nens, nz, ny, nx). Every tensor is
    in the geometry's dtype ``dtype``, the only dtype a solve takes
    (pam_tpu casts its numpy columns to the rhs dtype at each solve,
    si.py:911-918: the same cast points, so float32 solves stay
    float32)."""
    geom: Any
    varset: Any
    dt: float
    ndims: int
    dtype: torch.dtype
    linp: torch.Tensor = per_member(1)  # (nact, nens, nz)
    tri_l: torch.Tensor = per_member(0)  # (nens, nz, [ny,] nxr) real
    tri_d: torch.Tensor = per_member(0)
    tri_u: torch.Tensor = per_member(0)
    q_pi: torch.Tensor = per_member(1)  # (ndens, nens, nz)
    q_di: torch.Tensor = per_member(1)  # (ndens, nens, nz+1)
    rho_pi: torch.Tensor = per_member(0)  # (nens, nz)
    rho_di: torch.Tensor = per_member(0)  # (nens, nz+1)
    dz_d: torch.Tensor = per_member(0)  # (nens, nz)
    dz_p: torch.Tensor = per_member(0)  # (nens, nz-1)

    @staticmethod
    def _coefficients(geom, thermo, varset, refstate, dt):
        """compute_coefficients (extrudedmodel.h:3545-3660), numpy
        float64: a dict of the plain system's arrays."""
        nz, nens = geom.nz, geom.nens
        ndims = 2 if geom.ny > 1 else 1
        al = dt / 2.0
        rho_pi = np.asarray(refstate["rho_pi"])
        q_pi = np.asarray(refstate["q_pi"])
        rho_di = np.asarray(refstate["rho_di"])
        q_di = np.asarray(refstate["q_di"])

        # linear pressure coefficients (variableset.h linear_pressure_coeffs
        # VS_CE:1072 / VS_MCE_rho:1576)
        alpha_ref = 1.0 / rho_pi
        sv = q_pi[varset.dens_id_entr]
        if varset.variant == "CE":
            qv = np.zeros_like(sv)
        else:
            qv = q_pi[varset.dens_id_vap]
        qd = 1.0 - qv
        z = np.zeros_like(sv)
        cs = np.asarray(thermo.compute_soundspeed(alpha_ref, sv, qd, qv, z, z))
        dpds = np.asarray(thermo.compute_dpdentropic_var(alpha_ref, sv, qd,
                                                         qv, z, z))
        linp = np.zeros((varset.ndensity_active, nens, nz))
        linp[varset.active_id_mass] = cs * cs - sv * alpha_ref * dpds
        linp[varset.active_id_entr] = alpha_ref * dpds

        dzd, dzp = geom.dz_d, geom.dz_p
        fHn1bar = 1.0 / (geom.dx * geom.dy * dzd)    # (nens, nz)
        horiz, ex = _horizontal_symbol(geom, ndims, dzd)
        qlinp = np.einsum('aek,aek->ek', q_pi[:varset.ndensity_active],
                          linp)
        tri_d = 1.0 - (al * al) * (fHn1bar * qlinp)[ex] * horiz
        tri_u = np.zeros(horiz.shape)
        tri_l = np.zeros(horiz.shape)

        # vertical couplings (H01 diagonal = dx*dy/dz_p at interior
        # interfaces; rhofac as :3636-3648)
        H01d = np.zeros((nens, nz + 1))
        H01d[:, 1:nz] = geom.dx * geom.dy / dzp
        inv_rho_pi = 1.0 / rho_pi
        rhofac = np.zeros((nens, nz + 1))
        rhofac[:, 1:nz] = rho_di[:, 1:nz] * 0.5 * (inv_rho_pi[:, 1:] +
                                                   inv_rho_pi[:, :-1])
        diag_add = np.zeros((nens, nz))
        up = np.zeros((nens, nz))
        lo = np.zeros((nens, nz))
        for d in range(varset.ndensity_active):
            alpha_k = -(al * al) * fHn1bar * linp[d]       # (nens, nz)
            beta_kp1 = q_di[d][:, 1:] * rhofac[:, 1:] * H01d[:, 1:]
            beta_k = q_di[d][:, :-1] * rhofac[:, :-1] * H01d[:, :-1]
            up += alpha_k * beta_kp1
            lo += alpha_k * beta_k
            both = beta_kp1 + beta_k
            both[:, 0] = beta_kp1[:, 0]
            both[:, -1] = beta_k[:, -1]
            diag_add += -alpha_k * both
        tri_u += up[ex]
        tri_l += lo[ex]
        tri_d += diag_add[ex]
        return dict(ndims=ndims, linp=linp, tri_l=tri_l, tri_d=tri_d,
                    tri_u=tri_u, q_pi=q_pi, q_di=q_di, rho_pi=rho_pi,
                    rho_di=rho_di)

    @staticmethod
    def _tensors(geom, coefs):
        """The build's arrays as tensors in the geometry's dtype and on its
        device (ints pass through)."""
        T = lambda a: torch.as_tensor(np.asarray(a), dtype=geom.dtype,
                                      device=geom.device)
        out = {k: (v if isinstance(v, int) else T(v))
               for k, v in coefs.items()}
        out.update(dtype=geom.dtype, dz_d=T(geom.dz_d), dz_p=T(geom.dz_p))
        return out

    @staticmethod
    def build(geom, thermo, varset, refstate, dt):
        """The coefficients for step dt, numpy float64, cast to the
        geometry's dtype."""
        coefs = CompressiblePressureLinearSystem._coefficients(
            geom, thermo, varset, refstate, dt)
        return CompressiblePressureLinearSystem(
            geom=geom, varset=varset, dt=dt,
            **CompressiblePressureLinearSystem._tensors(geom, coefs))

    # ------------------------------------------------------------------
    def _x(self, a):
        """(…, nens, nz[+1]) column -> broadcastable against the fields'
        horizontal dims."""
        return a[(Ellipsis,) + (None,) * self.ndims]

    @property
    def _za(self):
        """The z axis in the field layout."""
        return -2 - (self.ndims - 1)

    def _check(self, rhs_w):
        if rhs_w.dtype != self.dtype:
            raise TypeError(f"the linear system was built for {self.dtype}, "
                            f"the rhs is {rhs_w.dtype}")

    def _mass_fluxes(self, v, w):
        """F(d) = H10(v) rho_pi; FW = H01(w) rho_di in the interior, 0 at
        the boundaries (prepare_pressure_rhs / update_densities)."""
        g = self.geom
        dzd = self._x(self.dz_d)
        rho_pi_x = self._x(self.rho_pi)
        if self.ndims == 2:
            F = (v[0] * (dzd * g.dy / g.dx) * rho_pi_x,
                 v[1] * (dzd * g.dx / g.dy) * rho_pi_x)
        else:
            F = (v * (dzd * g.dy / g.dx) * rho_pi_x,)
        FW_in = w * (g.dx * g.dy / self._x(self.dz_p)) * \
            self._x(self.rho_di[:, 1:g.nz])
        zr = torch.zeros_like(FW_in[_zslice(FW_in.ndim, self._za,
                                            slice(0, 1))])
        return F, torch.cat([zr, FW_in, zr], dim=self._za)

    def _weighted_div(self, F, FW, nd):
        """Dnm1bar q.F + vert q.FW for densities 0..nd-1."""
        q_pi = self._x(self.q_pi[:nd])
        q_di = self._x(self.q_di[:nd])
        fx = q_pi * F[0][None]
        div = comm.proll(fx, 1, -1) - fx
        if self.ndims == 2:
            fy = q_pi * F[1][None]
            div = div + (comm.proll(fy, 1, -2) - fy)
        fz = q_di * FW[None]
        return div + (fz[_zslice(fz.ndim, self._za, slice(1, None))] -
                      fz[_zslice(fz.ndim, self._za, slice(None, -1))])

    def _to_spectral(self, p):
        # x: the psum-DFT under x sharding (pam_tpu/spam/si.py:980); y
        # stays rank-local, as in pam_tpu, so y sharding is refused
        if self.ndims == 2 and comm.sharded("y"):
            raise NotImplementedError(
                "the SI pressure solve transforms y rank-locally (as "
                "pam_tpu/spam/si.py:979 does); it cannot run with y "
                "sharded: shard x and the ensemble only")
        phat = dft.rfft_sh(p)
        return dft.fft(phat, dim=-2) if self.ndims == 2 else phat

    def _from_spectral(self, phat):
        if self.ndims == 2:
            phat = dft.ifft(phat, dim=-2)
        return dft.irfft_sh(phat, self.geom.nx)

    def _velocity_update(self, rhs_v, p, al):
        """v - al grad_h p / rho_pi (:3860-3917)."""
        rho_pi_x = self._x(self.rho_pi)
        dpdx = p - comm.proll(p, -1, -1)
        if self.ndims == 2:
            dpdy = p - comm.proll(p, -1, -2)
            return torch.stack([rhs_v[0] - al * dpdx / rho_pi_x,
                                rhs_v[1] - al * dpdy / rho_pi_x])
        return rhs_v - al * dpdx / rho_pi_x

    def _pressure_rhs(self, rhs_dens, rhs_v, rhs_w):
        """sum_d linp(d) Hn1bar(dens(d) - dt/2 div(q(d) F))."""
        g = self.geom
        nact = self.varset.ndensity_active
        F, FW = self._mass_fluxes(rhs_v, rhs_w)
        mf = rhs_dens[:nact] - 0.5 * self.dt * self._weighted_div(F, FW,
                                                                   nact)
        B = mf / (g.dx * g.dy * self._x(self.dz_d))       # Hn1bar
        return (self._x(self.linp) * B).sum(0)

    def _density_update(self, rhs_dens, sol_v, sol_w):
        """Every prognostic density from the new fluxes (:3919-3969)."""
        F, FW = self._mass_fluxes(sol_v, sol_w)
        return rhs_dens - 0.5 * self.dt * self._weighted_div(
            F, FW, rhs_dens.shape[0])

    def solve(self, rhs_dens, rhs_v, rhs_w):
        """(extrudedmodel.h PressureLinearSystem::solve:3234-3247 with the
        compressible prepare/solve/update stages)."""
        self._check(rhs_w)
        za = self._za
        prhs = self._pressure_rhs(rhs_dens, rhs_v, rhs_w)
        phat = _tridiag_real(self.tri_l, self.tri_d, self.tri_u,
                             self._to_spectral(prhs))
        p = self._from_spectral(phat)
        dpdz = p[_zslice(p.ndim, za, slice(1, None))] - \
            p[_zslice(p.ndim, za, slice(None, -1))]
        sol_w = rhs_w - 0.5 * self.dt * dpdz / \
            self._x(self.rho_di[:, 1:self.geom.nz])
        sol_v = self._velocity_update(rhs_v, p, 0.5 * self.dt)
        return self._density_update(rhs_dens, sol_v, sol_w), sol_v, sol_w


@dataclasses.dataclass(frozen=True, eq=False)
class CompressiblePressureGravityLinearSystem(CompressiblePressureLinearSystem):
    """The pressure Helmholtz solve with the gravity and stratification
    terms in the linear operator (extrudedmodel.h:3970-4580): a column
    tridiagonal A acting on w carries the buoyancy coupling that the
    plain pressure system drops (the stratification-robust choice, and
    the 3-D default). Slab and 3-D layouts."""
    # 1 / (rho_pi^2 omega), (nens, ni)
    omega_c: torch.Tensor = per_member(0, default=None)
    Dmod_u: torch.Tensor = per_member(0, default=None)  # (nens, nl)
    Dmod_d: torch.Tensor = per_member(0, default=None)
    # (nens, nl), x-independent
    A_l: torch.Tensor = per_member(0, default=None)
    A_d: torch.Tensor = per_member(0, default=None)
    A_u: torch.Tensor = per_member(0, default=None)
    Fhorz: torch.Tensor = per_member(0, default=None)  # (nens, ni, [ny,] nxr)
    # pres_pi(k+1) - pres_pi(k), (nens, nl)
    dpres: torch.Tensor = per_member(0, default=None)
    # 1 / (dx dy dz_d), (nens, ni)
    fHn1bar: torch.Tensor = per_member(0, default=None)
    # rho_di q_di H01, (nact, nens, ni+1), complex
    w8: torch.Tensor = per_member(1, default=None)

    @staticmethod
    def build(geom, thermo, varset, refstate, dt):
        """compute_coefficients (extrudedmodel.h:4007-4243), numpy
        float64, cast to the geometry's dtype."""
        base = CompressiblePressureLinearSystem._coefficients(
            geom, thermo, varset, refstate, dt)
        nz, nens = geom.nz, geom.nens
        nl = nz - 1
        al = dt / 2.0
        ndims, linp = base["ndims"], base["linp"]
        rho_pi, rho_di = base["rho_pi"], base["rho_di"]
        q_pi, q_di = base["q_pi"], base["q_di"]
        pres_pi = np.asarray(refstate["pres_pi"])
        dzd, dzp = geom.dz_d, geom.dz_p
        nact = varset.ndensity_active

        # omega(k) = sum_d linp(d,k) q_pi(d,k)  (q_pi(mass)=1)
        omega = linp[varset.active_id_mass].copy()
        for d in range(1, nact):
            omega += linp[d] * q_pi[d, :, :nz]

        # Dmod (:4067-4083)
        dp = pres_pi[:, 1:] - pres_pi[:, :-1]            # (nens, nl)
        inv_rho_mid = 0.5 * (1 / rho_pi[:, 1:] + 1 / rho_pi[:, :-1])
        c = 1.0 / (rho_pi * rho_pi * omega)              # (nens, ni)
        Dmod_u = inv_rho_mid - 0.5 * c[:, 1:] * dp
        Dmod_d = -inv_rho_mid - 0.5 * c[:, :-1] * dp

        # H01 diagonal at dual interfaces (0 outside 1..nz-1)
        H01d = np.zeros((nens, nz + 2))
        H01d[:, 1:nz] = geom.dx * geom.dy / dzp
        fHn1bar = 1.0 / (geom.dx * geom.dy * dzd)        # (nens, ni)

        # A tridiagonal (:4085-4149); entropic-gradient gammas
        A_l = np.zeros((nens, nl))
        A_d = np.ones((nens, nl))
        A_u = np.zeros((nens, nl))
        k = np.arange(nl)
        sv_pi = q_pi[varset.active_id_entr][:, :nz]
        dsv = np.zeros((nens, nz + 1))                   # sv(k)-sv(k-1)
        dsv[:, 1:nz] = sv_pi[:, 1:] - sv_pi[:, :-1]
        for d in range(1, nact):
            beta = fHn1bar * linp[d] * c                 # (nens, ni)
            alpha_k = -(al * al) / 4.0 * dp              # (nens, nl)
            gam_kp1 = rho_di[:, k + 2] * H01d[:, k + 2] * dsv[:, k + 2]
            gam_k = rho_di[:, k + 1] * H01d[:, k + 1] * dsv[:, k + 1]
            gam_km1 = rho_di[:, k] * H01d[:, k] * dsv[:, k]
            A_u += alpha_k * beta[:, k + 1] * gam_kp1
            A_d += alpha_k * (beta[:, k + 1] + beta[:, k]) * gam_k
            A_l += alpha_k * beta[:, k] * gam_km1

        # Fhorz (:4151-4180): the plain system's horizontal-only tri_d
        horiz, ex = _horizontal_symbol(geom, ndims, dzd)
        qlinp = np.einsum('aek,aek->ek', q_pi[:nact, :, :nz], linp)
        Fhorz = 1.0 - (al * al) * (fHn1bar * qlinp)[ex] * horiz

        # tri (:4182-4243): per-wavenumber w-space tridiagonal
        tri_u = np.broadcast_to(A_u[ex], Fhorz[:, :nl].shape).copy()
        tri_d = np.broadcast_to(A_d[ex], Fhorz[:, :nl].shape).copy()
        tri_l = np.broadcast_to(A_l[ex], Fhorz[:, :nl].shape).copy()
        gam_kp1 = (rho_di[:, k + 2] * H01d[:, k + 2])[ex]
        gam_k = (rho_di[:, k + 1] * H01d[:, k + 1])[ex]
        gam_km1 = (rho_di[:, k] * H01d[:, k])[ex]
        for d in range(nact):
            beta_k = (fHn1bar[:, :nl] * linp[d][:, :nl])[ex] / \
                Fhorz[:, :nl] * Dmod_d[ex]
            beta_kp1 = (fHn1bar[:, 1:] * linp[d][:, 1:])[ex] / \
                Fhorz[:, 1:] * Dmod_u[ex]
            qd_kp2 = q_di[d][:, k + 2][ex]
            qd_kp1 = q_di[d][:, k + 1][ex]
            qd_k = q_di[d][:, k][ex]
            tri_u -= (al * al) * beta_kp1 * gam_kp1 * qd_kp2
            tri_d -= (al * al) * (beta_k - beta_kp1) * gam_k * qd_kp1
            tri_l += (al * al) * beta_k * gam_km1 * qd_k

        # the p update's flux weights (solve :4451-4470)
        H01col = np.zeros((nens, nz + 1))
        H01col[:, 1:nz] = geom.dx * geom.dy / dzp
        w8 = rho_di[None, :, :] * q_di[:nact] * H01col[None, :, :]
        base.update(tri_l=tri_l, tri_d=tri_d, tri_u=tri_u)
        tensors = CompressiblePressureLinearSystem._tensors(
            geom, dict(base, omega_c=c, Dmod_u=Dmod_u, Dmod_d=Dmod_d,
                       A_l=A_l, A_d=A_d, A_u=A_u, Fhorz=Fhorz, dpres=dp,
                       fHn1bar=fHn1bar))
        tensors["w8"] = torch.as_tensor(w8, dtype=_COMPLEX[geom.dtype],
                                        device=geom.device)
        return CompressiblePressureGravityLinearSystem(
            geom=geom, varset=varset, dt=dt, **tensors)

    # ------------------------------------------------------------------
    def _A_solve(self, rhs):
        """Tridiagonal solve with the x-independent A tridiagonal broadcast
        over the horizontal dims (prepare_pressure_rhs:4322-4342)."""
        return _tridiag_real(self._x(self.A_l), self._x(self.A_d),
                             self._x(self.A_u), rhs)

    def solve(self, rhs_dens, rhs_v, rhs_w):
        self._check(rhs_w)
        g = self.geom
        nact = self.varset.ndensity_active
        al = 0.5 * self.dt
        za = self._za
        hi = lambda a: a[_zslice(a.ndim, za, slice(1, None))]
        lo = lambda a: a[_zslice(a.ndim, za, slice(None, -1))]

        # ---- gravity rhs_w modification (:4283-4343) ----
        Bpert = (rhs_dens[:nact] -
                 self._x(self.q_pi[:nact, :, :g.nz]) * rhs_dens[:1]) / \
            (g.dx * g.dy * self._x(self.dz_d))
        linp = self._x(self.linp)
        B0 = (linp * Bpert).sum(0) * self._x(self.omega_c)
        Bavg = 0.5 * (hi(B0) + lo(B0))
        rhs_w_mod = self._A_solve(rhs_w - al * Bavg * self._x(self.dpres))

        # ---- plain pressure rhs from (rhs_v, rhs_w_mod) (:4344-4349) ----
        phat = self._to_spectral(self._pressure_rhs(rhs_dens, rhs_v,
                                                    rhs_w_mod))

        # ---- solve for pressure (:4351-4477) ----
        Dmu, Dmd = self._x(self.Dmod_u), self._x(self.Dmod_d)
        pF = phat / self.Fhorz
        qhat = _tridiag_real(self.tri_l, self.tri_d, self.tri_u,
                             Dmu * hi(pF) + Dmd * lo(pF))
        # p update: += al^2 linp(d,k) fHn1bar (f_kp1 - f_k), then /= Fhorz
        zrow = torch.zeros_like(qhat[_zslice(qhat.ndim, za, slice(0, 1))])
        q_up = torch.cat([qhat, zrow], dim=za)           # q(k) for k<ni-1
        q_dn = torch.cat([zrow, qhat], dim=za)           # q(k-1) for k>0
        fHn1bar = self._x(self.fHn1bar)
        acc = 0.0
        for d in range(nact):
            f_kp1 = self._x(self.w8[d][:, 1:]) * q_up
            f_k = self._x(self.w8[d][:, :-1]) * q_dn
            acc = acc + linp[d] * fHn1bar * (f_kp1 - f_k)
        p = self._from_spectral((phat + (al * al) * acc) / self.Fhorz)

        # ---- update velocity (:4479-4576) ----
        sol_w = self._A_solve(-al * (Dmu * hi(p) + Dmd * lo(p))) + rhs_w_mod
        sol_v = self._velocity_update(rhs_v, p, al)

        # ---- update densities (the plain system's path) ----
        return self._density_update(rhs_dens, sol_v, sol_w), sol_v, sol_w

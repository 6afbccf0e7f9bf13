"""Semi-implicit time integration for the SPAM dycore of the x-z slab
(port of pam_tpu/spam/si.py): the coupled reference state, the velocity
linear system and the quasi-Newton integrator.

Parity reference: the reference state of CoupledTestCase
(extrudedmodel.h:5800-6056); CompressibleVelocityLinearSystem
(extrudedmodel.h:2531-3162: FFT in x + per-wavenumber complex vertical
tridiagonal for I + dt^2/4 L; slab only, :2561-2564); the quasi-Newton
integrator SI_Newton.h:13-150 with the discrete gradient of
time_integrator.h:49-90, PAM-coupled defaults si_max_iters=3,
si_nquad=2 (core/params.h:148-158).

Setup (reference state, linear-system coefficients) is numpy float64, as
in ``pam_tpu``; the coefficients are cast once to the run's dtype (and
complex64 / complex128) on the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import dft
from ..ops.tridiag import thomas
from ..parallel.mesh import per_member
from . import operators as op


def saturation_vapor_pressure(temp):
    """Magnus formula (extrudedmodel.h:5209-5212)."""
    tc = temp - 273.15
    return 610.94 * np.exp(17.625 * tc / (243.04 + tc))

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
        (nens, nx): the Thomas recurrence (extrudedmodel.h:3025-3050)."""
        mv = lambda a: a.movedim(1, 0)
        return thomas(mv(self.tri_l), mv(self.tri_d), mv(self.tri_u),
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
    with record_function("pam:si.solve"):
        sol = linsys.solve(*res)
    xn = tuple(a + b for a, b in zip(xn, sol))
    with record_function("pam:si.discrete_gradient"):
        if two_point:
            Fa, FWa, Ba = two_point_discrete_gradient(tend, (dens, v, w),
                                                      xn, geop)
        else:
            Fa, FWa, Ba = _discrete_gradient(tend, (dens, v, w), xn, geop,
                                             pts, wts)
    xm = tuple(0.5 * (a + b) for a, b in zip((dens, v, w), xn))
    with record_function("pam:si.symplectic"):
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
    with record_function("pam:si.compute_rhs"):
        dxd, dxv, dxw = tend.compute_rhs(dens, v, w, geop, dt)
    xn = (dens, v, w)
    res = (-dt * dxd, -dt * dxv, -dt * dxw)
    for _ in range(max_iters - 1):
        xn, res = _newton_update(tend, linsys, dens, v, w, geop, dt, res, xn,
                                 pts, wts, two_point)
    with record_function("pam:si.solve"):
        sol = linsys.solve(*res)
    return tuple(a + b for a, b in zip(xn, sol))


# ---------------------------------------------------------------------------
# Compressible PRESSURE linear systems (the reference default,
# params.linear_system == "pressure", and its gravity-aware variant);
# slab (ndims=1) and 3-D (ndims=2) layouts
# ---------------------------------------------------------------------------


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


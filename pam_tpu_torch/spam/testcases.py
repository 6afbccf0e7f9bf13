"""Idealized x-z test cases of the SPAM extruded model (port of
pam_tpu/spam/testcases.py:1-727; ref dynamics/spam/src/models/
extrudedmodel.h test-case structs: RisingBubble :6194, TwoBubbles :6279,
DensityCurrent :6371, MoistRisingBubble :6442, LargeRisingBubble :6482,
MoistLargeRisingBubble :6543, GravityWave :6593, Supercell :7049), with
the quadrature projection of the analytic fields onto n1-forms
(geometry.h set_n1form_values, 5-point Gauss rules, common.h:118-120).

The profiles and projections are numpy float64, copied from pam_tpu; the
setup functions return tensors in the geometry's dtype on its device.
The 3-D (ndims=2) forms of RisingBubble, MoistRisingBubble and Supercell
(pam_tpu/spam/testcases.py:736-871) project onto 3-D dual cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensor(a, geom):
    return torch.as_tensor(np.asarray(a), dtype=geom.dtype,
                           device=geom.device)


def _gauss_legendre(n):
    """Gauss-Legendre points/weights on [0, 1]."""
    p, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (p + 1.0), 0.5 * w


def isentropic_T(z, theta0, g, cst):
    return theta0 - z * g / cst.Cpd


def isentropic_p(z, theta0, g, cst):
    return cst.pr * (isentropic_T(z, theta0, g, cst) / theta0) ** (1.0 / cst.kappa_d)


def isentropic_rho(z, theta0, g, cst):
    p = isentropic_p(z, theta0, g, cst)
    T = isentropic_T(z, theta0, g, cst)
    return p / (cst.Rd * T)


def const_stability_T(z, N, g, Ts, cst):
    """(extrudedmodel.h:5191-5196)."""
    S = N * N / g
    G = g / (cst.Cpd * Ts * S)
    return Ts * np.exp(S * z) * (1.0 - G * (1.0 - np.exp(-S * z)))


def const_stability_p(z, N, g, ps, Ts, cst):
    """(extrudedmodel.h:5185-5190)."""
    S = N * N / g
    G = g / (cst.Cpd * Ts * S)
    return ps * (1.0 - G * (1.0 - np.exp(-S * z))) ** (1.0 / cst.kappa_d)


def linear_ellipsoid(x, z, x0, z0, xrad, zrad, amp):
    """Cone-shaped perturbation (extrudedmodel.h:5198-5205)."""
    dist = np.sqrt(((x - x0) / xrad) ** 2 + ((z - z0) / zrad) ** 2)
    return amp * np.maximum(1.0 - dist, 0.0)


def saturation_vapor_pressure(temp):
    """Magnus formula (extrudedmodel.h:5209-5212)."""
    tc = temp - 273.15
    return 610.94 * np.exp(17.625 * tc / (243.04 + tc))


@dataclasses.dataclass(frozen=True)
class RisingBubble:
    """Dry rising thermal in an isentropic background
    (ref: extrudedmodel.h:6194-6279; acoustic_balance=False branch).
    Carries a constant-stability (N=1e-4) reference state for the
    anelastic/SI solvers (:6210-6240)."""
    g: float = 9.80616
    Lx: float = 1000.0
    Lz: float = 1500.0
    theta0: float = 300.0
    bzc: float = 350.0
    dss: float = 0.5
    rc: float = 250.0
    N_ref: float = 0.0001

    @property
    def xc(self):
        return 0.5 * self.Lx

    def refnsq_f(self, z, thermo):
        return self.N_ref ** 2 + 0.0 * z

    def refp_f(self, z, thermo):
        return const_stability_p(z, self.N_ref, self.g, thermo.cst.pr,
                                 self.theta0, thermo.cst)

    def refT_f(self, z, thermo):
        return const_stability_T(z, self.N_ref, self.g, self.theta0,
                                 thermo.cst)

    def refrho_f(self, z, thermo):
        p = self.refp_f(z, thermo)
        T = self.refT_f(z, thermo)
        return 1.0 / np.asarray(thermo.compute_alpha(p, T, 1.0, 0, 0, 0))

    def refentropicdensity_f(self, z, thermo):
        rho = self.refrho_f(z, thermo)
        return rho * np.asarray(thermo.compute_entropic_var_from_p_T(
            self.refp_f(z, thermo), self.refT_f(z, thermo), 1.0, 0, 0, 0))

    def rho_f(self, x, z, thermo):
        return isentropic_rho(z, self.theta0, self.g, thermo.cst)

    def entropicvar_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T = isentropic_T(z, self.theta0, self.g, cst)
        r = np.sqrt((x - self.xc) ** 2 + (z - self.bzc) ** 2)
        dtheta = np.where(r < self.rc,
                          self.dss * 0.5 * (1.0 + np.cos(np.pi * r / self.rc)),
                          0.0)
        dT = dtheta * (p / cst.pr) ** cst.kappa_d
        return thermo.compute_entropic_var_from_p_T(p, T + dT, 1.0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class TwoBubbles:
    """Robert (1993) warm+cold bubble pair in an isentropic background
    (ref: extrudedmodel.h:6279-6369)."""
    g: float = 9.80616
    Lx: float = 1000.0
    Lz: float = 1000.0
    theta0: float = 303.15
    A1: float = 0.5
    a1: float = 150.0
    s1: float = 50.0
    x1: float = 500.0
    z1: float = 300.0
    A2: float = -0.15
    a2: float = 0.0
    s2: float = 50.0
    x2: float = 560.0
    z2: float = 640.0
    N_ref: float = 0.0001

    @property
    def xc(self):
        return 0.5 * self.Lx

    def refnsq_f(self, z, thermo):
        return self.N_ref ** 2 + 0.0 * z

    def refp_f(self, z, thermo):
        return const_stability_p(z, self.N_ref, self.g, thermo.cst.pr,
                                 self.theta0, thermo.cst)

    def refT_f(self, z, thermo):
        return const_stability_T(z, self.N_ref, self.g, self.theta0,
                                 thermo.cst)

    def refrho_f(self, z, thermo):
        p, T = self.refp_f(z, thermo), self.refT_f(z, thermo)
        return 1.0 / np.asarray(thermo.compute_alpha(p, T, 1.0, 0, 0, 0))

    def refentropicdensity_f(self, z, thermo):
        rho = self.refrho_f(z, thermo)
        return rho * np.asarray(thermo.compute_entropic_var_from_p_T(
            self.refp_f(z, thermo), self.refT_f(z, thermo), 1.0, 0, 0, 0))

    def rho_f(self, x, z, thermo):
        return isentropic_rho(z, self.theta0, self.g, thermo.cst)

    def entropicvar_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T = isentropic_T(z, self.theta0, self.g, cst)
        r1 = np.sqrt((x - self.x1) ** 2 + (z - self.z1) ** 2)
        dth = np.where(r1 <= self.a1, self.A1,
                       self.A1 * np.exp(-(r1 - self.a1) ** 2 / self.s1 ** 2))
        r2 = np.sqrt((x - self.x2) ** 2 + (z - self.z2) ** 2)
        dth = dth + np.where(
            r2 <= self.a2, self.A2,
            self.A2 * np.exp(-(r2 - self.a2) ** 2 / self.s2 ** 2))
        dT = dth * (p / cst.pr) ** cst.kappa_d
        return thermo.compute_entropic_var_from_p_T(p, T + dT, 1.0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class LargeRisingBubble:
    """20 km-domain dry thermal with a cone perturbation
    (ref: extrudedmodel.h:6482-6540)."""
    g: float = 9.80616
    Lx: float = 20000.0
    Lz: float = 20000.0
    theta0: float = 300.0
    bzc: float = 2000.0
    xrad: float = 2000.0
    zrad: float = 2000.0
    amp_theta: float = 2.0
    amp_vapor: float = 0.8
    N_ref: float = 0.0001

    @property
    def xc(self):
        return 0.5 * self.Lx

    def refnsq_f(self, z, thermo):
        return self.N_ref ** 2 + 0.0 * z

    def refp_f(self, z, thermo):
        return const_stability_p(z, self.N_ref, self.g, thermo.cst.pr,
                                 self.theta0, thermo.cst)

    def refT_f(self, z, thermo):
        return const_stability_T(z, self.N_ref, self.g, self.theta0,
                                 thermo.cst)

    def refrho_f(self, z, thermo):
        p, T = self.refp_f(z, thermo), self.refT_f(z, thermo)
        return 1.0 / np.asarray(thermo.compute_alpha(p, T, 1.0, 0, 0, 0))

    def refentropicdensity_f(self, z, thermo):
        rho = self.refrho_f(z, thermo)
        return rho * np.asarray(thermo.compute_entropic_var_from_p_T(
            self.refp_f(z, thermo), self.refT_f(z, thermo), 1.0, 0, 0, 0))

    def rho_f(self, x, z, thermo):
        return isentropic_rho(z, self.theta0, self.g, thermo.cst)

    def entropicvar_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T0 = isentropic_T(z, self.theta0, self.g, cst)
        dtheta = linear_ellipsoid(x, z, self.xc, self.bzc, self.xrad,
                                  self.zrad, self.amp_theta)
        dT = dtheta * (p / cst.pr) ** cst.kappa_d
        return thermo.compute_entropic_var_from_p_T(p, T0 + dT, 1.0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class MoistRisingBubble(RisingBubble):
    """RisingBubble plus a relative-humidity bubble of water vapor
    (ref: extrudedmodel.h:6442-6480; MCE_rho variant: total rho =
    rhod + rhov)."""
    rh0: float = 0.8

    def rhod_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T = isentropic_T(z, self.theta0, self.g, cst)
        return 1.0 / np.asarray(thermo.compute_alpha(p, T, 1.0, 0, 0, 0))

    def rhov_f(self, x, z, thermo):
        r = np.sqrt((x - self.xc) ** 2 + (z - self.bzc) ** 2)
        rh = np.where(r < self.rc,
                      self.rh0 * 0.5 * (1.0 + np.cos(np.pi * r / self.rc)),
                      0.0)
        Th = isentropic_T(z, self.theta0, self.g, thermo.cst)
        pv = saturation_vapor_pressure(Th) * rh
        return pv / (thermo.cst.Rv * Th)

    def rho_f(self, x, z, thermo):
        return self.rhod_f(x, z, thermo) + self.rhov_f(x, z, thermo)

    def refrhov_f(self, z, thermo):
        return 0.0 * z


@dataclasses.dataclass(frozen=True)
class MoistLargeRisingBubble(LargeRisingBubble):
    """LargeRisingBubble plus a cone-shaped vapor perturbation
    (ref: extrudedmodel.h:6543-6592)."""

    def rhod_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T = isentropic_T(z, self.theta0, self.g, cst)
        return 1.0 / np.asarray(thermo.compute_alpha(p, T, 1.0, 0, 0, 0))

    def rhov_f(self, x, z, thermo):
        pert = linear_ellipsoid(x, z, self.xc, self.bzc, self.xrad,
                                self.zrad, self.amp_vapor)
        Th = isentropic_T(z, self.theta0, self.g, thermo.cst)
        pv = saturation_vapor_pressure(Th) * pert
        return pv / (thermo.cst.Rv * Th)

    def rho_f(self, x, z, thermo):
        return self.rhod_f(x, z, thermo) + self.rhov_f(x, z, thermo)

    def refrhov_f(self, z, thermo):
        return 0.0 * z


@dataclasses.dataclass(frozen=True)
class DensityCurrent:
    """Cold blob in a neutrally stratified atmosphere
    (ref: extrudedmodel.h:6371-6470)."""
    g: float = 9.80616
    Lx: float = 51200.0
    Lz: float = 6400.0
    theta0: float = 300.0
    bzc: float = 3000.0
    bxr: float = 4000.0
    bzr: float = 2000.0
    dss: float = -15.0

    @property
    def xc(self):
        return 0.5 * self.Lx

    def rho_f(self, x, z, thermo):
        return isentropic_rho(z, self.theta0, self.g, thermo.cst)

    def entropicvar_f(self, x, z, thermo):
        cst = thermo.cst
        p = isentropic_p(z, self.theta0, self.g, cst)
        T = isentropic_T(z, self.theta0, self.g, cst)
        r = np.sqrt(((x - self.xc) / self.bxr) ** 2 +
                    ((z - self.bzc) / self.bzr) ** 2)
        dtheta = np.where(r <= 1.0,
                          self.dss * 0.5 * (1.0 + np.cos(np.pi * r)), 0.0)
        dT = dtheta * (p / cst.pr) ** cst.kappa_d
        return thermo.compute_entropic_var_from_p_T(p, T + dT, 1.0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class GravityWave:
    """Skamarock-Klemp inertia-gravity wave in an isothermal atmosphere
    (ref: extrudedmodel.h:6593-6700). Has an analytic reference state for
    the semi-implicit solver."""
    g: float = 9.80616
    Lx: float = 300e3
    Lz: float = 10e3
    T_ref: float = 250.0
    p_s: float = 1e5
    dT_max: float = 0.01
    d: float = 5e3
    x_c: float = 100e3
    u_0: float = 20.0
    add_perturbation: bool = True

    @property
    def xc(self):
        return 0.5 * self.Lx

    def u_init(self, z):
        """Background wind (v_f, extrudedmodel.h:6700-6705): u = u_0, w = 0."""
        return self.u_0 + 0.0 * z

    def _isothermal(self, z, var_s, cst):
        delta = self.g / (cst.Rd * self.T_ref)
        return var_s * np.exp(-delta * z)

    def refrho_f(self, z, thermo):
        cst = thermo.cst
        return self._isothermal(z, self.p_s / (cst.Rd * self.T_ref), cst)

    def refnsq_f(self, z, thermo):
        cst = thermo.cst
        N2 = (cst.gamma_d - 1.0) / cst.gamma_d * self.g ** 2 / \
            (cst.Rd * self.T_ref)
        return N2 + 0.0 * z

    def refentropicdensity_f(self, z, thermo):
        cst = thermo.cst
        rho = self.refrho_f(z, thermo)
        p = cst.Rd * rho * self.T_ref
        return rho * np.asarray(thermo.compute_entropic_var_from_p_T(
            p, self.T_ref, 1.0, 0, 0, 0))

    def _pert(self, x, z, cst):
        delta = self.g / (cst.Rd * self.T_ref)
        rho_s = self.p_s / (cst.Rd * self.T_ref)
        dT_b = self.dT_max * np.exp(-((x - self.x_c) / self.d) ** 2) * \
            np.sin(np.pi * z / self.Lz)
        dT = np.exp(delta * z / 2.0) * dT_b
        drho = np.exp(-delta * z / 2.0) * (-rho_s * dT_b / self.T_ref)
        return dT, drho

    def rho_f(self, x, z, thermo):
        rho = self.refrho_f(z, thermo)
        if self.add_perturbation:
            rho = rho + self._pert(x, z, thermo.cst)[1]
        return rho

    def entropicvar_f(self, x, z, thermo):
        cst = thermo.cst
        rho_ref = self.refrho_f(z, thermo)
        p = self._isothermal(z, self.p_s, cst)
        T = self.T_ref
        if self.add_perturbation:
            dT, drho = self._pert(x, z, cst)
            T = T + dT
            p = p + cst.Rd * self.T_ref * drho + cst.Rd * rho_ref * dT
        return np.asarray(thermo.compute_entropic_var_from_p_T(
            p, T, 1.0, 0, 0, 0))

    # -- exact linear solution (sum_series, extrudedmodel.h:6769-6874):
    # the analytic Fourier-mode evolution of the initial T perturbation in
    # an isothermal, non-rotating channel; the reference's verification
    # target for the gravitywave convergence study (pam-c/gravitywave/
    # convergence.py).
    def sum_series(self, x, z, t, thermo, nmax: int = 100):
        """Returns dict(drho, dp, dT, du, dw) of perturbation fields at
        time t; x, z broadcastable numpy arrays."""
        cst = thermo.cst
        Rd, cvd, cpd = cst.Rd, cst.Cvd, cst.Cpd
        g, Lx, Lz = self.g, self.Lx, self.Lz
        T_ref, p_s = self.T_ref, self.p_s
        xp = np.asarray(x, np.float64) - self.u_0 * t
        z = np.asarray(z, np.float64)
        delta = g / (Rd * T_ref)
        c_s2 = cpd / cvd * Rd * T_ref
        rho_s = p_s / (Rd * T_ref)
        shape = np.broadcast(xp, z).shape
        acc = {k: np.zeros(shape, np.complex128)
               for k in ("drho", "dp", "du", "dw")}
        for m_ in (-1, 1):
            k_z = np.pi * m_ / Lz
            k_z2 = k_z * k_z
            # all horizontal wavenumbers at once (vectorized over n)
            n = np.arange(-nmax, nmax + 1, dtype=np.float64)
            k_x = 2.0 * np.pi * n / Lx
            k_x2 = k_x * k_x
            p_1 = c_s2 * (k_x2 + k_z2 + delta * delta / 4.0)
            q_1 = g * k_x2 * (c_s2 * delta - g)
            disc = np.sqrt(np.maximum(p_1 * p_1 / 4.0 - q_1, 0.0))
            alpha = np.sqrt(np.maximum(p_1 / 2.0 - disc, 0.0))
            beta = np.sqrt(p_1 / 2.0 + disc)
            a2, b2 = alpha * alpha, beta * beta
            with np.errstate(divide="ignore", invalid="ignore"):
                fac1 = 1.0 / (b2 - a2)
                L_0 = (np.sin(alpha * t) / alpha -
                       np.sin(beta * t) / beta) * fac1
                L_1 = (np.cos(alpha * t) - np.cos(beta * t)) * fac1
                L_2 = (-alpha * np.sin(alpha * t) +
                       beta * np.sin(beta * t)) * fac1
                L_3 = (-a2 * np.cos(alpha * t) +
                       b2 * np.cos(beta * t)) * fac1
            # alpha -> 0 limit (n = 0 column; extrudedmodel.h:6826-6829)
            zero = alpha == 0.0
            L_0 = np.where(zero, (beta * t - np.sin(beta * t)) / (b2 * beta),
                           L_0)
            L_1 = np.where(zero, (1.0 - np.cos(beta * t)) / b2, L_1)
            L_2 = np.where(zero, np.sin(beta * t) / beta, L_2)
            L_3 = np.where(zero, np.cos(beta * t) - 0.0 * b2, L_3)
            drhot_b0 = (-rho_s / T_ref * self.dT_max / np.sqrt(np.pi) *
                        self.d / Lx * np.exp(-self.d ** 2 * k_x2 / 4.0) *
                        np.exp(-1j * k_x * self.x_c) * k_z * Lz / 2j)
            drhot = (L_3 + (p_1 + g * (1j * k_z - delta / 2.0)) * L_1) * \
                drhot_b0
            gfac = (g - c_s2 * (1j * k_z + delta / 2.0)) * g * drhot_b0
            dpt = -gfac * L_1
            dut = 1j * k_x * gfac * L_0 / (g * rho_s) * g
            dwt = -(L_2 + c_s2 * k_x2 * L_0) * g * drhot_b0 / rho_s
            # mode sum: coef[n] * exp(i k_x xp) summed over n, then the
            # single vertical mode factor exp(i k_z z)
            ez = np.exp(1j * k_z * z)
            # chunk the n axis to bound the (points x modes) temporary
            for c0 in range(0, len(n), 32):
                sl = slice(c0, c0 + 32)
                ex = np.exp(1j * np.multiply.outer(xp, k_x[sl]))
                acc["drho"] += ez * (ex @ drhot[sl]) if xp.ndim else \
                    ez * np.sum(ex * drhot[sl])
                acc["dp"] += ez * (ex @ dpt[sl]) if xp.ndim else \
                    ez * np.sum(ex * dpt[sl])
                acc["du"] += ez * (ex @ dut[sl]) if xp.ndim else \
                    ez * np.sum(ex * dut[sl])
                acc["dw"] += ez * (ex @ dwt[sl]) if xp.ndim else \
                    ez * np.sum(ex * dwt[sl])
        dT_b = T_ref * (acc["dp"] / p_s - acc["drho"] / rho_s)
        em, ep = np.exp(-delta * z / 2.0), np.exp(delta * z / 2.0)
        return dict(drho=em * acc["drho"].real, dp=em * acc["dp"].real,
                    dT=ep * dT_b.real, du=ep * acc["du"].real,
                    dw=ep * acc["dw"].real)

    def rhoexact_f(self, x, z, t, thermo):
        """(rhoexact_f, extrudedmodel.h:6707-6714)."""
        rho = self.refrho_f(z, thermo) + 0.0 * x
        if self.add_perturbation:
            rho = rho + self.sum_series(x, z, t, thermo)["drho"]
        return rho

    def entropicdensityexact_f(self, x, z, t, thermo):
        """(entropicdensityexact_f, extrudedmodel.h:6716-6735)."""
        cst = thermo.cst
        rho = self.refrho_f(z, thermo) + 0.0 * x
        p = self._isothermal(z, self.p_s, cst) + 0.0 * x
        T = self.T_ref + 0.0 * x
        if self.add_perturbation:
            sol = self.sum_series(x, z, t, thermo)
            rho, p, T = rho + sol["drho"], p + sol["dp"], T + sol["dT"]
        return rho * np.asarray(
            thermo.compute_entropic_var_from_p_T(p, T, 1.0, 0, 0, 0))

    def Texact_f(self, x, z, t, thermo):
        """(Texact_f, extrudedmodel.h:6737-6744)."""
        T = self.T_ref + 0.0 * (x + z)
        if self.add_perturbation:
            T = T + self.sum_series(x, z, t, thermo)["dT"]
        return T

    def uexact_f(self, x, z, t, thermo):
        """u component of vexact_f (extrudedmodel.h:6746-6757)."""
        u = self.u_0 + 0.0 * (x + z)
        if self.add_perturbation:
            u = u + self.sum_series(x, z, t, thermo)["du"]
        return u

    def wexact_f(self, x, z, t, thermo):
        """w component of vexact_f (extrudedmodel.h:6746-6757)."""
        w = 0.0 * (x + z)
        if self.add_perturbation:
            w = w + self.sum_series(x, z, t, thermo)["dw"]
        return w


def saturation_mixing_ratio(T, p):
    """(extrudedmodel.h:5214-5216)."""
    return 380.0 / p * np.exp(17.27 * (T - 273.0) / (T - 36.0))


@dataclasses.dataclass(frozen=True)
class Supercell:
    """Weisman-Klemp-like supercell sounding with a warm bubble trigger and
    low-level shear (ref: struct Supercell, extrudedmodel.h:7049-7287;
    moist MCE_rho + ConstantKappa_VirtualPottemp, SI time stepping).
    Requires special init: column profiles solved by fixed-point iteration
    (initialize_refstate, :7148-7224), ICs broadcast from the reference
    columns plus a θ' bubble (initialize, :7254-7276)."""
    g: float = 9.81
    Lx: float = 168e3
    Ly: float = 168e3
    Lz: float = 20e3
    xbc_frac: float = 0.5       # bubble center at 0.5*Lx
    zbc: float = 1.5e3
    rx: float = 10e3
    rz: float = 1.5e3
    dtht: float = 3.0
    tht_0: float = 300.0
    z_tr: float = 12e3
    tht_tr: float = 343.0
    T_tr: float = 213.0
    z_s: float = 5e3
    U_s: float = 30.0
    U_c: float = 15.0
    dz_u: float = 1e3
    N_ref: float = 0.011
    nonlinear_iters: int = 10
    max_qv: float = 0.014

    needs_special_init = True

    @property
    def xc(self):
        return 0.5 * self.Lx

    def thermo_constants(self):
        """The constants the reference hard-sets for this case
        (initialize_refstate, extrudedmodel.h:7172-7183)."""
        from .thermo import ThermoConstants
        return ThermoConstants(Rd=287.0, Rv=461.0, pr=1e5, Cpd=1003.0,
                               Cvd=1003.0 - 287.0, Cpv=1859.0)

    def refnsq_f(self, z):
        return np.full_like(np.asarray(z, np.float64), self.N_ref ** 2)

    def tht_f(self, z, cst):
        return np.where(
            z <= self.z_tr,
            self.tht_0 + (self.tht_tr - self.tht_0) *
            np.power(np.maximum(z, 0.0) / self.z_tr, 1.25),
            self.tht_tr * np.exp(self.g / (cst.Cpd * self.T_tr) *
                                 (z - self.z_tr)))

    def hum_f(self, z):
        return np.where(z <= self.z_tr,
                        1.0 - 0.75 * np.power(z / self.z_tr, 1.25), 0.25)

    def tht_perturb_f(self, x, z):
        dx = (x - self.xbc_frac * self.Lx) / self.rx
        dz = (z - self.zbc) / self.rz
        r = np.sqrt(dx * dx + dz * dz)
        return np.where(r < 1, self.dtht * np.cos(np.pi * r / 2) ** 2, 0.0)

    def u_f(self, z):
        zs, dzu, Us, Uc = self.z_s, self.dz_u, self.U_s, self.U_c
        mid = (-4.0 / 5 + 3 * z / zs - 5.0 / 4 * (z / zs) ** 2) * Us - Uc
        return np.where(z < zs - dzu, Us * z / zs - Uc,
                        np.where(np.abs(z - zs) <= dzu, mid, Us - Uc))

    def build_columns(self, geom, thermo):
        """Fixed-point solve of the hydrostatic moist column
        (initialize_refstate, extrudedmodel.h:7189-7203). Returns
        (rho, thtv, qv) at primal levels, shapes (nens, nz)."""
        cst = thermo.cst
        z = np.asarray(geom.zint_p)                  # (nens, nz)
        veps = cst.Rv / cst.Rd - 1.0
        tht = self.tht_f(z, cst)
        thtv = tht.copy()
        dzp = np.asarray(geom.dz_p)                  # (nens, nz-1)
        qv = np.zeros_like(z)
        for _ in range(self.nonlinear_iters):
            # hydrostatic exner from the surface up (cumulative)
            dex = -self.g / (cst.Cpd * 0.5 * (thtv[:, :-1] + thtv[:, 1:])) \
                * dzp
            exner = np.concatenate(
                [np.ones_like(z[:, :1]), 1.0 + np.cumsum(dex, axis=1)],
                axis=1)
            p = cst.pr * np.power(exner, 1.0 / cst.kappa_d)
            T = tht * exner
            qvs = saturation_mixing_ratio(T, p)
            qv = np.minimum(qvs * self.hum_f(z), self.max_qv)
            thtv = tht * (1.0 + veps * qv)
        rho = p / (cst.Rd * exner * thtv)
        return rho, thtv, qv


def setup_supercell(tc, geom, thermo, varset):
    """Build (dens, v, w, geop, refstate) for the Supercell case
    (initialize_refstate + initialize, extrudedmodel.h:7148-7287)."""
    from . import si as si_mod

    rho, thtv, qv = tc.build_columns(geom, thermo)   # primal levels (nens,nz)
    vol = geom.dx * np.asarray(geom.dz_d)
    refdens = np.zeros((varset.ndensity, geom.nens, geom.nz))
    refdens[varset.dens_id_mass] = rho * vol
    refdens[varset.dens_id_entr] = rho * thtv * vol
    refdens[varset.dens_id_vap] = rho * qv * vol
    refstate = si_mod.build_moist_reference_state(
        geom, thermo, varset, refdens, tc.refnsq_f, tc.g)

    # ICs: broadcast ref columns + θ' bubble on the entropic density
    # (initialize, :7254-7276; perturbation at cell centers)
    nx = geom.nx
    dens = np.repeat(refdens[:, :, :, None], nx, axis=3)
    xmid = (np.arange(nx) + 0.5) * geom.dx           # (nx,)
    zmid = np.asarray(geom.zmid_d)                   # (nens, nz)
    pert = tc.tht_perturb_f(xmid[None, None, :], zmid[:, :, None])
    dens[varset.dens_id_entr] += pert * refdens[varset.dens_id_mass][:, :, None]

    # winds: u(z) shear as a straight 1-form (set_10form_values -> u*dx)
    u = tc.u_f(np.asarray(geom.zint_p))              # (nens, nz)
    v = np.repeat((u * geom.dx)[:, :, None], nx, axis=2)
    geop = project_n1form(lambda x, z: tc.g * z, geom)
    return (_tensor(dens, geom), _tensor(v, geom),
            _tensor(np.zeros((geom.nens, geom.nz - 1, geom.nx)), geom),
            _tensor(geop, geom), refstate)


def project_n1form(f, geom, nq: int = 5):
    """Cell-average (n1-form) projection of f(x, z) over dual cells by
    tensor-product Gauss quadrature (analog of set_n1form_values).
    Returns (nens, nz, nx) n-form values (integral = avg * dx * dz)."""
    qp, qw = _gauss_legendre(nq)
    nx, nz, nens = geom.nx, geom.nz, geom.nens
    dx = geom.dx
    x0 = (np.arange(nx))[None, None, :, None, None] * dx
    zint = geom.zint_d  # (nens, nz+1)
    zlo = zint[:, :-1][:, :, None, None, None]
    dz = geom.dz_d[:, :, None, None, None]
    xq = x0 + qp[None, None, None, :, None] * dx
    zq = zlo + qp[None, None, None, None, :] * dz
    vals = f(np.broadcast_to(xq, (nens, nz, nx, nq, nq)),
             np.broadcast_to(zq, (nens, nz, nx, nq, nq)))
    avg = np.einsum('ekxab,a,b->ekx', vals, qw, qw)
    return avg * dx * geom.dz_d[:, :, None]


def setup_testcase(tc, geom, thermo):
    """Build initial (dens, v, w, geop) for a dry CE test case."""
    dens_rho = project_n1form(lambda x, z: tc.rho_f(x, z, thermo), geom)
    dens_S = project_n1form(
        lambda x, z: tc.rho_f(x, z, thermo) * tc.entropicvar_f(x, z, thermo),
        geom)
    geop = project_n1form(lambda x, z: tc.g * z, geom)
    dens = _tensor(np.stack([dens_rho, dens_S]), geom)
    if hasattr(tc, "u_init"):
        # background wind as a straight 1-form (v_f -> set_10form -> u*dx)
        u = np.broadcast_to(tc.u_init(np.asarray(geom.zint_p)),
                            (geom.nens, geom.nz))
        v = np.repeat((u * geom.dx)[:, :, None], geom.nx, axis=2)
    else:
        v = np.zeros((geom.nens, geom.nz, geom.nx))
    w = np.zeros((geom.nens, geom.nz - 1, geom.nx))
    return dens, _tensor(v, geom), _tensor(w, geom), _tensor(geop, geom)


def setup_moist_testcase(tc, geom, thermo):
    """Build initial (dens, v, w, geop) for a moist (MCE_rho) test case:
    dens = [rho_total, S, rho_v] (ref: MoistEulerTestCase
    set_initial_conditions, extrudedmodel.h:5577-5625 — S uses the full
    rho including vapor; vapor density from rhov_f)."""
    dens_rho = project_n1form(lambda x, z: tc.rho_f(x, z, thermo), geom)
    dens_S = project_n1form(
        lambda x, z: tc.rho_f(x, z, thermo) * tc.entropicvar_f(x, z, thermo),
        geom)
    dens_v = project_n1form(lambda x, z: tc.rhov_f(x, z, thermo), geom)
    geop = project_n1form(lambda x, z: tc.g * z, geom)
    dens = _tensor(np.stack([dens_rho, dens_S, dens_v]), geom)
    v = np.zeros((geom.nens, geom.nz, geom.nx))
    w = np.zeros((geom.nens, geom.nz - 1, geom.nx))
    return dens, _tensor(v, geom), _tensor(w, geom), _tensor(geop, geom)


# Analog of testcase_from_string (extrudedmodel.h:7288-7316). Values are
# (testcase class, moist?).
TESTCASE_REGISTRY = {
    "risingbubble": (RisingBubble, False),
    "twobubbles": (TwoBubbles, False),
    "densitycurrent": (DensityCurrent, False),
    "largerisingbubble": (LargeRisingBubble, False),
    "gravitywave": (GravityWave, False),
    "moistrisingbubble": (MoistRisingBubble, True),
    "moistlargerisingbubble": (MoistLargeRisingBubble, True),
    "supercell": (Supercell, True),
}


def testcase_from_string(name: str):
    """Returns (testcase instance, moist flag)."""
    cls, moist = TESTCASE_REGISTRY[name.lower()]
    return cls(), moist


# ---------------------------------------------------------------------------
# 3-D (ndims=2) initial conditions: the reference's max_ndims=2 cases are
# RisingBubble (extrudedmodel.h:6195), its moist variant (:6442, inherited)
# and Supercell (:7050); their 3-D forms replace the 2-D bubble radius by
# the spherical / ellipsoidal one including (y - yc)
# ---------------------------------------------------------------------------

def project_n1form_3d(f3, geom, nq: int = 5):
    """Cell-average projection of f3(x, y, z) over 3-D dual cells by
    tensor-product Gauss quadrature: (nens, nz, ny, nx) n-forms (integral
    = avg * dx * dy * dz), numpy float64."""
    qp, qw = _gauss_legendre(nq)
    nx, ny, nz, nens = geom.nx, geom.ny, geom.nz, geom.nens
    dx, dy = geom.dx, geom.dy
    xq = np.arange(nx)[:, None] * dx + qp[None, :] * dx         # (nx, nq)
    yq = np.arange(ny)[:, None] * dy + qp[None, :] * dy         # (ny, nq)
    dzd = geom.dz_d
    zq = geom.zint_d[:, :-1, None] + qp[None, None, :] * dzd[:, :, None]
    vals = f3(xq[None, None, None, :, None, None, :],            # x
              yq[None, None, :, None, None, :, None],            # y
              zq[:, :, None, None, :, None, None])               # z
    vals = np.broadcast_to(vals, (nens, nz, ny, nx, nq, nq, nq))
    avg = np.einsum('ekyxcba,a,b,c->ekyx', vals, qw, qw, qw)
    return avg * dx * dy * dzd[:, :, None, None]


def _r3(tc, x, y, z):
    yc = 0.5 * getattr(tc, "Ly", tc.Lx)
    return np.sqrt((x - tc.xc) ** 2 + (y - yc) ** 2 + (z - tc.bzc) ** 2)


def _bubble_entropicvar_3d(tc, x, y, z, thermo):
    """RisingBubble::entropicvar_f, ndims=2 branch (extrudedmodel.h
    :6252-6262)."""
    cst = thermo.cst
    p = isentropic_p(z, tc.theta0, tc.g, cst)
    T = isentropic_T(z, tc.theta0, tc.g, cst)
    r = _r3(tc, x, y, z)
    dtheta = np.where(r < tc.rc,
                      tc.dss * 0.5 * (1.0 + np.cos(np.pi * r / tc.rc)), 0.0)
    dT = dtheta * (p / cst.pr) ** cst.kappa_d
    return thermo.compute_entropic_var_from_p_T(p, T + dT, 1.0, 0, 0, 0)


def _bubble_rhov_3d(tc, x, y, z, thermo):
    """MoistRisingBubble::rhov_f with the spherical radius (:6450-6465)."""
    r = _r3(tc, x, y, z)
    rh = np.where(r < tc.rc,
                  tc.rh0 * 0.5 * (1.0 + np.cos(np.pi * r / tc.rc)), 0.0)
    Th = isentropic_T(z, tc.theta0, tc.g, thermo.cst)
    pv = saturation_vapor_pressure(Th) * rh
    return pv / (thermo.cst.Rv * Th)


def moist_entropicvar(tc, x, y, z, thermo):
    """MoistRisingBubble's entropic variable from the moist state
    (MoistEulerTestCase::initialize, extrudedmodel.h:5538-5620)."""
    cst = thermo.cst
    p = isentropic_p(z, tc.theta0, tc.g, cst)
    T = isentropic_T(z, tc.theta0, tc.g, cst)
    rho_v = _bubble_rhov_3d(tc, x, y, z, thermo)
    qv = rho_v / (tc.rhod_f(x, z, thermo) + rho_v)
    return thermo.compute_entropic_var_from_p_T(p, T, 1.0 - qv, qv, 0, 0)


def setup_testcase_3d(tc, geom, thermo):
    """3-D initial (dens, v, w, geop) of RisingBubble / MoistRisingBubble
    (EulerTestCase / MoistEulerTestCase::initialize with ndims=2
    projections, extrudedmodel.h:5325-5620)."""
    if isinstance(tc, MoistRisingBubble):
        def rho3(x, y, z):
            return (tc.rhod_f(x, z, thermo) +
                    _bubble_rhov_3d(tc, x, y, z, thermo))
        parts = [project_n1form_3d(rho3, geom),
                 project_n1form_3d(
                     lambda x, y, z: rho3(x, y, z) *
                     moist_entropicvar(tc, x, y, z, thermo), geom),
                 project_n1form_3d(
                     lambda x, y, z: _bubble_rhov_3d(tc, x, y, z, thermo),
                     geom)]
    else:
        parts = [project_n1form_3d(lambda x, y, z: tc.rho_f(x, z, thermo),
                                   geom),
                 project_n1form_3d(
                     lambda x, y, z: tc.rho_f(x, z, thermo) *
                     _bubble_entropicvar_3d(tc, x, y, z, thermo), geom)]
    geop = project_n1form_3d(lambda x, y, z: tc.g * z + 0.0 * x + 0.0 * y,
                             geom)
    shape = (geom.nens, geom.nz, geom.ny, geom.nx)
    v = np.zeros((2,) + shape)
    w = np.zeros((geom.nens, geom.nz - 1, geom.ny, geom.nx))
    return (_tensor(np.stack(parts), geom), _tensor(v, geom),
            _tensor(w, geom), _tensor(geop, geom))


def setup_supercell_3d(tc, geom, thermo, varset):
    """3-D Supercell: the reference columns, the ellipsoidal theta' bubble
    with (rx, ry, rz) and the u(z) shear (Supercell::tht_perturb_f ndims=2
    + initialize, extrudedmodel.h:7102-7287). Returns (dens, v, w, geop,
    the SI reference state)."""
    from . import si as si_mod

    rho, thtv, qv = tc.build_columns(geom, thermo)   # (nens, nz)
    vol = geom.dx * geom.dy * geom.dz_d
    refdens = np.zeros((varset.ndensity, geom.nens, geom.nz))
    refdens[varset.dens_id_mass] = rho * vol
    refdens[varset.dens_id_entr] = rho * thtv * vol
    refdens[varset.dens_id_vap] = rho * qv * vol
    refstate = si_mod.build_moist_reference_state(
        geom, thermo, varset, refdens, tc.refnsq_f, tc.g)

    nx, ny = geom.nx, geom.ny
    dens = np.broadcast_to(refdens[:, :, :, None, None],
                           refdens.shape + (ny, nx)).copy()
    xmid = (np.arange(nx) + 0.5) * geom.dx
    ymid = (np.arange(ny) + 0.5) * geom.dy
    ry_ = getattr(tc, "ry", tc.rx)
    dxn = (xmid[None, None, None, :] - tc.xbc_frac * tc.Lx) / tc.rx
    dyn = (ymid[None, None, :, None] - 0.5 * geom.ylen) / ry_
    dzn = (geom.zmid_d[:, :, None, None] - tc.zbc) / tc.rz
    r = np.sqrt(dxn * dxn + dyn * dyn + dzn * dzn)
    pert = np.where(r < 1, tc.dtht * np.cos(np.pi * r / 2) ** 2, 0.0)
    dens[varset.dens_id_entr] += pert * \
        refdens[varset.dens_id_mass][:, :, None, None]

    u = tc.u_f(geom.zint_p)                          # (nens, nz)
    v0 = np.broadcast_to((u * geom.dx)[:, :, None, None],
                         (geom.nens, geom.nz, ny, nx))
    v = np.stack([v0, np.zeros_like(v0)])
    geop = project_n1form_3d(lambda x, y, z: tc.g * z + 0.0 * x + 0.0 * y,
                             geom)
    return (_tensor(dens, geom), _tensor(v, geom),
            _tensor(np.zeros((geom.nens, geom.nz - 1, ny, nx)), geom),
            _tensor(geop, geom), refstate)

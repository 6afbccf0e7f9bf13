"""Anelastic (AN) and moist anelastic (MAN) variants of the SPAM x-z
model (port of pam_tpu/spam/anelastic.py).

Parity reference:
* Hamiltonian_AN_Hs, hamiltonians/anelastic.h:7-115: B from the enthalpy
  at the REFERENCE pressure profile; the mass density is fixed to the
  reference profile (VS_AN: ndensity_dycore_prognostic=1,
  variableset.h:55-68).
* AnelasticLinearSystem, models/extrudedmodel.h:3245-3520: the pressure
  Poisson solve div(rho_ref grad p) = -div(rho_ref u) by a DFT in x and a
  real vertical tridiagonal per wavenumber, the zero mode pinned at
  kfix = nz/2; velocity correction v += D0 p, w += D0_vert p.
* project_to_anelastic and add_pressure_perturbation,
  extrudedmodel.h:2489-2503: the projection runs after every symplectic
  evaluation (compute_rhs and the SI integrators' evaluations, through
  ``post_symplectic``) and once on the initial condition.

No acoustics remain, so explicit steps are limited by the advective CFL
alone; the reference's PAMC_MAN default tstype is ssprk3
(core/params.h:148-149). The solver's coefficients are built in numpy
float64, as in ``pam_tpu``, and cast once to the geometry's dtype and
device; the Poisson solve runs in complex64 under float32 and complex128
under float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import dft
from . import operators as op
from .si import _tridiag_real
from .tendencies import SpamTendencies


@dataclasses.dataclass(frozen=True, eq=False)
class AnelasticPressureSolver:
    """The inverse of div(rho_ref grad) (AnelasticLinearSystem,
    extrudedmodel.h:3245-3520). Every tensor in the geometry's dtype and
    on its device."""
    geom: Any
    rho_pi: torch.Tensor   # (nens, nz)
    rho_di: torch.Tensor   # (nens, nz+1)
    tri_l: torch.Tensor    # (nens, nz, nx) real
    tri_d: torch.Tensor
    tri_u: torch.Tensor
    kfix: int

    @staticmethod
    def build(geom, rho_pi, rho_di):
        nz, nx, nens = geom.nz, geom.nx, geom.nens
        rho_pi, rho_di = np.asarray(rho_pi), np.asarray(rho_di)
        dzd = np.asarray(geom.dz_d)
        dzp = np.asarray(geom.dz_p)
        # fourier symbols (ext_deriv.h:964-979); fH1 = dz_d/dx
        th = 2.0 * np.pi * np.arange(nx) / nx
        fD0Dnm1bar = 2.0 * (np.cos(th) - 1.0)
        fH1 = dzd / geom.dx                       # (nens, nz)
        H01d = np.zeros((nens, nz + 1))
        H01d[:, 1:nz] = geom.dx / dzp
        h = rho_di * H01d                         # (nens, nz+1)

        tri_d = (fH1 * rho_pi)[:, :, None] * fD0Dnm1bar[None, None, :]
        tri_u = np.broadcast_to(h[:, 1:, None], tri_d.shape).copy()
        tri_l = np.broadcast_to(h[:, :-1, None], tri_d.shape).copy()
        k = np.arange(nz)
        vert_diag = np.where(k == 0, -h[:, 1:],
                             np.where(k == nz - 1, -h[:, :-1],
                                      -(h[:, 1:] + h[:, :-1])))
        tri_d = tri_d + vert_diag[:, :, None]
        kfix = nz // 2
        # pin the (m=0, kfix) pressure (:3335-3341)
        tri_d[:, kfix, 0] = 1.0
        tri_u[:, kfix, 0] = 0.0
        tri_l[:, kfix, 0] = 0.0
        T = lambda a: torch.as_tensor(a, dtype=geom.dtype, device=geom.device)
        return AnelasticPressureSolver(geom=geom, rho_pi=T(rho_pi),
                                       rho_di=T(rho_di), tri_l=T(tri_l),
                                       tri_d=T(tri_d), tri_u=T(tri_u),
                                       kfix=kfix)

    def _tridiag(self, rhs):
        """Tridiagonal solve over z batched over (nens, nx) (:3436-3464)
        with a complex right-hand side: the Thomas recurrence with real
        elimination factors, or PCR on the coefficients cast to the
        right-hand side's dtype (si._tridiag_real)."""
        return _tridiag_real(self.tri_l, self.tri_d, self.tri_u, rhs)

    def divergence(self, v, w):
        """div(rho_ref u) per dual cell, the quantity the anelastic
        constraint sets to 0 (:3343-3420)."""
        g = self.geom
        F = op.H10(v, g) * self.rho_pi[:, :, None]
        FW_in = w * (g.dx / g.dz_p_t[:, :, None]) * \
            self.rho_di[:, 1:g.nz, None]
        zr = torch.zeros_like(FW_in[:, :1, :])
        FW = torch.cat([zr, FW_in, zr], dim=1)
        return (op.rollm(F, 1) - F) + (FW[:, 1:] - FW[:, :-1])

    def project(self, v, w):
        """(dv, dw) such that (v + dv, w + dw) satisfies the anelastic
        constraint div(rho_ref u) = 0 (solve + update_velocity,
        :3343-3520)."""
        if v.dtype != self.geom.dtype:
            raise TypeError(f"the anelastic solver is built in "
                            f"{self.geom.dtype}; got a velocity in {v.dtype}")
        # the psum-DFT under x sharding, the tridiagonal on the whole
        # spectrum, the comm-free inverse (pam_tpu/spam/anelastic.py:129-132)
        rhs = dft.fft_sh(-self.divergence(v, w))
        rhs[:, self.kfix, 0] = 0.0       # a new tensor: no one else holds it
        p = dft.ifft_real_sh(self._tridiag(rhs))
        dv = p - op.rollm(p, -1)                  # D0 in x (:3495-3503)
        dw = p[:, 1:, :] - p[:, :-1, :]           # D0_vert (:3486-3494)
        return dv, dw


@dataclasses.dataclass(frozen=True, eq=False)
class AnelasticTendencies(SpamTendencies):
    """SpamTendencies with the AN Hamiltonian and the pressure projection
    after every symplectic evaluation.

    The dens layout stays [rho, S(, tracers)], but rho is pinned to the
    reference profile: its tendency is zeroed (VS_AN
    ndensity_dycore_prognostic=1)."""
    psolver: Any = None

    def functional_derivatives(self, dens, v, w, geop):
        """F, FW and K as the base; B by Hamiltonian_AN_Hs
        (anelastic.h:57-95): the enthalpy at the reference pressure."""
        g, vs, th = self.geom, self.varset, self.thermo
        F, FW, K, _ = SpamTendencies.functional_derivatives(self, dens, v, w,
                                                            geop)
        refp = th.solve_p(self.ref_rho_pi[:, :, None],
                          self.ref_q_pi[1][:, :, None])
        sv = vs.get_entropic_var(dens)
        H = th.compute_H(refp, sv)
        gexner = th.compute_dHdentropic_var(refp, sv)
        B_mass = op.Hn1bar(geop, g) + H - sv * gexner + op.Hn1bar(K, g)
        return F, FW, K, torch.stack([B_mass,
                                      gexner.expand(B_mass.shape)])

    def recons(self, dens, qhz, F, FW, FT, FTW):
        """AN branch of compute_recons (extrudedmodel.h:1042-1052,
        1100-1107): the mass-density reconstruction is identically 1 (the
        mass flux is exactly rho_ref u)."""
        dr, dvr, qr, qvr = SpamTendencies.recons(self, dens, qhz, F, FW, FT,
                                                 FTW)
        dr, dvr = dr.clone(), dvr.clone()
        dr[0] = 1.0
        dvr[0] = 1.0
        return dr, dvr, qr, qvr

    def post_symplectic(self, fd, fv, fw):
        """rho pinning and the anelastic tendency projection, after every
        symplectic evaluation (add_pressure_perturbation,
        extrudedmodel.h:2496-2503; compute_rhs and the SI integrators'
        fixed-point rhs, SI_Fixed.h:41-53)."""
        fd = fd.clone()
        fd[0] = 0.0     # the mass density is not prognostic (VS_AN)
        # the tendency is -F: project it so that d/dt of the anelastic
        # constraint vanishes, then return to the F convention
        dv, dw = self.psolver.project(-fv, -fw)
        return fd, fv - dv, fw - dw

    def compute_rhs(self, dens, v, w, geop, dt):
        """The base symplectic tendencies and the post hook
        (Tendencies::compute_rhs + add_pressure_perturbation,
        model.h:275-284)."""
        fd, fv, fw = SpamTendencies.compute_rhs(self, dens, v, w, geop, dt)
        return self.post_symplectic(fd, fv, fw)


@dataclasses.dataclass(frozen=True, eq=False)
class ManTendencies(AnelasticTendencies):
    """Moist anelastic (PAMC_MAN) variant.

    Parity reference: Hamiltonian_MAN_Hs (hamiltonians/anelastic.h:163-340)
    and VS_MAN (variableset.h:84-106, 1196-1335). The dens layout stays
    [rho, S, tracers...] with rho pinned to the reference profile (the
    reference stores rho last; the same bookkeeping). The reference
    pressure includes the reference vapour (anelastic.h:214-219); the
    chemical-potential terms enter B_mass (anelastic.h:262-268;
    ConstantKappa decouples the moist species, so no active tracer row
    of B)."""

    def functional_derivatives(self, dens, v, w, geop):
        g, vs, th = self.geom, self.varset, self.thermo
        F, FW, K, _ = SpamTendencies.functional_derivatives(self, dens, v, w,
                                                            geop)
        refrho = self.ref_rho_pi[:, :, None]
        refs = self.ref_q_pi[vs.dens_id_entr][:, :, None]
        refqv = self.ref_q_pi[vs.dens_id_vap][:, :, None]
        refp = th.solve_p(refrho, refs, 1.0 - refqv, refqv, 0.0, 0.0)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        H = th.compute_H(refp, sv, qd, qv, ql, qi)
        gexner = th.compute_dHdentropic_var(refp, sv, qd, qv, ql, qi)
        mu_d, mu_v, mu_l, mu_i = th.compute_dHdq(refp, sv, qd, qv, ql, qi)
        B_mass = (op.Hn1bar(geop, g) + H - sv * gexner +
                  qv * (mu_d - mu_v) + ql * (mu_d - mu_l) +
                  qi * (mu_d - mu_i) + op.Hn1bar(K, g))
        return F, FW, K, torch.stack([B_mass,
                                      gexner.expand(B_mass.shape)])


def project_initial(psolver, v, w):
    """project_to_anelastic on the initial state
    (extrudedmodel.h:2489-2494)."""
    dv, dw = psolver.project(v, w)
    return v + dv, w + dw

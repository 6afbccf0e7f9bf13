"""SPAM layer models: (thermal) shallow water on the doubly periodic plane
(port of pam_tpu/spam/layer.py).

Parity reference: dynamics/spam/src/models/layermodel.h (ModelTendencies,
SWETestCase, DoubleVortex :1272-1360) + hamiltonians/layer_models.h
(Hamiltonian_SWE_Hs :138-236, Hamiltonian_TSWE_Hs :8-137) +
hamiltonians/functionals.h Functional_PVPE (:10-75) + the 2D wedge ops
(operators/wedge.h Q2D/W2D :4-45, 790-805) and the layer exterior
derivatives (operators/ext_deriv.h D1 :714-736).

Fields are ``(ndof, nens, ny, nx)`` tensors, pam_tpu's layout; periodic
shifts are rolls. The order-5 WENO edge values along x and along y are
the function of the B1 kernel (ops/weno_x.py, csrc/weno_x.cu): a CUDA
tensor goes through it, along y on a view with y moved last; a CPU tensor
takes its plain version. One tendency evaluation reconstructs the
densities, q0 and f0 stacked into one field, so B1 launches twice per
evaluation (x and y), six times per SSPRK3 step.

2D indexing quirks transcribed verbatim:
* straight (primal) reconstructions enumerate dims REVERSED: component
  d=1 reconstructs along x, d=0 along y, and the d=0 upwind flux is
  negated ("corrects for twist", recon.h:444-448).
* Q2D / W2D carry the (-x, +y) perpendicular signs (wedge.h:4-30).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import weno, weno_x
from ..parallel import comm


def shift(a, dj, di):
    """result[..., j, i] = a[..., j+dj, i+di] (doubly periodic)."""
    out = comm.proll(a, di, axis=-1) if di else a
    return comm.proll(out, dj, axis=-2) if dj else out


def _edge_recon(field, tables, axis):
    """WENO left/right edge values of each cell along the trailing axis
    ``axis`` (-1 = x, -2 = y), periodic; field (..., ny, nx). B1 on a CUDA
    tensor (order 5 only: another order raises), the plain version on a
    CPU tensor."""
    if axis == -1:
        return weno_x.weno_edges_x(field, tables)
    left, right = weno_x.weno_edges_x(field.movedim(-2, -1), tables,
                                      kind="y")
    return left.movedim(-1, -2), right.movedim(-1, -2)


@dataclasses.dataclass(frozen=True, eq=False)
class LayerModel:
    """SWE ("swe") or thermal SWE ("tswe") on a uniform periodic plane.

    Fields: dens (ndens, nens, ny, nx) dual 2-forms
    (SWE: [h(, tracers...)]; TSWE: [h, S(, tracers...)]);
    v (2, nens, ny, nx) primal 1-forms (v[0]=x-edge, v[1]=y-edge);
    hs: surface height 2-form (nens, ny, nx); coriolis: primal 2-form.
    """
    nx: int
    ny: int
    nens: int
    Lx: float
    Ly: float
    g: float
    variant: str = "swe"          # "swe" | "tswe"
    ndens: int = 1
    ord: int = 5
    dtype: Any = torch.float64
    device: Any = "cuda"

    @property
    def dx(self):
        return self.Lx / self.nx

    @property
    def dy(self):
        return self.Ly / self.ny

    def tables(self):
        return weno.weno_tables(self.ord, self.dtype)

    # -------------------------------------------------------------- operators
    def H2bar(self, a):
        """dual 2-form -> primal 0-form (diagonal, diff_ord=2)."""
        return a / (self.dx * self.dy)

    def H1(self, v):
        """primal 1-form -> dual 1-form (diagonal): U0 = v0*dy/dx,
        U1 = v1*dx/dy (hodge_star.h H1 2D diagonal)."""
        return torch.stack([v[0] * (self.dy / self.dx),
                            v[1] * (self.dx / self.dy)])

    def q0f0(self, dens, v, coriolis):
        """PV/Coriolis at primal vertices (functionals.h:43-52):
        hv = R(h) 4-pt average; zeta = D1(v)."""
        h = dens[0]
        hv = 0.25 * (h + shift(h, 0, -1) + shift(h, -1, 0) +
                     shift(h, -1, -1))
        zeta = v[1] - v[0] - shift(v[1], 0, -1) + shift(v[0], -1, 0)
        return zeta / hv, coriolis / hv, hv, zeta

    # ---------------------------------------------------- functional derivs
    def functional_derivatives(self, dens, v, hs):
        """F, K, he, B (layermodel.h compute_functional_derivatives:475-520:
        F_and_K + B via Hs.compute_dHsdx + Hk.compute_dKddens)."""
        dens0 = self.H2bar(dens)
        h0 = dens0[0]
        U = self.H1(v)
        he = torch.stack([0.5 * (h0 + shift(h0, 0, -1)),
                          0.5 * (h0 + shift(h0, -1, 0))])
        F = he * U
        # K = 0.5 * phiT(U, v) per dual cell (kinetic_energy.h:122-124)
        K = 0.5 * (0.5 * (U[0] * v[0] + shift(U[0] * v[0], 0, 1)) +
                   0.5 * (U[1] * v[1] + shift(U[1] * v[1], 1, 0)))
        K0 = self.H2bar(K)
        hs0 = self.H2bar(hs)
        g = self.g
        nd = self.ndens
        B = [None] * nd
        if self.variant == "swe":
            # layer_models.h Hamiltonian_SWE_Hs:181-236
            Bm = g * hs0 + g * h0
            for l in range(1, nd):
                Bm = Bm + 0.5 * dens0[l]
            B[0] = Bm + K0
            for l in range(1, nd):
                B[l] = 0.5 * h0
        else:
            # layer_models.h Hamiltonian_TSWE_Hs:45-135 (dens1 = S)
            Bm = 0.5 * dens0[1]
            for l in range(2, nd):
                Bm = Bm + 0.5 * dens0[l]
            B[0] = Bm + K0
            B[1] = hs0 + 0.5 * h0
            for l in range(2, nd):
                B[l] = 0.5 * h0
        return F, K, he, torch.stack(B)

    # ------------------------------------------------------------- recons
    def recons(self, dens, q0, f0, F, he):
        """Upwinded WENO reconstructions (layermodel.h:304-423). The
        densities, q0 and f0 are reconstructed as one stacked field, once
        along x and once along y."""
        tb = self.tables()
        nd = dens.shape[0]
        field = torch.cat([self.H2bar(dens), q0[None], f0[None]])
        lx, rx = _edge_recon(field, tb, -1)
        ly, ry = _edge_recon(field, tb, -2)
        # twisted (dual) dens recon: d=0 along x, d=1 along y; upwind by F
        dens_rx = torch.where(F[0] >= 0, shift(rx[:nd], 0, -1), lx[:nd])
        dens_ry = torch.where(F[1] >= 0, shift(ry[:nd], -1, 0), ly[:nd])
        densrecon = torch.stack([dens_rx / he[0], dens_ry / he[1]])
        # FT = W(F) (wedge.h compute_W:790-805)
        ft0 = -0.25 * (F[1] + shift(F[1], 0, -1) + shift(F[1], 1, 0) +
                       shift(F[1], 1, -1))
        ft1 = 0.25 * (F[0] + shift(F[0], 0, 1) + shift(F[0], -1, 0) +
                      shift(F[0], -1, 1))
        # straight (primal) q/f recons; REVERSED dim enumeration
        # (recon.h:444-462): component d=1 along x upwinded by ft1,
        # d=0 along y upwinded by -ft0
        r1 = torch.where(ft1 >= 0, rx[nd:], shift(lx[nd:], 0, 1))
        r0 = torch.where(-ft0 >= 0, ry[nd:], shift(ly[nd:], 1, 0))
        return (densrecon, torch.stack([r0[0], r1[0]]),
                torch.stack([r0[1], r1[1]]))

    # ---------------------------------------------------------- tendencies
    def _Q_EC(self, recon, F):
        """Energy-conserving PV flux (wedge.h Q2D/compute_Q_EC:4-90)."""
        r0, r1 = recon[0], recon[1]
        f0 = (F[1] + shift(F[1], 0, -1) + shift(F[1], 1, 0) +
              shift(F[1], 1, -1))
        vel0 = -0.125 * (F[1] * r1 + shift(F[1], 0, -1) * shift(r1, 0, -1) +
                         shift(F[1], 1, 0) * shift(r1, 1, 0) +
                         shift(F[1], 1, -1) * shift(r1, 1, -1) +
                         f0 * r0)
        f1 = (F[0] + shift(F[0], 0, 1) + shift(F[0], -1, 0) +
              shift(F[0], -1, 1))
        vel1 = 0.125 * (F[0] * r0 + shift(F[0], 0, 1) * shift(r0, 0, 1) +
                        shift(F[0], -1, 0) * shift(r0, -1, 0) +
                        shift(F[0], -1, 1) * shift(r0, -1, 1) +
                        f1 * r1)
        return torch.stack([vel0, vel1])

    def compute_rhs(self, dens, v, hs, coriolis):
        """One tendency evaluation; dx/dt = -(denstend, vtend)
        (layermodel.h compute_tendencies:424-474 + apply_symplectic)."""
        F, K, he, B = self.functional_derivatives(dens, v, hs)
        q0, f0, _, _ = self.q0f0(dens, v, coriolis)
        densrecon, qrecon, frecon = self.recons(dens, q0, f0, F, he)
        # v tendency: wD0 (x/y gradients of B weighted by the active dens
        # recon; densrecon is (2[dir], ndens, nens, ny, nx))
        nact = 1 if self.variant == "swe" else 2
        dBx = B - shift(B, 0, -1)
        dBy = B - shift(B, -1, 0)
        vtend = torch.stack([(densrecon[0][:nact] * dBx[:nact]).sum(0),
                             (densrecon[1][:nact] * dBy[:nact]).sum(0)])
        vtend = vtend + self._Q_EC(qrecon, F) + self._Q_EC(frecon, F)
        # dens tendency: wDnm1bar (2D divergence with recon weights)
        fx = densrecon[0] * F[0][None]
        fy = densrecon[1] * F[1][None]
        denstend = (shift(fx, 0, 1) - fx) + (shift(fy, 1, 0) - fy)
        return denstend, vtend

    def ssprk3_step(self, dens, v, hs, coriolis, dt):
        """(SSPRK.h:60-78, x - dt*F form as in the extruded model)."""
        fd, fv = self.compute_rhs(dens, v, hs, coriolis)
        d1, v1 = dens - dt * fd, v - dt * fv
        fd, fv = self.compute_rhs(d1, v1, hs, coriolis)
        d2 = 0.75 * dens + 0.25 * (d1 - dt * fd)
        v2 = 0.75 * v + 0.25 * (v1 - dt * fv)
        fd, fv = self.compute_rhs(d2, v2, hs, coriolis)
        dens3 = dens / 3.0 + (2.0 / 3.0) * (d2 - dt * fd)
        v3 = v / 3.0 + (2.0 / 3.0) * (v2 - dt * fv)
        return dens3, v3

    # ------------------------------------------------------------- stats
    def statistics(self, dens, v, hs, coriolis):
        """Mass, PV, total energy (layermodel.h ModelStats:901-1205)."""
        F, K, he, B = self.functional_derivatives(dens, v, hs)
        U = self.H1(v)
        KE = 0.5 * torch.sum(he * U * v, dim=(0, -2, -1))
        dens0 = self.H2bar(dens)
        h0 = dens0[0]
        hs0 = self.H2bar(hs)
        if self.variant == "swe":
            PE = torch.sum(self.g * hs0 * dens[0] +
                           0.5 * self.g * h0 * dens[0], dim=(-2, -1))
        else:
            PE = torch.sum(hs0 * dens[1] + 0.5 * h0 * dens[1], dim=(-2, -1))
        _, _, hv, zeta = self.q0f0(dens, v, coriolis)
        return dict(mass=torch.sum(dens, dim=(-2, -1)),
                    pv=torch.sum(zeta + coriolis, dim=(-2, -1)),
                    E=KE + PE, KE=KE, PE=PE)


# ---------------------------------------------------------------- testcase
@dataclasses.dataclass(frozen=True)
class DoubleVortex:
    """(layermodel.h:1272-1360)."""
    g: float = 9.80616
    Lx: float = 5000000.0
    Ly: float = 5000000.0
    coriolis: float = 0.00006147
    H0: float = 750.0
    ox: float = 0.1
    oy: float = 0.1
    dh: float = 75.0
    c: float = 0.05
    a: float = 1.0 / 3.0

    @property
    def sigmax(self):
        return 3.0 / 40.0 * self.Lx

    @property
    def sigmay(self):
        return 3.0 / 40.0 * self.Ly

    def _primes(self, x, y, xc, yc):
        sx, sy = self.sigmax, self.sigmay
        xp = self.Lx / (np.pi * sx) * np.sin(np.pi / self.Lx * (x - xc))
        yp = self.Ly / (np.pi * sy) * np.sin(np.pi / self.Ly * (y - yc))
        xpp = self.Lx / (2 * np.pi * sx) * np.sin(
            2 * np.pi / self.Lx * (x - xc))
        ypp = self.Ly / (2 * np.pi * sy) * np.sin(
            2 * np.pi / self.Ly * (y - yc))
        return xp, yp, xpp, ypp

    def _centers(self):
        xc1 = (0.5 - self.ox) * self.Lx
        yc1 = (0.5 - self.oy) * self.Ly
        xc2 = (0.5 + self.ox) * self.Lx
        yc2 = (0.5 + self.oy) * self.Ly
        return xc1, yc1, xc2, yc2

    def h_f(self, x, y):
        xc1, yc1, xc2, yc2 = self._centers()
        xp1, yp1, _, _ = self._primes(x, y, xc1, yc1)
        xp2, yp2, _, _ = self._primes(x, y, xc2, yc2)
        sx, sy = self.sigmax, self.sigmay
        return self.H0 - self.dh * (
            np.exp(-0.5 * (xp1 ** 2 + yp1 ** 2)) +
            np.exp(-0.5 * (xp2 ** 2 + yp2 ** 2)) -
            4.0 * np.pi * sx * sy / self.Lx / self.Ly)

    def v_f(self, x, y):
        xc1, yc1, xc2, yc2 = self._centers()
        xp1, yp1, xpp1, ypp1 = self._primes(x, y, xc1, yc1)
        xp2, yp2, xpp2, ypp2 = self._primes(x, y, xc2, yc2)
        e1 = np.exp(-0.5 * (xp1 ** 2 + yp1 ** 2))
        e2 = np.exp(-0.5 * (xp2 ** 2 + yp2 ** 2))
        u = -self.g * self.dh / self.coriolis / self.sigmay * \
            (ypp1 * e1 + ypp2 * e2)
        vv = self.g * self.dh / self.coriolis / self.sigmax * \
            (xpp1 * e1 + xpp2 * e2)
        return u, vv

    def S_f(self, x, y):
        xc, yc = 0.5 * self.Lx, 0.5 * self.Ly
        D = 0.5 * self.Lx
        sval = self.g * (1.0 + self.c * np.exp(
            -((x - xc) ** 2 + (y - yc) ** 2) / (self.a ** 2 * D ** 2)))
        return sval * self.h_f(x, y)


@dataclasses.dataclass(frozen=True)
class BickleyJet:
    """Unstable Bickley jet with a sinusoidal perturbation
    (ref: layermodel.h:1362-1393). Nondimensional domain 4*pi x 4*pi,
    no Coriolis; TSWE buoyancy S = g*h."""
    g: float = 9.80616
    Lx: float = 4.0 * np.pi
    Ly: float = 4.0 * np.pi
    eps: float = 0.1
    l: float = 0.5
    k: float = 0.5
    coriolis: float = 0.0

    def h_f(self, x, y):
        return np.ones_like(x + y)

    def v_f(self, x, y):
        # the reference centres the domain at (xc, yc) = 0; this grid
        # spans [0, L), so shift to [-L/2, L/2)
        x = x - 0.5 * self.Lx
        y = y - 0.5 * self.Ly
        U = np.cosh(y) ** -2
        psi = (np.exp(-(y + self.l / 10.0) ** 2 / (2 * self.l ** 2)) *
               np.cos(self.k * x) * np.cos(self.k * y))
        u = psi * (self.k * np.tan(self.k * y) + y / self.l ** 2)
        v = -psi * self.k * np.tan(self.k * x)
        return U + self.eps * u, self.eps * v

    def S_f(self, x, y):
        return self.g * self.h_f(x, y)


LAYER_TESTCASES = {"doublevortex": DoubleVortex, "bickleyjet": BickleyJet}


def setup_double_vortex(model: LayerModel, tc, nquad: int = 5):
    """Initial (dens, v, hs, coriolis) by Gauss quadrature projections
    (SWETestCase::set_initial_conditions, layermodel.h:1207-1264), in
    numpy float64, cast once to the model's dtype on its device."""
    qp, qw = np.polynomial.legendre.leggauss(nquad)
    qp = 0.5 * (qp + 1.0)
    qw = 0.5 * qw
    nx, ny = model.nx, model.ny
    dx, dy = model.dx, model.dy
    xe = np.arange(nx) * dx
    ye = np.arange(ny) * dy

    def cell_avg2(f):
        acc = 0.0
        for px, wx in zip(qp, qw):
            for py, wy in zip(qp, qw):
                acc = acc + wx * wy * f(xe[None, :] + px * dx,
                                        ye[:, None] + py * dy)
        return acc

    h = cell_avg2(tc.h_f) * dx * dy
    fields = [h]
    if model.variant == "tswe":
        fields.append(cell_avg2(tc.S_f) * dx * dy)
    while len(fields) < model.ndens:
        fields.append(np.zeros_like(h))

    # v: 1-form line integrals along primal edges (quadrature of components)
    def edge_int(f, comp, along_x):
        acc = 0.0
        for p, w in zip(qp, qw):
            if along_x:
                acc = acc + w * f(xe[None, :] + p * dx, ye[:, None])[comp]
            else:
                acc = acc + w * f(xe[None, :], ye[:, None] + p * dy)[comp]
        return acc * (dx if along_x else dy)

    v0 = edge_int(tc.v_f, 0, True)
    v1 = edge_int(tc.v_f, 1, False)
    nens = model.nens
    T = lambda a: torch.as_tensor(
        np.repeat(np.asarray(a)[:, None], nens, axis=1), dtype=model.dtype,
        device=model.device)
    full = lambda val: torch.full((nens, ny, nx), val, dtype=model.dtype,
                                  device=model.device)
    return (T(np.stack(fields)), T(np.stack([v0, v1])), full(0.0),
            full(tc.coriolis * dx * dy))

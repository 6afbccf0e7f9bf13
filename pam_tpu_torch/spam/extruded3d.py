"""SPAM extruded-model tendencies in 3-D, x-y-z (port of
pam_tpu/spam/extruded3d.py; ref dynamics/spam/src/models/extrudedmodel.h
with ndims=2, the reference's 3-D compile configuration). Against the
x-z slab (spam/tendencies.py) it adds:

* the y velocity component v[1] and the y mass flux F[1]
  (kinetic_energy.h compute_he_U_and_K, ndims > 1);
* three PV components: qhz = (qxz, qyz) at dual horizontal-vertical
  vertices (functionals.h compute_qhzfhz, zeta_xz negated for ndims=2,
  ext_deriv.h D1_ext:700-719) and qxy at dual layers (compute_qxyfxy);
* the tangent fluxes FT = (Wxz_u, Wyz_u), FTW = (Wxz_w, Wyz_w) and
  FTxy = W2D(F) (wedge.h:780-1010; Wyz_u is +, Wxz_u is -);
* the Q operators with the ndims=2 signs: Qxz_w / Qxz_u flip against
  ndims=1 (wedge.h:154, 506), Qyz_w is +, Qyz_v is - (wedge.h:313-408,
  635-700), and the horizontal Q_EC per level;
* the y reconstructions of densities and PV, and 3-D FCT fluxes.

Layout ``(…, nens, nz, ny, nx)``: x and y periodic (rolls), z by the
slab's mirror halos. A y-invariant state with v[1] = 0 reproduces the
slab (the two sign flips cancel). Every periodic horizontal WENO
reconstruction goes to the B1 kernel for CUDA tensors (ops/weno_x.py):
along x directly, along y on a view with y moved last (the same
function along another periodic axis); a CPU tensor takes its plain
version. Everything else is plain torch.

compute_rhs returns F with dx/dt = -F (SSPRK.h:63-78).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops import weno, weno_x
from ..parallel import comm
from ..parallel.mesh import per_member
from . import timesteppers
from .tendencies import level_matrices

AXZ = -3  # z axis
AXY = -2  # y axis
AXX = -1  # x axis


def rx(a, s):
    """result[..., i] = a[..., i+s] along x (periodic)."""
    return comm.proll(a, s, axis=AXX)


def ry(a, s):
    """result[..., j, :] = a[..., j+s, :] along y (periodic)."""
    return comm.proll(a, s, axis=AXY)


def _flipz(a, start, stop):
    return torch.flip(a[..., start:stop, :, :], dims=(AXZ,))


def mirror_layer(a, h: int):
    """Mirror-pad a layer field along z by h (exchange.h:571-585)."""
    n = a.shape[AXZ]
    return torch.cat([_flipz(a, 0, h), a, _flipz(a, n - h, n)], dim=AXZ)


def mirror_iface(a, h: int):
    """Mirror-pad an interface field along z by h (exchange.h:589-602)."""
    n = a.shape[AXZ]
    return torch.cat([_flipz(a, 1, h + 1), a, _flipz(a, n - 1 - h, n - 1)],
                     dim=AXZ)


def _zs(a, start, stop):
    """a[..., start:stop, :, :]."""
    return a[..., start:stop, :, :]


def _edge_recon_h(field, tables, axis, recon_type: str = "wenofunc"):
    """(left, right) edge values of each cell along the periodic
    horizontal ``axis`` (AXX or AXY) (recon.h compute_twisted/
    straight_edge_recon). "wenofunc"/"weno": the limited reconstruction,
    B1 on a CUDA tensor; "cfv": the centred one, plain torch."""
    if recon_type == "cfv":
        s2c, c2g = tables[0], tables[4]
        hs = (s2c.shape[-1] - 1) // 2
        sten = [comm.proll(field, s - hs, axis=axis)
                for s in range(s2c.shape[-1])]
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    if axis == AXX:
        return weno_x.weno_edges_x(field, tables)
    left, right = weno_x.weno_edges_x(field.movedim(AXY, AXX), tables,
                                      kind="y")
    return left.movedim(AXX, AXY), right.movedim(AXX, AXY)


def _edge_recon_z(field_padded, tables, nlev, recon_type: str = "wenofunc",
                  per_level=None):
    """(bottom, top) edge values of z-cells 0..nlev-1 from a field
    mirror-padded by hs along z; per_level: the stretched grid's (s2c,
    wrl) with trailing (nens, nlev, 1, 1) dims."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    sten = [_zs(field_padded, s, s + nlev) for s in range(ord)]
    if per_level is not None:
        s2c, wrl = per_level
    if recon_type == "cfv":
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def _upwind_h(left, right, flux, axis, utype="heaviside", coeff=250.0,
              area=None):
    """Twisted recon at the minus-side edge of each cell along a horizontal
    axis: flux >= 0 takes the upwind cell's (i-1 / j-1) plus-side edge
    (recon.h upwind_recon; TANH the blend, tanh_upwind_recon:326-340)."""
    cand_L = comm.proll(right, -1, axis=axis)
    if utype == "tanh":
        p = torch.tanh((flux / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + left * (1 - p))
    return torch.where(flux >= 0, cand_L, left)


def _interior_rows(nz1, device):
    """(1, nz1, 1, 1) mask of the interior dual interfaces 1..nz1-2."""
    k = torch.arange(nz1, device=device)
    return ((k > 0) & (k < nz1 - 1))[None, :, None, None]


@dataclasses.dataclass(frozen=True, eq=False)
class Tendencies3D:
    """Static config and reference-state tensors of the 3-D extruded CE /
    MCE model."""
    geom: Any
    varset: Any
    thermo: Any
    grav: float = 9.80616
    ord: int = 5
    force_refstate_hydrostatic_balance: bool = False
    reconstruction_type: str = "wenofunc"   # "wenofunc"|"weno"|"cfv"
    dual_upwind_type: str = "heaviside"     # "heaviside"|"tanh"
    tanh_upwind_coeff: float = 250.0
    # reference state columns (None -> zeros), run dtype/device
    refdens: Any = per_member(1, default=None)  # (ndens, nens, nz)
    ref_q_pi: Any = per_member(1, default=None)  # (ndens, nens, nz)
    ref_rho_pi: Any = per_member(0, default=None)  # (nens, nz)
    ref_q_di: Any = per_member(1, default=None)  # (ndens, nens, nz+1)
    ref_rho_di: Any = per_member(0, default=None)  # (nens, nz+1)
    ref_B: Any = per_member(1, default=None)  # (nactive, nens, nz)
    # per-level z matrices of a stretched grid (None on a uniform one)
    # dual layers, thickness dz_d
    per_level_d: Any = per_member(-4, default=None)
    # primal layers, thickness dz_p
    per_level_q: Any = per_member(-4, default=None)

    def __post_init__(self):
        g = self.geom
        if not g.uniform_vertical and self.per_level_d is None:
            object.__setattr__(self, "per_level_d",
                               level_matrices(g, g.dz_d, self.ord, nh=2))
            object.__setattr__(self, "per_level_q",
                               level_matrices(g, g.dz_p, self.ord, nh=2))

    def tables(self):
        return weno.weno_tables(self.ord, self.geom.dtype)

    def vert_per_level(self):
        return self.per_level_d

    def vert_per_level_q(self):
        return self.per_level_q

    @property
    def hs(self):
        return (self.ord - 1) // 2

    # --- diagonal Hodge stars with the 3-D areas (hodge_star_extruded.h) ---
    def Hn1bar(self, dens):
        """Dual n-form -> 0-form: /(dx dy dz_d)."""
        g = self.geom
        return dens / (g.dx * g.dy * g.dz_d_t[:, :, None, None])

    def H10(self, v):
        """Primal 1-form -> dual flux: U0 = v0 dz dy/dx, U1 = v1 dz dx/dy."""
        g = self.geom
        dz = g.dz_d_t[:, :, None, None]
        return torch.stack([v[0] * (dz * g.dy / g.dx),
                            v[1] * (dz * g.dx / g.dy)])

    def H01(self, w):
        """w -> UW at the interior dual interfaces, w dx dy/dz_p; 0 at the
        rigid lid and the ground."""
        g = self.geom
        inner = w * (g.dx * g.dy / g.dz_p_t[:, :, None, None])
        z = torch.zeros_like(_zs(inner, 0, 1))
        return torch.cat([z, inner, z], dim=AXZ)

    # ------------------------------------------------------------------
    def functional_derivatives(self, dens, v, w, geop):
        """F (2 components), FW, K, B (extrudedmodel.h:1996-2084 +
        kinetic_energy.h compute_he_U_and_K, ndims=2 branches)."""
        vs, th = self.varset, self.thermo
        rho0 = self.Hn1bar(vs.get_total_density(dens))
        he0 = 0.5 * (rho0 + rx(rho0, -1))
        he1 = 0.5 * (rho0 + ry(rho0, -1))
        rho0_pad = mirror_layer(rho0, 1)
        hew = 0.5 * (rho0_pad[..., 1:, :, :] + rho0_pad[..., :-1, :, :])
        U = self.H10(v)
        uw = self.H01(w)
        F = torch.stack([he0 * U[0], he1 * U[1]])
        FW = hew * uw
        # kinetic energy per dual cell (kinetic_energy.h:383-394, + y term)
        vu0, vu1 = v[0] * U[0], v[1] * U[1]
        Kh = 0.5 * (vu0 + rx(vu0, 1)) + 0.5 * (vu1 + ry(vu1, 1))
        w_pad = mirror_layer(w, 1)
        Kv = 0.5 * (w_pad[..., :-1, :, :] * uw[..., :-1, :, :] +
                    w_pad[..., 1:, :, :] * uw[..., 1:, :, :])
        K = 0.5 * (Kh + Kv)
        # B = dH/ddens (the slab's columnwise thermodynamics)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        geop0 = self.Hn1bar(geop)
        Uth = th.compute_U(alpha, sv, qd, qv, ql, qi)
        p = -th.compute_dUdalpha(alpha, sv, qd, qv, ql, qi)
        gExner = th.compute_dUdentropic_var(alpha, sv, qd, qv, ql, qi)
        B_mass = geop0 + Uth + p * alpha - sv * gExner
        if vs.variant != "CE":
            mu_d, mu_v, mu_l, mu_i = th.compute_dUdq(alpha, sv, qd, qv, ql,
                                                     qi)
            B_mass = B_mass + qv * (mu_d - mu_v) + ql * (mu_d - mu_l) + \
                qi * (mu_d - mu_i)
        B_mass = B_mass + self.Hn1bar(K)
        return F, FW, K, torch.stack([B_mass, gExner])

    # ------------------------------------------------------------------
    def _R_avg_h(self, D, axis):
        """Dual-vertex average of a dual-layer field onto the hz vertices
        along a horizontal axis: interfaces 0..nz, boundary-weighted rows
        1 and nz-1, rows 0 and nz zero (functionals.h compute_hvxz/hvyz)."""
        Ds = D + comm.proll(D, -1, axis=axis)
        nz = D.shape[AXZ]
        full_int = 0.25 * (Ds[..., :-1, :, :] + Ds[..., 1:, :, :])
        bot = 0.25 * _zs(Ds, 1, 2) + 0.5 * _zs(Ds, 0, 1)
        top = 0.25 * Ds[..., -2:-1, :, :] + 0.5 * Ds[..., -1:, :, :]
        z = torch.zeros_like(bot)
        if nz > 2:
            return torch.cat([z, bot, full_int[..., 1:-1, :, :], top, z],
                             dim=AXZ)
        return torch.cat([z, bot, top, z], dim=AXZ)

    def _hvxy(self, rho_n):
        return 0.25 * (rho_n + rx(rho_n, -1) + ry(rho_n, -1) +
                       rx(ry(rho_n, -1), -1))

    def q_and_f(self, dens, v, w):
        """PV at dual vertices: qhz (2, nens, nz+1, ny, nx) with zero
        boundary rows, and qxy (nens, nz, ny, nx) (functionals.h:117-400
        with the D1_ext ndims=2 signs)."""
        rho_n = self.varset.get_total_density(dens)
        hv0 = self._R_avg_h(rho_n, AXX)
        hv1 = self._R_avg_h(rho_n, AXY)
        w_pad = mirror_layer(w, 1)            # w_pad[k] = w[k-1]
        # vertex k: v terms at k-1/k (mirror-iface pad), w at layer k-1
        v0_pad = mirror_iface(v[0], 1)
        v1_pad = mirror_iface(v[1], 1)
        dv0 = v0_pad[..., :-1, :, :] - v0_pad[..., 1:, :, :]
        dv1 = v1_pad[..., :-1, :, :] - v1_pad[..., 1:, :, :]
        # ndims=2 signs (ext_deriv.h D1_ext:705-716): zeta_xz negated
        zeta_xz = -(dv0 + (w_pad - rx(w_pad, -1)))
        zeta_yz = (w_pad - ry(w_pad, -1)) + dv1
        interior = _interior_rows(zeta_xz.shape[AXZ], zeta_xz.device)
        zero = torch.zeros_like(zeta_xz)
        one = torch.ones_like(hv0)
        qhz0 = torch.where(interior,
                           zeta_xz / torch.where(hv0 == 0, one, hv0), zero)
        qhz1 = torch.where(interior,
                           zeta_yz / torch.where(hv1 == 0, one, hv1), zero)
        # vertical vorticity (compute_zetaxy: D1 of horizontal v per layer)
        zeta_xy = (v[1] - rx(v[1], -1)) - (v[0] - ry(v[0], -1))
        return torch.stack([qhz0, qhz1]), zeta_xy / self._hvxy(rho_n)

    # ------------------------------------------------------------------
    def tangent_fluxes(self, F, FW):
        """FT (at v-points), FTW (at w-points), FTxy (at v-points)
        (wedge.h Wxz_u -, Wyz_u +, Wxz_w / Wyz_w +, W2D:790-805)."""
        # FT0 = Wxz_u(FW): -(FW[k,i]+FW[k,i-1]+FW[k+1,i]+FW[k+1,i-1])/4
        sx = FW + rx(FW, -1)
        FT0 = torch.cat([-0.5 * _zs(sx, 0, 1),
                         -0.25 * (_zs(sx, 1, -2) + _zs(sx, 2, -1)),
                         -0.5 * sx[..., -1:, :, :]], dim=AXZ)
        # FT1 = Wyz_u(FW), + (wedge.h Wyz_u:963-1010)
        sy = FW + ry(FW, -1)
        FT1 = torch.cat([0.5 * _zs(sy, 0, 1),
                         0.25 * (_zs(sy, 1, -2) + _zs(sy, 2, -1)),
                         0.5 * sy[..., -1:, :, :]], dim=AXZ)
        # FTW0 = Wxz_w(F0), FTW1 = Wyz_w(F1) (both +, boundary coefficient
        # 0.25 on the interior-shifted dual layer, wedge.h:880-905)
        s0 = F[0] + rx(F[0], 1)
        ftw0 = torch.cat([0.25 * _zs(s0, 1, 2),
                          0.25 * (_zs(s0, 1, -2) + _zs(s0, 2, -1)),
                          0.25 * _zs(s0, -2, -1)], dim=AXZ)
        s1 = F[1] + ry(F[1], 1)
        ftw1 = torch.cat([0.25 * _zs(s1, 1, 2),
                          0.25 * (_zs(s1, 1, -2) + _zs(s1, 2, -1)),
                          0.25 * _zs(s1, -2, -1)], dim=AXZ)
        # FTxy = W2D(F) per level (wedge.h compute_W:790-805)
        ftxy0 = -0.25 * (F[1] + rx(F[1], -1) + ry(F[1], 1) +
                         rx(ry(F[1], 1), -1))
        ftxy1 = 0.25 * (F[0] + rx(F[0], 1) + ry(F[0], -1) +
                        rx(ry(F[0], -1), 1))
        return (FT0, FT1), (ftw0, ftw1), (ftxy0, ftxy1)

    # ------------------------------------------------------------------
    def recons(self, dens, qhz, qxy, F, FW, FT, FTW, FTxy):
        """Upwinded reconstructions of the densities and of all three PV
        components (extrudedmodel.h compute_edge_reconstructions_* +
        compute_recons, ndims=2 branches): 6 horizontal WENO calls, 3
        along x and 3 along y."""
        g, vs = self.geom, self.varset
        tb = self.tables()
        hs = self.hs
        ut, cf = self.dual_upwind_type, self.tanh_upwind_coeff
        rt = self.reconstruction_type
        rho0 = self.Hn1bar(vs.get_total_density(dens))
        if self.refdens is not None:
            dens0 = self.Hn1bar(dens - self.refdens[:, :, :, None, None])
        else:
            dens0 = self.Hn1bar(dens)

        # --- twisted density recons: x, y, z ---
        area_x = area_y = None
        if ut == "tanh":
            T = lambda a: torch.as_tensor(a, dtype=dens.dtype,
                                          device=dens.device)
            area_x = g.area_nm11_t[:, :, None, None]
            area_y = T(g.d_area_nm11_y())[:, :, None, None]
        dl, dr = _edge_recon_h(dens0, tb, AXX, rt)
        densrecon0 = _upwind_h(dl, dr, F[0][None], AXX, ut, cf, area_x)
        db_, dt_ = _edge_recon_h(dens0, tb, AXY, rt)
        densrecon1 = _upwind_h(db_, dt_, F[1][None], AXY, ut, cf, area_y)
        he0 = 0.5 * (rho0 + rx(rho0, -1))
        he1 = 0.5 * (rho0 + ry(rho0, -1))
        if self.ref_rho_pi is not None:
            ref_pi = (self.ref_rho_pi[None, :, :, None, None] *
                      self.ref_q_pi[:, :, :, None, None])
            densrecon0 = densrecon0 + ref_pi
            densrecon1 = densrecon1 + ref_pi
        densrecon0 = densrecon0 / he0[None]
        densrecon1 = densrecon1 / he1[None]

        # --- twisted vertical density recon ---
        db, dt2 = _edge_recon_z(mirror_iface(dens0, hs), tb, g.nz, rt,
                                per_level=self.vert_per_level())
        fw_int = FW[None, :, 1:-1, :, :]
        if ut == "tanh":
            p = torch.tanh((fw_int / g.d_area_n0()) * cf)
            vert_int = 0.5 * (dt2[..., :-1, :, :] * (1 + p) +
                              db[..., 1:, :, :] * (1 - p))
        else:
            vert_int = torch.where(fw_int >= 0, dt2[..., :-1, :, :],
                                   db[..., 1:, :, :])
        densvertrecon = torch.cat([_zs(db, 0, 1), vert_int,
                                   dt2[..., -1:, :, :]], dim=AXZ)
        rho0_pad = mirror_layer(rho0, 1)
        hew = 0.5 * (rho0_pad[..., 1:, :, :] + rho0_pad[..., :-1, :, :])
        if self.ref_rho_di is not None:
            densvertrecon = densvertrecon + (
                self.ref_rho_di[None, :, :, None, None] *
                self.ref_q_di[:, :, :, None, None])
        densvertrecon = densvertrecon / hew[None]

        # --- qhz recons (straight_hz: dof0 along x upwind by FTW0, dof1
        # along y by FTW1; the stencil for primal layer k is centred at
        # interface k+1, recon.h:185-197) ---
        ql_, qr_ = _edge_recon_h(_zs(qhz[0], 1, g.nz), tb, AXX)
        qhzrecon0 = torch.where(FTW[0] >= 0, qr_, rx(ql_, 1))
        qb_, qt_ = _edge_recon_h(_zs(qhz[1], 1, g.nz), tb, AXY)
        qhzrecon1 = torch.where(FTW[1] >= 0, qt_, ry(qb_, 1))

        # --- qhz vertical recons at v-points (straight_hz_vert: upwind
        # flux -FT0 for dof0, +FT1 for dof1; recon.h:236-240) ---
        def vert_q(qc, flux):
            q_pad = _zs(mirror_iface(qc, hs), 1, g.nz + 2 * hs)
            qb2, qt2 = _edge_recon_z(q_pad, tb, g.nz - 1,
                                     per_level=self.vert_per_level_q())
            cand0 = _zs(mirror_layer(qt2, 1), 0, g.nz)
            cand1 = torch.cat([qb2, qb2[..., -1:, :, :]], dim=AXZ)
            return torch.where(flux >= 0, cand0, cand1)

        qhzvertrecon0 = vert_q(qhz[0], -FT[0])
        qhzvertrecon1 = vert_q(qhz[1], FT[1])

        # --- qxy recon (straight_recon per level: d=1 along x upwind by
        # +FTxy1, d=0 along y by -FTxy0, recon.h:444-462) ---
        xl, xr = _edge_recon_h(qxy, tb, AXX)
        qxyrecon1 = torch.where(FTxy[1] >= 0, xr, rx(xl, 1))
        yl, yr = _edge_recon_h(qxy, tb, AXY)
        qxyrecon0 = torch.where(-FTxy[0] >= 0, yr, ry(yl, 1))

        return ((densrecon0, densrecon1), densvertrecon,
                (qhzrecon0, qhzrecon1), (qhzvertrecon0, qhzvertrecon1),
                (qxyrecon0, qxyrecon1))

    # ------------------------------------------------------------------
    def fct(self, dens, densrecon, densvertrecon, F, FW, dt):
        """Zalesak FCT limiting of the positive densities with 3-D fluxes
        (extrudedmodel.h:2331-2392 + operators/fct.h, ndims=2). A
        contiguous tail of positive rows is limited on its slice alone,
        as in the slab."""
        pos_list = [bool(p) for p in self.varset.dens_pos]
        densrecon0, densrecon1 = densrecon
        if not any(pos_list):
            return densrecon, densvertrecon
        k0 = pos_list.index(True)
        if all(pos_list[k0:]):
            (dr0, dr1), dvr = self._fct_all_pos(
                dens[k0:], (densrecon0[k0:], densrecon1[k0:]),
                densvertrecon[k0:], F, FW, dt)
            if k0 == 0:
                return (dr0, dr1), dvr
            return ((torch.cat([densrecon0[:k0], dr0], dim=0),
                     torch.cat([densrecon1[:k0], dr1], dim=0)),
                    torch.cat([densvertrecon[:k0], dvr], dim=0))
        pos = torch.as_tensor(self.varset.dens_pos,
                              device=dens.device)[:, None, None, None, None]
        (dr0, dr1), dvr = self._fct_all_pos(
            dens, (densrecon0, densrecon1), densvertrecon, F, FW, dt)
        return ((torch.where(pos, dr0, densrecon0),
                 torch.where(pos, dr1, densrecon1)),
                torch.where(pos, dvr, densvertrecon))

    def _fct_all_pos(self, dens, densrecon, densvertrecon, F, FW, dt):
        """fct() limiter body over every row of the given stack (strict
        > 0 upwinding, fct.h:190-210)."""
        densrecon0, densrecon1 = densrecon
        ef0 = densrecon0 * F[0][None]
        ef1 = densrecon1 * F[1][None]
        vef = densvertrecon * FW[None]
        eps = 1.0e-8
        out_x = torch.clamp(rx(ef0, 1), min=0.0) - torch.clamp(ef0, max=0.0)
        out_y = torch.clamp(ry(ef1, 1), min=0.0) - torch.clamp(ef1, max=0.0)
        out_z = torch.clamp(vef[..., 1:, :, :], min=0.0) - \
            torch.clamp(vef[..., :-1, :, :], max=0.0)
        Mf = (out_x + out_y + out_z) * dt + eps
        ratio = torch.clamp(dens / Mf, max=1.0)
        phi_x = torch.where(ef0 > 0, rx(ratio, -1), ratio)
        phi_y = torch.where(ef1 > 0, ry(ratio, -1), ratio)
        vf = vef[..., 1:-1, :, :]
        phi_z = torch.where(vf > 0, ratio[..., :-1, :, :], ratio[..., 1:, :, :])
        ones = torch.ones_like(_zs(densvertrecon, 0, 1))
        phi_z_full = torch.cat([ones, phi_z, ones], dim=AXZ)
        return ((densrecon0 * phi_x, densrecon1 * phi_y),
                densvertrecon * phi_z_full)

    # ------------------------------------------------------------------
    @staticmethod
    def _Qhz_w(qr, qvr, F, Fp, qvrp, sgn):
        """Qxz_w_EC (sgn -1 for ndims=2, wedge.h:154-230) / Qyz_w_EC (+1,
        wedge.h:313-408): PV flux onto w-points, with Fp, qvrp the flux
        and the vertical recon shifted by +1 along the direction."""
        mid = _zs(qr, 1, -1)
        t = (_zs(F, 1, -2) * (_zs(qvr, 1, -2) + mid) +
             _zs(Fp, 1, -2) * (_zs(qvrp, 1, -2) + mid) +
             _zs(F, 2, -1) * (_zs(qvr, 2, -1) + mid) +
             _zs(Fp, 2, -1) * (_zs(qvrp, 2, -1) + mid))
        interior = sgn * 0.125 * t
        bot = sgn * 0.125 * (
            _zs(F, 1, 2) * (_zs(qvr, 1, 2) + _zs(qr, 0, 1)) +
            _zs(Fp, 1, 2) * (_zs(qvrp, 1, 2) + _zs(qr, 0, 1)))
        top = sgn * 0.125 * (
            _zs(F, -2, -1) * (_zs(qvr, -2, -1) + qr[..., -1:, :, :]) +
            _zs(Fp, -2, -1) * (_zs(qvrp, -2, -1) + qr[..., -1:, :, :]))
        return torch.cat([bot, interior, top], dim=AXZ)

    def _Qxz_w(self, qr, qvr, F0, sgn):
        return self._Qhz_w(qr, qvr, F0, rx(F0, 1), rx(qvr, 1), sgn)

    def _Qyz_w(self, qr, qvr, F1):
        return self._Qhz_w(qr, qvr, F1, ry(F1, 1), ry(qvr, 1), 1.0)

    def _Qhz_u(self, qr_pad, qvr, FW, axis, sgn):
        """Qxz_u_EC (axis x, sgn +1 for ndims=2, wedge.h:506) / Qyz_v_EC
        (axis y, sgn -1, wedge.h:635): PV flux onto v-points."""
        FWm = comm.proll(FW, -1, axis=axis)
        qrm = comm.proll(qr_pad, -1, axis=axis)
        mid = _zs(qvr, 1, -1)
        t = (_zs(FW, 1, -2) * (_zs(qr_pad, 1, -2) + mid) +
             _zs(FWm, 1, -2) * (_zs(qrm, 1, -2) + mid) +
             _zs(FW, 2, -1) * (_zs(qr_pad, 2, -1) + mid) +
             _zs(FWm, 2, -1) * (_zs(qrm, 2, -1) + mid))
        interior = sgn * 0.125 * t
        bot = sgn * 0.5 * (_zs(FW, 0, 1) + _zs(FWm, 0, 1)) * _zs(qvr, 0, 1)
        top = sgn * 0.5 * (FW[..., -1:, :, :] + FWm[..., -1:, :, :]) * \
            qvr[..., -1:, :, :]
        return torch.cat([bot, interior, top], dim=AXZ)

    def _Q_EC_xy(self, r0, r1, F):
        """Horizontal EC PV flux per level (wedge.h Q2D / compute_Q_EC)."""
        f0s = F[1] + rx(F[1], -1) + ry(F[1], 1) + rx(ry(F[1], 1), -1)
        vel0 = -0.125 * (F[1] * r1 + rx(F[1], -1) * rx(r1, -1) +
                         ry(F[1], 1) * ry(r1, 1) +
                         rx(ry(F[1], 1), -1) * rx(ry(r1, 1), -1) +
                         f0s * r0)
        f1s = F[0] + rx(F[0], 1) + ry(F[0], -1) + rx(ry(F[0], -1), 1)
        vel1 = 0.125 * (F[0] * r0 + rx(F[0], 1) * rx(r0, 1) +
                        ry(F[0], -1) * ry(r0, -1) +
                        rx(ry(F[0], -1), 1) * rx(ry(r0, -1), 1) +
                        f1s * r1)
        return vel0, vel1

    # ------------------------------------------------------------------
    def tendencies_final(self, densrecon, densvertrecon, qhzrecon,
                         qhzvertrecon, qxyrecon, B, F, FW):
        """Assemble -d(dens, v, w)/dt (compute_tendencies,
        extrudedmodel.h:1645-1921, ndims=2 branches)."""
        nact = self.varset.ndensity_active
        densrecon0, densrecon1 = densrecon
        qr0, qr1 = qhzrecon
        qvr0, qvr1 = qhzvertrecon
        # Wtend (w-points, primal layers)
        dBz = B[:, :, 1:, :, :] - B[:, :, :-1, :, :]
        wtend = torch.einsum('lekyx,lekyx->ekyx',
                             densvertrecon[:nact, :, 1:-1, :, :], dBz)
        if self.force_refstate_hydrostatic_balance:
            dB_ref = self.ref_B[:, :, 1:] - self.ref_B[:, :, :-1]
            wtend = wtend + torch.einsum(
                'lek,lek->ek', self.ref_q_di[:nact, :, 1:-1],
                dB_ref)[..., None, None]
        wtend = wtend + self._Qxz_w(qr0, qvr0, F[0], -1.0)  # ndims=2: -1
        wtend = wtend + self._Qyz_w(qr1, qvr1, F[1])
        # Vtend x and y components
        vtend0 = torch.einsum('lekyx,lekyx->ekyx', densrecon0[:nact],
                              B - rx(B, -1))
        vtend0 = vtend0 + self._Qhz_u(mirror_layer(qr0, 1), qvr0, FW, AXX,
                                      1.0)                  # ndims=2: +1
        vtend1 = torch.einsum('lekyx,lekyx->ekyx', densrecon1[:nact],
                              B - ry(B, -1))
        vtend1 = vtend1 + self._Qhz_u(mirror_layer(qr1, 1), qvr1, FW, AXY,
                                      -1.0)                 # Qyz_v: -1
        # horizontal (xy) PV flux per level
        qv0, qv1 = self._Q_EC_xy(qxyrecon[0], qxyrecon[1], F)
        vtend = torch.stack([vtend0 + qv0, vtend1 + qv1])
        # dens tendencies (wDnm1bar + vert)
        fx = densrecon0 * F[0][None]
        fy = densrecon1 * F[1][None]
        fz = densvertrecon * FW[None]
        denstend = (rx(fx, 1) - fx) + (ry(fy, 1) - fy) + \
            (fz[..., 1:, :, :] - fz[..., :-1, :, :])
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def apply_symplectic(self, dens, v, w, F, FW, B, dt, F_recon=None,
                         FW_recon=None):
        """(extrudedmodel.h apply_symplectic:2173-2486, ndims=2).
        F_recon/FW_recon: the midpoint mass fluxes that set the tangent
        fluxes and the recon upwinding inside the SI iterations
        (needs_to_recompute_F, :2188-2204); FCT and the final tendencies
        keep F/FW."""
        if F_recon is None:
            F_recon, FW_recon = F, FW
        FT, FTW, FTxy = self.tangent_fluxes(F_recon, FW_recon)
        qhz, qxy = self.q_and_f(dens, v, w)
        densrecon, densvertrecon, qhzrecon, qhzvertrecon, qxyrecon = \
            self.recons(dens, qhz, qxy, F_recon, FW_recon, FT, FTW, FTxy)
        densrecon, densvertrecon = self.fct(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return self.tendencies_final(densrecon, densvertrecon, qhzrecon,
                                     qhzvertrecon, qxyrecon, B, F, FW)

    def compute_rhs(self, dens, v, w, geop, dt):
        """(Fdens, Fv, Fw) with d(dens, v, w)/dt = -(Fdens, Fv, Fw)."""
        F, FW, K, B = self.functional_derivatives(dens, v, w, geop)
        return self.apply_symplectic(dens, v, w, F, FW, B, dt)

    # ------------------------------------------------------------------
    def energy(self, dens, v, w, geop):
        """(KE+PE+IE, KE, PE, IE) per ensemble member."""
        vs, th = self.varset, self.thermo
        axes = (-3, -2, -1)
        rho_n = vs.get_total_density(dens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        IE = comm.psum_h(rho_n * th.compute_U(alpha, sv, qd, qv, ql, qi),
                         axes)
        PE = comm.psum_h(rho_n * self.Hn1bar(geop), axes)
        _, _, K, _ = self.functional_derivatives(dens, v, w, geop)
        KE = comm.psum_h(self.Hn1bar(rho_n) * K, axes)
        return KE + PE + IE, KE, PE, IE

    def statistics(self, dens, v, w, geop):
        """Conservation statistics per member: density sums, minima and
        maxima (ndens, nens), energies, and the three PV components
        (3, nens) (ModelStats::compute, ndims=2, extrudedmodel.h:4621)."""
        axes = (-3, -2, -1)
        E, KE, PE, IE = self.energy(dens, v, w, geop)
        qhz, qxy = self.q_and_f(dens, v, w)
        rho_n = self.varset.get_total_density(dens)
        interior = _interior_rows(qhz.shape[AXZ], qhz.device)
        zero = torch.zeros_like(qhz[0])
        pv_xz = comm.psum_h(torch.where(
            interior, qhz[0] * self._R_avg_h(rho_n, AXX), zero), axes)
        pv_yz = comm.psum_h(torch.where(
            interior, qhz[1] * self._R_avg_h(rho_n, AXY), zero), axes)
        pv_xy = comm.psum_h(qxy * self._hvxy(rho_n), axes)
        return dict(densstat=comm.psum_h(dens, axes),
                    densmin=comm.pmin_h(dens, axes),
                    densmax=comm.pmax_h(dens, axes),
                    E=E, KE=KE, PE=PE, IE=IE,
                    PV=torch.stack([pv_xz, pv_yz, pv_xy]))

    def ssprk3_step(self, dens, v, w, geop, dt):
        """(SSPRK.h:60-78)."""
        return timesteppers.ssprk3_step(
            lambda x: self.compute_rhs(*x, geop, dt), (dens, v, w), dt)

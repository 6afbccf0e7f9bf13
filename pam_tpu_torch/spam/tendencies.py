"""SPAM extruded-model tendencies: the apply_symplectic pipeline, the
energies, statistics and the SSPRK3 step (port of
pam_tpu/spam/tendencies.py; ref dynamics/spam/src/models/extrudedmodel.h,
ndims=1, the CE and MCE_rho variants, WENOFUNC order-5 reconstructions,
HEAVISIDE or TANH upwinding, energy-conserving PV fluxes, Zalesak FCT for
positive densities, optional diffusion; the compile-time defaults are
src/common.h:62-126).

The limited WENO edge reconstructions go to hand-written CUDA kernels for
CUDA tensors, along x to ops/weno_x.py and along z to ops/weno_z.py;
everything else is plain torch.
x is uniform; a stretched vertical grid reconstructs in z with per-level
matrices (weno_func_recon_variable.h), built once per tendencies object
in the run's dtype and device. Diffusion is off unless a coefficient is
positive (extrudedmodel.h:5020-5078); the horizontal Hodge stars are of
order diff_ord (2, 4 or 6; 2 is the compile default, common.h:64-65).

Sign convention: compute_rhs returns F with dx/dt = -F (SSPRK.h:63-78).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import recon_matrices as rm
from ..ops import weno, weno_x, weno_z
from ..parallel import comm
from ..parallel.mesh import per_member
from . import diffusion
from . import operators as op
from . import timesteppers
from .operators import AXZ, mirror_iface, mirror_layer, rollm


def _edge_recon_x(field, tables, recon_type: str = "wenofunc"):
    """(left_edge, right_edge) of each cell along periodic x.
    field: (..., nens, nlev, nx). "wenofunc"/"weno" is the limited
    reconstruction (the CUDA kernel on the GPU), "cfv" the centered one
    without limiting (RECONSTRUCTION_TYPE, common.h:72-88)."""
    if recon_type == "cfv":
        s2c, c2g = tables[0], tables[4]
        ord = s2c.shape[-1]
        nx = field.shape[-1]
        pad = comm.halo_pad(field, (ord - 1) // 2)
        aw = weno.cfv_coefs_list([pad[..., s:s + nx] for s in range(ord)],
                                 s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    return weno_x.weno_edges_x(field, tables)


def _edge_recon_z(field_padded, tables, nlev, recon_type: str = "wenofunc",
                  per_level=None, packed=None):
    """(bottom_edge, top_edge) of cells 0..nlev-1 from a z-padded array
    (hs on each side). per_level: optional (s2c, wrl) per-level matrices
    of a stretched grid with leading matrix dims and trailing (nens, nlev,
    1) dims (SpamTendencies.vert_per_level), in place of the uniform
    tables' (pam_tpu/spam/tendencies.py:61-88); packed: the same matrices
    as the CUDA kernel reads them (weno_z.pack_level_matrices). The
    limited reconstruction of a CUDA tensor is the kernel
    (ops/weno_z.py)."""
    if recon_type == "cfv":
        s2c, c2g = tables[0], tables[4]
        ord = s2c.shape[-1]
        sten = [field_padded[..., s:s + nlev, :] for s in range(ord)]
        if per_level is not None:
            s2c = per_level[0]
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    return weno_z.weno_edges_z(field_padded, tables, nlev, per_level, packed)


def _upwind_x(left, right, flux, utype: str = "heaviside",
              coeff: float = 250.0, area=None):
    """Twisted x recon at edge i. HEAVISIDE: flux >= 0 takes the right
    edge of cell i-1, else the left edge of cell i (recon.h upwind_recon;
    copysign(1, 0) = +1, so ties go to cell i-1). TANH: the blend with
    tanh(flux / area * coeff) (recon.h tanh_upwind_recon:326-340, the flux
    de-areaed at :380-385)."""
    cand_L = rollm(right, -1)
    if utype == "tanh":
        p = torch.tanh((flux / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + left * (1 - p))
    return torch.where(flux >= 0, cand_L, left)


def _upwind_z(bottom, top, flux_int, utype: str = "heaviside",
              coeff: float = 250.0, area=None):
    """Twisted z recon at interior interfaces k=1..nlev-1: flux >= 0 takes
    the top edge of cell k-1, else the bottom of cell k (TANH: the blend,
    as in _upwind_x)."""
    cand_L, cand_R = top[..., :-1, :], bottom[..., 1:, :]
    if utype == "tanh":
        p = torch.tanh((flux_int / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + cand_R * (1 - p))
    return torch.where(flux_int >= 0, cand_L, cand_R)


def level_matrices(geom, dz, ord: int, nh: int = 1):
    """mirror_recon_matrices of every member's column of thicknesses dz
    (nens, nlev) (interface mirror rule), as tensors in the geometry's
    dtype and device with the matrix dims leading and (nens, nlev) plus
    nh horizontal unit dims trailing (1 in the slab, 2 in 3-D); members
    with the same column share one build."""
    cols, inv = np.unique(dz, axis=0, return_inverse=True)
    s2c, wrl = rm.mirror_recon_matrices(cols, ord, iface=True)

    def to(a, nmat):
        a = np.moveaxis(a[inv.reshape(-1)], tuple(range(2, 2 + nmat)),
                        tuple(range(nmat)))
        return torch.as_tensor(a[(Ellipsis,) + (None,) * nh],
                               dtype=geom.dtype, device=geom.device)
    return to(s2c, 2), to(wrl, 3)


def packed_level_matrices(geom, dz):
    """The order-5 level matrices of :func:`level_matrices` as
    ``csrc/weno_z.cu`` reads them: (nens, nlev, weno_z.NMAT) in the
    geometry's dtype and device, or (1, nlev, NMAT) where every member
    has the same column of thicknesses dz (nens, nlev)."""
    cols, inv = np.unique(dz, axis=0, return_inverse=True)
    s2c, wrl = rm.mirror_recon_matrices(cols, weno_z.ORD, iface=True)
    if len(cols) > 1:
        s2c, wrl = s2c[inv.reshape(-1)], wrl[inv.reshape(-1)]
    return weno_z.pack_level_matrices(s2c, wrl, geom.dtype, geom.device)


@dataclasses.dataclass(frozen=True, eq=False)
class SpamTendencies:
    """Static config + reference-state tensors of the extruded CE / MCE
    model."""
    geom: Any
    varset: Any
    thermo: Any
    grav: float = 9.80616
    ord: int = 5
    force_refstate_hydrostatic_balance: bool = False
    # numerics knobs (compile-time in the reference, common.h:72-111)
    reconstruction_type: str = "wenofunc"   # "wenofunc"|"weno"|"cfv"
    diff_ord: int = 2                       # horizontal Hodge order 2|4|6
    dual_upwind_type: str = "heaviside"     # "heaviside"|"tanh"
    tanh_upwind_coeff: float = 250.0        # params.h:159
    # diffusion coefficients (extrudedmodel.h:207-212; 0 = off)
    scalar_horiz_diffusion_coeff: float = 0.0
    scalar_vert_diffusion_coeff: float = 0.0
    velocity_vort_horiz_diffusion_coeff: float = 0.0
    velocity_vort_vert_diffusion_coeff: float = 0.0
    velocity_div_horiz_diffusion_coeff: float = 0.0
    velocity_div_vert_diffusion_coeff: float = 0.0
    # reference state columns (None -> zeros), run dtype/device
    # (ndens, nens, nz)   dual layers
    refdens: Any = per_member(1, default=None)
    # (ndens, nens, nz)   at v-levels
    ref_q_pi: Any = per_member(1, default=None)
    ref_rho_pi: Any = per_member(0, default=None)  # (nens, nz)
    # (ndens, nens, nz+1) at dual interfaces
    ref_q_di: Any = per_member(1, default=None)
    ref_rho_di: Any = per_member(0, default=None)  # (nens, nz+1)
    ref_B: Any = per_member(1, default=None)  # (nactive, nens, nz)
    # per-level z matrices of a stretched grid (None on a uniform one),
    # built by __post_init__ and carried along by dataclasses.replace
    # dual layers, thickness dz_d
    per_level_d: Any = per_member(-3, default=None)
    # primal layers, thickness dz_p
    per_level_q: Any = per_member(-3, default=None)
    # the same, packed as the CUDA kernel reads them (packed_level_matrices;
    # order 5 on a CUDA device only): (nens or 1, nlev, weno_z.NMAT)
    packed_d: Any = per_member(0, default=None)
    packed_q: Any = per_member(0, default=None)

    def __post_init__(self):
        if not self.geom.uniform_vertical and self.per_level_d is None:
            object.__setattr__(self, "per_level_d",
                               self._level_matrices(self.geom.dz_d))
            object.__setattr__(self, "per_level_q",
                               self._level_matrices(self.geom.dz_p))
            if (self.ord == weno_z.ORD
                    and self.geom.device.type == "cuda"):
                object.__setattr__(self, "packed_d",
                                   packed_level_matrices(self.geom,
                                                         self.geom.dz_d))
                object.__setattr__(self, "packed_q",
                                   packed_level_matrices(self.geom,
                                                         self.geom.dz_p))

    def _level_matrices(self, dz):
        return level_matrices(self.geom, dz, self.ord)

    def vert_per_level(self):
        """Per-level matrices of the density (dual layer) vertical recon;
        None on a uniform grid (pam_tpu/spam/tendencies.py:151-164)."""
        return self.per_level_d

    def vert_per_level_q(self):
        """Per-level matrices of the qhz vertical recon (primal layers,
        thickness dz_p); None on a uniform grid."""
        return self.per_level_q

    def tables(self):
        return weno.weno_tables(self.ord, self.geom.dtype)

    @property
    def hs(self):
        return (self.ord - 1) // 2

    # ------------------------------------------------------------------
    def functional_derivatives(self, dens, v, w, geop):
        """F, FW, K, B (compute_functional_derivatives,
        extrudedmodel.h:1996-2084; kinetic_energy.h:306-395)."""
        g, vs, th = self.geom, self.varset, self.thermo
        rho_n = vs.get_total_density(dens)
        rho0 = op.Hn1bar_ho(rho_n, g, self.diff_ord)
        he = op.phi_x(rho0)
        hew = op.phi_z_iface(mirror_layer(rho0, 1))
        u = op.H10_ho(v, g, self.diff_ord)
        uw = op.H01(w, g)
        F = he * u
        FW = hew * uw
        # kinetic energy per dual cell (kinetic_energy.h:383-394)
        Kh = 0.5 * (v * u + rollm(v, 1) * rollm(u, 1))
        w_pad = mirror_layer(w, 1)
        Kv = 0.5 * (w_pad[..., :-1, :] * uw[..., :-1, :] +
                    w_pad[..., 1:, :] * uw[..., 1:, :])
        K = 0.5 * (Kh + Kv)
        # B (Hs.compute_dHsdx + Hk.compute_dKddens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        geop0 = op.Hn1bar(geop, g)
        U = th.compute_U(alpha, sv, qd, qv, ql, qi)
        p = -th.compute_dUdalpha(alpha, sv, qd, qv, ql, qi)
        gExner = th.compute_dUdentropic_var(alpha, sv, qd, qv, ql, qi)
        B_mass = geop0 + U + p * alpha - sv * gExner
        if vs.variant != "CE":
            mu_d, mu_v, mu_l, mu_i = th.compute_dUdq(alpha, sv, qd, qv, ql,
                                                     qi)
            B_mass = B_mass + qv * (mu_d - mu_v) + ql * (mu_d - mu_l) + \
                qi * (mu_d - mu_i)
        B_mass = B_mass + op.Hn1bar(K, g)
        B = torch.stack([B_mass, gExner])
        return F, FW, K, B

    # ------------------------------------------------------------------
    def q_and_f(self, dens, v, w):
        """Relative PV at dual vertices (compute_q_and_f,
        extrudedmodel.h:543-589); zero boundary rows (set_bnd, :2226)."""
        hv = op.R_avg(self.varset.get_total_density(dens))
        zeta = op.D1_ext(v, mirror_layer(w, 1))
        nz1 = zeta.shape[AXZ]
        k = torch.arange(nz1, device=zeta.device)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None]
        hv_safe = torch.where(hv == 0, torch.ones_like(hv), hv)
        return torch.where(interior, zeta / hv_safe, torch.zeros_like(zeta))

    # ------------------------------------------------------------------
    def recons(self, dens, qhz, F, FW, FT, FTW):
        """Upwinded WENO reconstructions of densities and PV
        (compute_edge_reconstructions_uniform + compute_recons,
        extrudedmodel.h:591-711, 1000-1174)."""
        g, vs = self.geom, self.varset
        tb = self.tables()
        hs = self.hs
        ho = self.diff_ord
        rho0 = op.Hn1bar_ho(vs.get_total_density(dens), g, ho)
        # dens0 = (dens - refdens)/area  (compute_dens0, :379-417)
        if self.refdens is not None:
            dens0 = op.Hn1bar_ho(dens - self.refdens[:, :, :, None], g, ho)
        else:
            dens0 = op.Hn1bar_ho(dens, g, ho)

        # horizontal density recon at x-edges of dual cells
        dl, dr = _edge_recon_x(dens0, tb, self.reconstruction_type)
        densrecon = _upwind_x(dl, dr, F[None], self.dual_upwind_type,
                              self.tanh_upwind_coeff,
                              g.area_nm11_t[:, :, None])
        he = op.phi_x(rho0)
        if self.ref_rho_pi is not None:
            densrecon = densrecon + (self.ref_rho_pi[None, :, :, None] *
                                     self.ref_q_pi[:, :, :, None])
        densrecon = densrecon / he[None]

        # vertical density recon at dual interfaces
        db, dt_ = _edge_recon_z(mirror_iface(dens0, hs), tb, g.nz,
                                self.reconstruction_type,
                                per_level=self.vert_per_level(),
                                packed=self.packed_d)
        vert_int = _upwind_z(db, dt_, FW[None, :, 1:-1, :],
                             self.dual_upwind_type, self.tanh_upwind_coeff,
                             g.d_area_n0())
        # boundary rows: one-sided edge values (multiplied by FW=0 anyway)
        densvertrecon = torch.cat(
            [db[..., :1, :], vert_int, dt_[..., -1:, :]], dim=AXZ)
        hew = op.phi_z_iface(mirror_layer(rho0, 1))
        if self.ref_rho_di is not None:
            densvertrecon = densvertrecon + (
                self.ref_rho_di[None, :, :, None] *
                self.ref_q_di[:, :, :, None])
        densvertrecon = densvertrecon / hew[None]

        # qhz recons: the stencil for primal layer k is centred at
        # interface k+1 (recon.h:185-197, 236-240)
        ql_, qr_ = _edge_recon_x(qhz[..., 1:g.nz, :], tb)
        qhzrecon = torch.where(FTW >= 0, qr_, rollm(ql_, 1))
        qhz_pad = mirror_iface(qhz, hs)[..., 1:g.nz + 2 * hs, :]
        qb, qt = _edge_recon_z(qhz_pad, tb, g.nz - 1,
                               per_level=self.vert_per_level_q(),
                               packed=self.packed_q)
        # straight vert recon at v-level kv from primal-layer cells kv-1
        # (top) and kv (bottom), upwinded by -FT (recon.h:581-585)
        cand0 = mirror_layer(qt, 1)[..., :g.nz, :]
        cand1 = torch.cat([qb, qb[..., -1:, :]], dim=AXZ)
        qhzvertrecon = torch.where(-FT >= 0, cand0, cand1)
        return densrecon, densvertrecon, qhzrecon, qhzvertrecon

    # ------------------------------------------------------------------
    def fct(self, dens, densrecon, densvertrecon, F, FW, dt):
        """Zalesak FCT limiting of the positive-density reconstructions
        (extrudedmodel.h:2331-2392 + operators/fct.h). A contiguous tail
        of positive rows is limited on its slice alone (pam_tpu's
        dead-row elimination; the same arithmetic on the same rows)."""
        pos_list = [bool(p) for p in self.varset.dens_pos]
        if not any(pos_list):
            return densrecon, densvertrecon
        k0 = pos_list.index(True)
        if all(pos_list[k0:]):
            dr_t, dvr_t = self._fct_all_pos(dens[k0:], densrecon[k0:],
                                            densvertrecon[k0:], F, FW, dt)
            if k0 == 0:
                return dr_t, dvr_t
            return (torch.cat([densrecon[:k0], dr_t], dim=0),
                    torch.cat([densvertrecon[:k0], dvr_t], dim=0))
        pos = torch.as_tensor(self.varset.dens_pos,
                              device=dens.device)[:, None, None, None]
        dr_all, dvr_all = self._fct_all_pos(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return (torch.where(pos, dr_all, densrecon),
                torch.where(pos, dvr_all, densvertrecon))

    def _fct_all_pos(self, dens, densrecon, densvertrecon, F, FW, dt):
        """fct() limiter body over every row of the given stack."""
        edgeflux = densrecon * F[None]
        vertedgeflux = densvertrecon * FW[None]
        eps = 1.0e-8
        out_x = torch.clamp(rollm(edgeflux, 1), min=0.0) - \
            torch.clamp(edgeflux, max=0.0)
        out_z = torch.clamp(vertedgeflux[..., 1:, :], min=0.0) - \
            torch.clamp(vertedgeflux[..., :-1, :], max=0.0)
        Mf = (out_x + out_z) * dt + eps
        # Phi at x-edges: upwind cell i-1 if edgeflux > 0 else i
        # (fct.h:190-210; strict >, unlike the recon upwinding)
        ratio = torch.clamp(dens / Mf, max=1.0)
        phi_x_ = torch.where(edgeflux > 0, rollm(ratio, -1), ratio)
        densrecon = densrecon * phi_x_
        # Phivert at interior interfaces: upwind cell k-1 if > 0 else k
        vf = vertedgeflux[..., 1:-1, :]
        phi_z = torch.where(vf > 0, ratio[..., :-1, :], ratio[..., 1:, :])
        ones = torch.ones_like(densvertrecon[..., :1, :])
        phi_z_full = torch.cat([ones, phi_z, ones], dim=AXZ)
        return densrecon, densvertrecon * phi_z_full

    # ------------------------------------------------------------------
    def tendencies_final(self, densrecon, densvertrecon, qhzrecon,
                         qhzvertrecon, B, F, FW):
        """Assemble -dx/dt (compute_tendencies, extrudedmodel.h:1645-1921)."""
        nact = self.varset.ndensity_active  # active ids are 0..nact-1
        dBz = B[:, :, 1:, :] - B[:, :, :-1, :]
        wtend = torch.einsum('lekx,lekx->ekx',
                             densvertrecon[:nact, :, 1:-1, :], dBz)
        if self.force_refstate_hydrostatic_balance:
            # + wD0_vert(ref q_di, ref B) (extrudedmodel.h:1684-1688)
            dB_ref = self.ref_B[:, :, 1:] - self.ref_B[:, :, :-1]
            wtend = wtend + torch.einsum(
                'lek,lek->ek', self.ref_q_di[:nact, :, 1:-1],
                dB_ref)[..., None]
        wtend = wtend + op.Qxz_w(qhzrecon, qhzvertrecon, F)
        dBx = B - rollm(B, -1)                      # B[i]-B[i-1]
        vtend = torch.einsum('lekx,lekx->ekx', densrecon[:nact], dBx)
        vtend = vtend + op.Qxz_u(mirror_layer(qhzrecon, 1), qhzvertrecon, FW)
        denstend = op.Dnm1bar_x(F[None], densrecon) + \
            op.Dnm1bar_vert(FW[None], densvertrecon)
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def apply_symplectic(self, dens, v, w, F, FW, B, dt, F_recon=None,
                         FW_recon=None):
        """Symplectic tendency assembly (extrudedmodel.h apply_symplectic:
        2173-2486). F_recon/FW_recon are the midpoint mass fluxes that set
        the FT/FTW wedges and the recon upwinding inside the SI iterations
        (needs_to_recompute_F, :2188-2204); FCT and the final tendencies
        keep F/FW."""
        if F_recon is None:
            F_recon, FW_recon = F, FW
        FT = op.Wxz_u(FW_recon)
        FTW = op.Wxz_w(F_recon)
        qhz = self.q_and_f(dens, v, w)
        densrecon, densvertrecon, qhzrecon, qhzvertrecon = \
            self.recons(dens, qhz, F_recon, FW_recon, FT, FTW)
        densrecon, densvertrecon = self.fct(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return self.tendencies_final(densrecon, densvertrecon, qhzrecon,
                                     qhzvertrecon, B, F, FW)

    def compute_rhs(self, dens, v, w, geop, dt):
        """fd + symplectic + diffusion where a coefficient is positive
        (model.h Tendencies::compute_rhs:275-284, the diffusion hooks
        extrudedmodel.h:2439-2484). Returns (Fdens, Fv, Fw) with
        d(dens, v, w)/dt = -(Fdens, Fv, Fw). Inside an SI step this is the
        first evaluation only: the quasi-Newton evaluations run
        apply_symplectic alone (si.py), so diffusion acts once a step."""
        F, FW, K, B = self.functional_derivatives(dens, v, w, geop)
        denstend, vtend, wtend = self.apply_symplectic(dens, v, w, F, FW, B,
                                                       dt)
        if (self.scalar_horiz_diffusion_coeff > 0 or
                self.scalar_vert_diffusion_coeff > 0):
            denstend = diffusion.scalar_diffusion(
                self, dens, denstend, self.scalar_horiz_diffusion_coeff,
                self.scalar_vert_diffusion_coeff)
        if (self.velocity_vort_horiz_diffusion_coeff > 0 or
                self.velocity_vort_vert_diffusion_coeff > 0 or
                self.velocity_div_horiz_diffusion_coeff > 0 or
                self.velocity_div_vert_diffusion_coeff > 0):
            vtend, wtend = diffusion.velocity_diffusion(
                self, v, w, vtend, wtend,
                self.velocity_vort_horiz_diffusion_coeff,
                self.velocity_vort_vert_diffusion_coeff,
                self.velocity_div_horiz_diffusion_coeff,
                self.velocity_div_vert_diffusion_coeff)
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def energy(self, dens, v, w, geop):
        """(total, kinetic, potential, internal) energy per member
        (ModelStats::compute, extrudedmodel.h:4599-4860)."""
        g, vs, th = self.geom, self.varset, self.thermo
        rho_n = vs.get_total_density(dens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        IE = comm.psum_h(rho_n * th.compute_U(alpha, sv, qd, qv, ql, qi),
                         (-2, -1))
        PE = comm.psum_h(rho_n * op.Hn1bar(geop, g), (-2, -1))
        _, _, K, _ = self.functional_derivatives(dens, v, w, geop)
        KE = comm.psum_h(op.Hn1bar(rho_n, g) * K, (-2, -1))
        return KE + PE + IE, KE, PE, IE

    def ssprk3_step(self, dens, v, w, geop, dt):
        """(SSPRK.h:60-78; x1 = x - dt F(x), etc.)."""
        return timesteppers.ssprk3_step(
            lambda x: self.compute_rhs(*x, geop, dt), (dens, v, w), dt)

    def statistics(self, dens, v, w, geop):
        """Conservation statistics per member (ModelStats::compute,
        extrudedmodel.h:4599-4860): density sums/min/max (ndens, nens),
        energies, total PV and potential enstrophy (nens,)."""
        E, KE, PE, IE = self.energy(dens, v, w, geop)
        densstat = comm.psum_h(dens, (-2, -1))
        densmin = comm.pmin_h(dens, (-2, -1))
        densmax = comm.pmax_h(dens, (-2, -1))
        hv = op.R_avg(self.varset.get_total_density(dens))
        zeta = op.D1_ext(v, mirror_layer(w, 1))
        nz1 = zeta.shape[AXZ]
        k = torch.arange(nz1, device=zeta.device)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None]
        zero = torch.zeros_like(zeta)
        pv = comm.psum_h(torch.where(interior, zeta, zero), (-2, -1))
        hv_safe = torch.where(hv == 0, torch.ones_like(hv), hv)
        pens = comm.psum_h(torch.where(interior, 0.5 * zeta * zeta / hv_safe,
                                       zero), (-2, -1))
        return dict(densstat=densstat, densmin=densmin, densmax=densmax,
                    E=E, KE=KE, PE=PE, IE=IE, PV=pv, PENS=pens)

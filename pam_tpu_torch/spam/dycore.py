"""SPAM dycore <-> coupler bridge ("PAM-C"), the x-z slab (ny == 1) and
the 3-D model (ny > 1, the reference's PAMC_NDIMS=2) (port of
pam_tpu/spam/dycore.py; ref dynamics/spam/Dycore.h init/timeStep and the
coupler conversions of hamiltonians/variableset.h:481-912, the averaging
path and the exact inverse of the wind averaging).

Steps are semi-implicit (with_si: the velocity linear system in the slab
by default, the pressure and pressure-gravity systems in either layout;
3-D takes pressure-gravity in place of the slab-only velocity system) or
explicit SSPRK3 substeps at the acoustic CFL.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..core.coupler import Coupler
from ..parallel import comm
from ..parallel.mesh import per_member
from . import si as si_mod
from . import extruded3d
from .extruded3d import Tendencies3D
from .geometry import ExtrudedGeometry
from .operators import mirror_layer, rollm
from .tendencies import SpamTendencies
from .thermo import ConstantKappaVirtualPottemp, ThermoConstants
from .varset import VariableSet


@functools.lru_cache(maxsize=None)
def _flags(flags: tuple, device) -> torch.Tensor:
    """A bool tensor of ``flags`` on ``device``, built once: a host copy
    inside the step would synchronise (and cannot be captured)."""
    return torch.as_tensor(flags, device=device)


def exact_inverse_avg(u, axis: int = -1):
    """v with v[i] + v[i+1] = 2 u[i], periodic along ``axis`` of odd extent
    (couple_wind_exact_inverse, variableset.h:807-846, in the closed form
    of pam_tpu/spam/dycore.py:26-54: the recurrence v[i] = 2 u[i-1] -
    v[i-1] is an alternating cumulative sum)."""
    if comm.sharded("x" if axis % u.ndim == u.ndim - 1 else "y"):
        # the alternating sum runs over the whole axis: a shard-local
        # inverse would be wrong at every shard boundary
        # (pam_tpu/spam/dycore.py:37-43)
        raise NotImplementedError(
            "couple_wind_exact_inverse needs its axis unsharded (a global "
            "alternating sum); use the averaging conversion under sharding")
    n = u.shape[axis]
    if n % 2 != 1:
        raise ValueError("couple_wind_exact_inverse requires an odd cell "
                         f"count (variableset.h:225-233), got {n}")
    um = u.movedim(axis, -1)
    sgn = torch.as_tensor(np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                          dtype=um.dtype, device=um.device)
    v0 = torch.sum(sgn * um, dim=-1, keepdim=True)
    # v[i] = (-1)^i (v0 + 2 sum_{j=1..i} (-1)^j u[j-1])
    t = -sgn[:-1] * um[..., :-1]
    c = torch.cat([torch.zeros_like(um[..., :1]), torch.cumsum(t, dim=-1)],
                  dim=-1)
    return (sgn * (v0 + 2.0 * c)).movedim(-1, axis)


def exact_inverse_w(wvel, dzp):
    """Exact inverse of the interface-weighted w interpolation
    (variableset.h:853-875): x[0] = wvel[0]; x[k] = (e_k + e_{k-1})/e_{k-1}
    wvel[k] - e_k/e_{k-1} x[k-1]. wvel (nens, nz, ...) cell-centre w, dzp
    (nens, nz-1, ...) interface weights e; returns (nens, nz-1, ...)."""
    nl = wvel.shape[1] - 1
    e = dzp.expand(wvel[:, :nl].shape)
    xs = [wvel[:, 0]]
    for k in range(1, nl):
        ek, ekm1 = e[:, k], e[:, k - 1]
        xs.append((ek + ekm1) / ekm1 * wvel[:, k] - ek / ekm1 * xs[-1])
    return torch.stack(xs, dim=1)


def thermo_constants_from_coupler(coupler: Coupler) -> ThermoConstants:
    """Coupler constants -> SPAM thermo constants, as
    CoupledTestCase::set_reference_state does (extrudedmodel.h:5812-5826);
    Lv0 is back-solved so that Lvr == latvap."""
    c = coupler.const
    cpv, cl = c.cp_v, c.cp_l
    return ThermoConstants(
        Rd=c.R_d, Rv=c.R_v, pr=c.p0, Cpd=c.cp_d, Cvd=c.cp_d - c.R_d,
        Cpv=cpv, Cvv=cpv - c.R_v, Cl=cl,
        Lv0=c.latvap - (cpv - cl) * ThermoConstants.Tr, Lfr=c.latice)


@dataclasses.dataclass(frozen=True, eq=False)
class SpamDycore:
    """Coupled SPAM dycore: MCE_rho + ConstantKappa_VirtualPottemp (the
    reference's coupled configuration), semi-implicit steps after with_si,
    explicit SSPRK3 substeps otherwise."""
    coupler: Coupler
    geom: ExtrudedGeometry
    varset: VariableSet
    thermo: Any
    tend: Any              # SpamTendencies (slab) or Tendencies3D
    geop: torch.Tensor = per_member(0)  # (nens, nz, [ny,] nx) n-form of g*z
    grav: float
    si_linsys: Any = None
    si_dt: float = None
    si_max_iters: int = 3
    si_nquad: int = 2
    # exact two-point discrete gradient (si_two_point_discrete_gradient,
    # params.h:158; off by default, as in the reference)
    si_two_point: bool = False
    # exact inversion of the edge-averaging wind conversion; needs an odd
    # nx (couple_wind_exact_inverse, variableset.h:225-233, 807-875)
    couple_wind_exact_inverse: bool = False

    name = "SPAM++"  # ref: Dycore.h:327

    @property
    def ndims(self):
        """Horizontal dims: 1 = x-z slab, 2 = 3-D (PAMC_NDIMS)."""
        return 2 if self.coupler.ny > 1 else 1

    @staticmethod
    def build(coupler: Coupler, zint, thermo, grav: float = 9.80616
              ) -> "SpamDycore":
        """x-z slab (ny == 1) or 3-D extruded model (ny > 1), variant
        MCE_rho (VariableSet's default is pam_tpu's, dry CE)."""
        c = coupler
        if c.ny > 1:
            geom = ExtrudedGeometry.build3d(c.nx, c.ny, np.asarray(zint),
                                            c.xlen, c.ylen, c.nens, c.dtype,
                                            c.device)
        else:
            geom = ExtrudedGeometry.build(c.nx, np.asarray(zint), c.xlen,
                                          c.nens, c.dtype, c.device)
        vs = VariableSet(variant="MCE_rho",
                         tracer_names=tuple(coupler.tracer_names),
                         tracer_positive=tuple(coupler.tracer_positive),
                         geom=geom, thermo=thermo)
        # geopotential as twisted n1-form: avg(g*z)*volume per dual cell
        geop_col = grav * geom.zmid_d * geom.dx * geom.dy * geom.dz_d
        if coupler.ny > 1:
            tend = Tendencies3D(geom=geom, varset=vs, thermo=thermo,
                                grav=grav)
            geop = np.broadcast_to(geop_col[:, :, None, None],
                                   (geom.nens, geom.nz, geom.ny, geom.nx))
        else:
            tend = SpamTendencies(geom=geom, varset=vs, thermo=thermo,
                                  grav=grav)
            geop = np.repeat(geop_col[:, :, None], geom.nx, axis=2)
        geop = torch.as_tensor(np.ascontiguousarray(geop),
                               dtype=coupler.dtype, device=coupler.device)
        return SpamDycore(coupler=coupler, geom=geom, varset=vs,
                          thermo=thermo, tend=tend, geop=geop, grav=grav)

    @staticmethod
    def build_coupled(coupler: Coupler, state, zint, dt_si,
                      si_max_iters: int = 3, si_nquad: int = 2,
                      linear_system: str = "velocity",
                      si_two_point: bool = False) -> "SpamDycore":
        """The reference's MMF configuration: thermo constants from the
        coupler, SI reference state from the coupler's ref_* columns, and
        the semi-implicit integrator at step dt_si (CoupledTestCase,
        extrudedmodel.h:5768-6069; core/params.h:148-152). si_two_point
        takes the exact two-point discrete gradient (with_si's
        two_point)."""
        thermo = ConstantKappaVirtualPottemp(
            cst=thermo_constants_from_coupler(coupler))
        dyc = SpamDycore.build(coupler, zint, thermo,
                               grav=coupler.const.grav)
        refstate = si_mod.build_coupled_reference_state(
            state, dyc.geom, thermo, dyc.varset, coupler.const.grav)
        return dyc.with_si(refstate, dt_si, max_iters=si_max_iters,
                           nquad=si_nquad, linear_system=linear_system,
                           two_point=si_two_point)

    def with_si(self, refstate, dt_si, max_iters: int = 3, nquad: int = 2,
                linear_system: str = "velocity",
                two_point: bool = False) -> "SpamDycore":
        """A copy that takes semi-implicit steps of dt_si with the given
        reference state (ref tstype="si" + set_reference_state).
        linear_system: "velocity" (buoyancy-coupled, slab only, as in the
        reference, extrudedmodel.h:2561-2564: a 3-D dycore takes
        "pressure_gravity" in its place, as pam_tpu does,
        pam_tpu/spam/dycore.py:335-340), "pressure" (the reference YAML
        default, extrudedmodel.h:5059; no gravity in its operator, so it
        can destabilize strongly stratified columns at large dt) or
        "pressure_gravity"."""
        systems = {"velocity": si_mod.CompressibleVelocityLinearSystem,
                   "pressure": si_mod.CompressiblePressureLinearSystem,
                   "pressure_gravity":
                       si_mod.CompressiblePressureGravityLinearSystem}
        if linear_system not in systems:
            raise ValueError(f"unknown linear_system {linear_system!r}; "
                             f"one of {sorted(systems)}")
        if self.ndims == 2 and linear_system == "velocity":
            linear_system = "pressure_gravity"
        T = lambda a: torch.as_tensor(a, dtype=self.coupler.dtype,
                                      device=self.coupler.device)
        tend = dataclasses.replace(
            self.tend, force_refstate_hydrostatic_balance=True,
            refdens=T(refstate["dens"]), ref_rho_pi=T(refstate["rho_pi"]),
            ref_q_pi=T(refstate["q_pi"]), ref_rho_di=T(refstate["rho_di"]),
            ref_q_di=T(refstate["q_di"]), ref_B=T(refstate["B"]))
        if linear_system == "velocity":
            linsys = si_mod.CompressibleVelocityLinearSystem.build(
                self.geom, self.thermo, self.varset, refstate, dt_si,
                grav=self.grav)
        else:
            linsys = systems[linear_system].build(
                self.geom, self.thermo, self.varset, refstate, dt_si)
        return dataclasses.replace(self, tend=tend, si_linsys=linsys,
                                   si_dt=dt_si, si_max_iters=max_iters,
                                   si_nquad=nquad, si_two_point=two_point)

    # ------------------------------------------------------- conversions
    def coupler_to_dynamics(self, state):
        """(convert_coupler_to_dynamics_densities/wind,
        variableset.h:675-912, averaging path): the slab drops the
        coupler's y axis, 3-D keeps it and stacks v = (vx, vy)."""
        g, vs, th = self.geom, self.varset, self.thermo
        three_d = self.ndims == 2
        nh = 2 if three_d else 1
        fld = (lambda name: state[name]) if three_d else \
            (lambda name: state[name][:, :, 0, :])
        if "water_vapor" not in vs.tracer_names:
            raise ValueError(
                "the coupled SPAM conversion requires a registered "
                "'water_vapor' tracer (variableset.h:246-287)")
        area = g.area_n1_t[(Ellipsis,) + (None,) * nh]
        rho_d = fld("density_dry")
        temp = fld("temp")
        tracers = [fld(n) for n in vs.tracer_names]
        dens_vap = tracers[vs.dens_id_vap - 2]
        dens_tot = rho_d + dens_vap  # ref: variableset.h:724
        qd = rho_d / dens_tot
        qv = dens_vap / dens_tot
        ql = tracers[vs.dens_id_liq - 2] / dens_tot if vs.liq_found else 0.0
        qi = tracers[vs.dens_id_ice - 2] / dens_tot if vs.ice_found else 0.0
        alpha = 1.0 / dens_tot
        sv = th.compute_entropic_var_from_alpha_T(alpha, temp, qd, qv, ql, qi)
        dens = torch.stack([dens_tot * area, sv * dens_tot * area] +
                           [t * area for t in tracers])
        # winds (averaging; ref: variableset.h:874-911)
        uvel = fld("uvel")
        wvel = fld("wvel")
        dzp = g.dz_p_t[(Ellipsis,) + (None,) * nh]
        if self.couple_wind_exact_inverse:
            w = exact_inverse_w(wvel, dzp) * dzp
        else:
            w = 0.5 * (wvel[:, :-1] + wvel[:, 1:]) * dzp
        if three_d:
            vvel = fld("vvel")
            if self.couple_wind_exact_inverse:
                vx = exact_inverse_avg(uvel, -1) * g.dx
                vy = exact_inverse_avg(vvel, -2) * g.dy
            else:
                vx = 0.5 * (uvel + comm.proll(uvel, -1, -1)) * g.dx
                vy = 0.5 * (vvel + comm.proll(vvel, -1, -2)) * g.dy
            return dens, torch.stack([vx, vy]), w
        if self.couple_wind_exact_inverse:
            return dens, exact_inverse_avg(uvel, -1) * g.dx, w
        return dens, 0.5 * (uvel + rollm(uvel, -1)) * g.dx, w

    def dynamics_to_coupler(self, state, dens, v, w):
        """(convert_dynamics_to_coupler_densities/wind,
        variableset.h:481-654). Returns a new state dict."""
        g, vs, th = self.geom, self.varset, self.thermo
        three_d = self.ndims == 2
        nh = 2 if three_d else 1
        area = g.area_n1_t[(Ellipsis,) + (None,) * nh]
        qd, qv, ql, qi = vs.moist_qs(dens)
        sv = vs.get_entropic_var(dens)
        alpha = vs.get_alpha(dens)
        temp = th.compute_T_from_alpha(alpha, sv, qd, qv, ql, qi)
        rho_d = vs.get_dry_density(dens) / area
        to4d = (lambda a: a) if three_d else (lambda a: a[:, :, None, :])
        out = dict(state)
        out["density_dry"] = to4d(rho_d)
        out["temp"] = to4d(temp)
        for idx, name in enumerate(vs.tracer_names):
            out[name] = to4d(dens[2 + idx] / area)
        # winds back to cell centers (ref: variableset.h:594-652)
        if three_d:
            out["uvel"] = 0.5 * (v[0] / g.dx +
                                 comm.proll(v[0] / g.dx, 1, -1))
            out["vvel"] = 0.5 * (v[1] / g.dy +
                                 comm.proll(v[1] / g.dy, 1, -2))
        else:
            u_edge = v / g.dx
            out["uvel"] = to4d(0.5 * (u_edge + rollm(u_edge, 1)))
            out["vvel"] = torch.zeros_like(out["uvel"])
        e = g.dz_p_t[(Ellipsis,) + (None,) * nh]
        w_phys = w / e                        # (nens, nz-1, [ny,] nx)
        # wvel at dual layer k: interface-weighted interp (ref :607-633)
        w_pad = (extruded3d.mirror_layer if three_d else mirror_layer)(
            w_phys, 1)                        # w_pad[k] = w_phys[k-1]
        e_pad = torch.cat([e[:, :1], e, e[:, -1:]], dim=1)
        wd, wu = w_pad[:, :-1], w_pad[:, 1:]
        e_d, e_u = e_pad[:, :-1], e_pad[:, 1:]
        w_mid = wd + (wu - wd) * e_d / (e_u + e_d)
        # the boundary layers take the adjacent w directly
        w_mid = torch.cat([w_phys[:, :1], w_mid[:, 1:-1], w_phys[:, -1:]],
                          dim=1)
        out["wvel"] = to4d(w_mid)
        return out

    # ------------------------------------------------------- time stepping
    def compute_dt_dyn(self, cfl: float = 0.5):
        """Static acoustic-CFL step of the SSPRK3 substeps (Dycore.h:248-266
        CFL-adaptive substepping, with a conservative sound speed); dy
        counts in 3-D."""
        cs = 350.0
        dmin = min(self.geom.dx, float(np.min(self.geom.dz_d)))
        if self.ndims == 2:
            dmin = min(dmin, self.geom.dy)
        return cfl * dmin / cs

    def timestep(self, state, dt_phys, n_substeps: int = None):
        """Advance the coupler state by dt_phys (Dycore::timeStep,
        spam/Dycore.h:248-318): SI steps of si_dt after with_si, else
        n_substeps SSPRK3 steps (by default as many as the acoustic CFL of
        compute_dt_dyn asks). Negative positive-definite densities are
        clipped after every substep (the reference's
        clip_negative_densities)."""
        geop = comm.local_xslice(self.geop, -1)
        if self.ndims == 2:
            geop = comm.local_yslice(geop, -2)
        if self.si_linsys is not None:
            n_substeps = max(1, int(round(dt_phys / self.si_dt)))
            dtcrm = dt_phys / n_substeps

            def stepper(d_, v_, w_):
                return si_mod.si_step(self.tend, self.si_linsys, d_, v_, w_,
                                      geop, dtcrm, self.si_max_iters,
                                      self.si_nquad,
                                      two_point=self.si_two_point)
        else:
            if n_substeps is None:
                n_substeps = max(1, int(np.ceil(dt_phys /
                                                self.compute_dt_dyn())))
            dtcrm = dt_phys / n_substeps

            def stepper(d_, v_, w_):
                return self.tend.ssprk3_step(d_, v_, w_, geop, dtcrm)
        dens, v, w = self.coupler_to_dynamics(state)
        pos = _flags(tuple(bool(p) for p in self.varset.dens_pos),
                     dens.device)
        pos = pos.reshape((-1,) + (1,) * (dens.ndim - 1))
        for _ in range(n_substeps):
            dens, v, w = stepper(dens, v, w)
            dens = torch.where(pos, torch.clamp(dens, min=0.0), dens)
        return self.dynamics_to_coupler(state, dens, v, w)

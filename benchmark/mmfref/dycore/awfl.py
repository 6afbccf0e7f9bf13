"""The AWFL ("PAM-A") finite-volume dycore in plain PyTorch: a frozen copy
of ``pam_tpu_torch/dycore/awfl.py`` as its CPU route runs it (ref
dynamics/awfl/Dycore.h, "SSPRK3+WENO+FV A-grid").

Compressible Euler on an A-grid with characteristic acoustic/advective
upwind WENO reconstruction (``ops/awfl_flux.py``), FCT tracer
positivity, SSPRK3 time stepping and dynamic acoustic sub-cycling. The
internal layout is ``(nvar, nens, ny, nz, nx)``; coupler arrays stay
``(nens, nz, ny, nx)``.

Departures from the port, each also noted where it is made:

- the sub-cycle count is read on the host and the sub-cycles are a
  Python loop (the port's eager route; its compiled step loops on the
  device), with no trip or launch count kept;
- every device takes the plain flux (the port's CPU route), no kernel;
- no tracer spans;
- the 2-D slab only (ny == 1) and the perturbation-pressure form only
  (the port's ``grav_balance=False``, the MMF's): the 3-D halos and the
  gravity-balanced background are left out;
- the WENO order (5) and the CFL number (0.8), the port's defaults and
  the MMF's, are constants;
- the coupler's grid spacing and tracer stack, which this reference's
  coupler does not hold, are worked out here.

Functions return new tensors and never write into their arguments."""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any

import numpy as np
import torch

from ..core.coupler import Coupler, hmean
from ..ops import awfl_flux, weno
from ..parallel import comm

# State-vector variable ids (ref: Dycore.h:27-31)
ID_R, ID_U, ID_V, ID_W, ID_T = 0, 1, 2, 3, 4
NUM_STATE = 5

# array axes of stacked fields (nvar, nens, ny, nz, nx)
AX_Z, AX_X = awfl_flux.AX_Z, awfl_flux.AX_X
ORD, HS = awfl_flux.ORD, awfl_flux.HS   # WENO order, halo cells a side
CFL = 0.8                               # the port's default, the MMF's


def _over(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as a true division (a Python scalar over a tensor would
    be the tensor's reciprocal times the scalar)."""
    return torch.tensor(num, dtype=den.dtype) / den


def _pad_ones(a, axis):
    """One layer of 1.0 on each side of ``axis``."""
    shape = list(a.shape)
    shape[axis] = 1
    ones = a.new_ones(shape)
    return torch.cat([ones, a, ones], dim=axis)


def _total(terms):
    """Left-to-right sum of tensors (``sum`` would start from an int 0)."""
    return functools.reduce(operator.add, terms)


# the coupler's properties that the port's Coupler holds and this
# reference's does not
def _dx(cpl: Coupler) -> float:
    return cpl.xlen / cpl.nx


def _dy(cpl: Coupler) -> float:
    return cpl.ylen / cpl.ny


def _stack_tracers(cpl: Coupler, state) -> torch.Tensor:
    """(ntr, nens, nz, ny, nx) stack of every tracer, in registry order."""
    return torch.stack([state[n] for n in cpl.tracer_names])


def _unstack_tracers(cpl: Coupler, state, stacked) -> dict:
    out = dict(state)
    for i, n in enumerate(cpl.tracer_names):
        out[n] = stacked[i]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class AwflDycore:
    """Static configuration and precomputed tables; the methods are pure."""
    coupler: Coupler
    # filled by `build`
    tables: Any = None
    levels: awfl_flux.LevelMatrices = None
    pos: Any = None     # (ntr, 1, 1, 1, 1) bool: positive-definite tracers
    adds: Any = None    # (ntr,) 1 where a tracer adds mass, else 0
    halo_k: Any = None  # (2, 1, 1, hs, 1): +hs..+1 below ground, -1..-hs above
    id_wv: int = 0      # index of water vapour among the tracers

    # ------------------------------------------------------------------ setup
    @staticmethod
    def build(coupler: Coupler, dz) -> "AwflDycore":
        """dz: (nz,) or (nens, nz) static vertical spacings (numpy). Where
        every member has the same dz one set of per-level matrices serves
        them all; otherwise each member gets its own."""
        if coupler.ny != 1:
            # departure: the port's 3-D route is not copied
            raise ValueError(f"ny={coupler.ny}: the reference holds the 2-D "
                             "AWFL slab (ny=1) only")
        dz = np.asarray(dz, np.float64)
        if dz.ndim == 1:
            dz = np.broadcast_to(dz, (coupler.nens, coupler.nz))
        if dz.shape != (coupler.nens, coupler.nz):
            raise ValueError(f"dz {dz.shape} does not match (nens, nz) = "
                             f"({coupler.nens}, {coupler.nz})")
        tables = weno.weno_tables(ORD, coupler.dtype)
        if np.allclose(dz, dz[:1]):
            dz = dz[:1]
        levels = awfl_flux.LevelMatrices.build(
            *awfl_flux.vertical_recon_matrices(dz, ORD), coupler.dtype,
            coupler.device)
        pos = torch.as_tensor(coupler.tracer_positive, dtype=torch.bool,
                              device=coupler.device)
        adds = torch.as_tensor(
            np.array([t.adds_mass for t in coupler.tracers], np.float64),
            dtype=coupler.dtype, device=coupler.device)
        k = np.arange(1.0, HS + 1)
        halo_k = torch.as_tensor(np.stack([k[::-1], -k]), dtype=coupler.dtype,
                                 device=coupler.device)[:, None, None, :, None]
        return AwflDycore(coupler=coupler, tables=tables, levels=levels,
                          pos=pos[:, None, None, None, None], adds=adds,
                          halo_k=halo_k,
                          id_wv=coupler.tracer_names.index("water_vapor"))

    # the derived constants of the port's Constants, which this
    # reference's does not hold
    @property
    def gamma_d(self) -> float:
        c = self.coupler.const
        return c.cp_d / (c.cp_d - c.R_d)

    @property
    def C0(self) -> float:
        # p = C0 * (rho*theta)^gamma  (Dycore.h:890)
        c = self.coupler.const
        return (c.R_d * c.p0 ** (-(c.R_d / c.cp_d))) ** self.gamma_d

    # ---------------------------------------------------- coupler conversions
    def _adds_mass(self, tracers):
        """Sum of the tracers that add mass, (nens, ...)."""
        return torch.einsum('t,t...->...', self.adds, tracers)

    def coupler_to_dynamics(self, state):
        """Coupler (rho_d, u, v, w, T, named tracers) -> conserved dycore
        variables (rho, rho*u, rho*v, rho*w, rho*theta) and stacked
        tracers (ref: convert_coupler_to_dynamics, Dycore.h:1336-1388)."""
        cpl, c = self.coupler, self.coupler.const
        rho_d = state["density_dry"]
        rho_v = state["water_vapor"]
        temp = state["temp"]
        press = rho_d * c.R_d * temp + rho_v * c.R_v * temp
        tracers = _stack_tracers(cpl, state)
        rho = rho_d + self._adds_mass(tracers)
        theta = (press / self.C0) ** (1.0 / self.gamma_d) / rho
        dyn = torch.stack([rho, rho * state["uvel"], rho * state["vvel"],
                           rho * state["wvel"], rho * theta])
        # coupler (.., nz, ny, nx) -> internal (.., ny, nz, nx) layout
        return (dyn.transpose(2, 3).contiguous(),
                tracers.transpose(2, 3).contiguous())

    def dynamics_to_coupler(self, state, dyn, tracers):
        """Inverse conversion (ref: convert_dynamics_to_coupler,
        Dycore.h:1281-1331)."""
        cpl, c = self.coupler, self.coupler.const
        dyn = dyn.transpose(2, 3).contiguous()
        tracers = tracers.transpose(2, 3).contiguous()
        rho = dyn[ID_R]
        press = self.C0 * dyn[ID_T] ** self.gamma_d
        rho_d = rho - self._adds_mass(tracers)
        rho_v = tracers[self.id_wv]
        temp = press / (rho_d * c.R_d + rho_v * c.R_v)
        out = dict(state)
        out["density_dry"] = rho_d
        out["uvel"] = dyn[ID_U] / rho
        out["vvel"] = dyn[ID_V] / rho
        out["wvel"] = dyn[ID_W] / rho
        out["temp"] = temp
        return _unstack_tracers(cpl, out, tracers)

    # ------------------------------------------------------------------- CFL
    def compute_time_step(self, state):
        """Max stable dt from conservative wind+sound speed estimates, a
        0-d tensor (ref: compute_time_step, Dycore.h:65-102)."""
        cpl, c = self.coupler, self.coupler.const
        rho_d = state["density_dry"]
        rho_v = state["water_vapor"]
        rho = rho_d + rho_v
        p = (rho_d * c.R_d + rho_v * c.R_v) * state["temp"]
        cs = torch.sqrt(self.gamma_d * p / rho)
        dz = state["vertical_cell_dz"][:, :, None, None]
        dtx = _over(CFL * _dx(cpl), state["uvel"].abs() + cs)
        dty = _over(CFL * _dy(cpl), state["vvel"].abs() + cs)
        dtz = CFL * dz / (state["wvel"].abs() + cs)
        return comm.pmin_h(torch.minimum(torch.minimum(dtx, dty), dtz))

    # ----------------------------------------------------------- halo + BCs
    def _pad_all(self, dyn, tracers, pressure, dz):
        """Periodic x halos and vertical boundary halos, hs cells a side:
        the padded (dyn, tracers, pressure) as views of one array (ref:
        halo_exchange, Dycore.h:608-711). ``dyn`` holds rho and the
        de-densitized (u, v, w, theta). The single y row is not padded:
        the reference's edge copies of it feed no flux (departure: no y
        halo, the 3-D route)."""
        c = self.coupler.const
        hs = HS
        ntr = tracers.shape[0]
        grav, gamma, C0 = c.grav, self.gamma_d, self.C0

        allf = torch.cat([dyn, tracers, pressure[None]], dim=0)
        allf = comm.halo_pad(allf, hs, axis=AX_X, kind="x")

        rho, th = allf[0], allf[4]

        # vertical halo blocks (nfields, nens, ny, hs, nx): u/v/theta/
        # tracers zero-gradient; w zero (rigid lid/ground, Dycore.h:
        # 662-677); rho hydrostatic extrapolation (Dycore.h:682-709);
        # pressure an edge copy
        eshape = list(allf.shape)
        eshape[AX_Z] = hs
        bot = allf[:, :, :, :1].expand(eshape).clone()
        top = allf[:, :, :, -1:].expand(eshape).clone()

        # rho_halo(k) = (rho0^(g-1) + sign*g*(g-1)*dz0*k / (gamma*C0*th0^g))
        #               ^(1/(g-1)), k = 1..hs away from the boundary cell;
        # index 0 of the leading axis is the bottom (farthest cell first),
        # 1 the top (nearest first)
        gm1 = gamma - 1.0
        ends = lambda a: torch.stack([a[:, :, :1], a[:, :, -1:]])
        fac = grav * gm1 * ends(dz[:, None, :, None]) / (
            gamma * C0 * ends(th) ** gamma)
        halo = (ends(rho) ** gm1 + fac * self.halo_k) ** (1.0 / gm1)
        bot[0] = halo[0]
        top[0] = halo[1]
        bot[3] = 0.0
        top[3] = 0.0
        allp = torch.cat([bot, allf, top], dim=AX_Z)
        return allp[:NUM_STATE], allp[NUM_STATE:NUM_STATE + ntr], allp[-1]

    # ------------------------------------------------------------ tendencies
    def _direction(self, dyn_p, trac_p, pres_p, axis):
        """The flux of one direction from the padded arrays: the interior
        in the other direction, as views."""
        hs = HS
        sl = [slice(None)] * 5
        for a in (AX_Z, AX_X):
            if a != axis:
                sl[a] = slice(hs, -hs)
        sl = tuple(sl)
        levels = self.levels if axis == AX_Z else None
        return awfl_flux.flux_direction(dyn_p[sl], trac_p[sl], pres_p[sl[1:]],
                                        axis, self.tables, levels)

    def tendencies(self, dyn, tracers, tracers_start, dt, state):
        """Semi-discrete right-hand side for state and tracers
        (ref: compute_tendencies, Dycore.h:262-586). ``dt`` is a float or
        a 0-d tensor."""
        cpl, c = self.coupler, self.coupler.const
        dz = state["vertical_cell_dz"]  # (nens, nz)
        dz4 = dz[:, None, :, None]      # broadcasts over (nens, ny, nz, nx)
        gamma, C0, grav = self.gamma_d, self.C0, c.grav

        rho = dyn[ID_R]
        # perturbation pressure and de-densitized variables
        # (ref: Dycore.h:310-321)
        p_full = C0 * dyn[ID_T] ** gamma
        pressure = p_full - state["hy_pressure_cells"][:, None, :, None]
        prim = torch.cat([rho[None], dyn[1:] / rho[None]], dim=0)
        trac_prim = tracers / rho[None]

        dyn_p, trac_p, pres_p = self._pad_all(prim, trac_prim, pressure, dz)

        # per direction (axis, spacing, state flux, tracer flux), in the
        # reference's order x, z; the 2-D slab's zero y fluxes add exact
        # zeros and are left out, as in the port
        fluxes = [(axis, d) + self._direction(dyn_p, trac_p, pres_p, axis)
                  for axis, d in ((AX_X, _dx(cpl)), (AX_Z, dz4))]

        # FCT positivity limiting for positive tracers (ref:
        # Dycore.h:525-550)
        if cpl.tracer_positive.any():
            fluxes = self._fct(fluxes, tracers_start, dt, dz4)

        # flux divergence + gravity source (ref: Dycore.h:553-584)
        def div(f, ax, d):
            n = f.shape[ax] - 1
            return (f.narrow(ax, 1, n) - f.narrow(ax, 0, n)) / d

        s_tend = -_total(div(sf, ax, d) for ax, d, sf, _ in fluxes)
        gsrc = -grav * (rho - state["hy_dens_cells"][:, None, :, None])
        s_tend[ID_W] = s_tend[ID_W] + gsrc    # s_tend is this call's own
        s_tend[ID_V] = 0.0
        t_tend = -_total(div(tf, ax, d) for ax, d, _, tf in fluxes)
        return s_tend, t_tend

    def _fct(self, fluxes, tracers_start, dt, dz4):
        """Scale the tracer fluxes so that no positive tracer's cell gives
        away more mass than it holds (ref: Dycore.h:525-550), a face flux
        limited by the one cell it leaves. ``fluxes``: (axis, spacing,
        state flux, tracer flux) per direction; returns the same with the
        tracer fluxes limited."""
        cpl = self.coupler
        vol = _dx(cpl) * _dy(cpl) * dz4
        mass_avail = tracers_start.clamp(min=0.0) * vol

        def outflow(tf, ax, d):
            n = tf.shape[ax] - 1
            return (tf.narrow(ax, 1, n).clamp(min=0.0)
                    - tf.narrow(ax, 0, n).clamp(max=0.0)) / d

        flux_out = _total(outflow(tf, ax, d) for ax, d, _, tf in fluxes)
        mass_out = flux_out * dt * vol
        mult = torch.where(
            mass_out > mass_avail,
            mass_avail / torch.where(mass_out == 0, 1.0, mass_out), 1.0)
        mult = torch.where(self.pos, mult, 1.0)

        def limit(flux, ax):
            # > 0 leaves the cell on the face's minus side, < 0 the cell
            # on its plus side; x wraps periodically (the duplicated wrap
            # faces scaled alike), z pads with 1
            n = mult.shape[ax]
            padded = (_pad_ones(mult, ax) if ax == AX_Z
                      else comm.halo_pad(mult, 1, axis=ax, kind="x"))
            ml = padded.narrow(ax, 0, n + 1)
            mr = padded.narrow(ax, 1, n + 1)
            return flux * torch.where(flux > 0, ml,
                                      torch.where(flux < 0, mr, 1.0))

        return [(ax, d, sf, limit(tf, ax)) for ax, d, sf, tf in fluxes]

    # ------------------------------------------------------------- time step
    def _ssprk3_cycle(self, dyn, tracers, dt, state):
        """One SSPRK3 step of length dt (ref: Dycore.h:147-222)."""
        pos = self.pos

        def clamp(tr):
            return torch.where(pos, tr.clamp(min=0.0), tr)

        def tend(d, t, start, dtt):
            return self.tendencies(d, t, start, dtt, state)

        # Stage 1
        st, tt = tend(dyn, tracers, tracers, dt)
        dyn1 = dyn + dt * st
        trac1 = clamp(tracers + dt * tt)
        # Stage 2
        start2 = 0.75 * tracers + 0.25 * trac1
        st, tt = tend(dyn1, trac1, start2, 0.25 * dt)
        dyn2 = 0.75 * dyn + 0.25 * dyn1 + 0.25 * dt * st
        trac2 = clamp(0.75 * tracers + 0.25 * trac1 + 0.25 * dt * tt)
        # Stage 3
        start3 = (1.0 / 3.0) * tracers + (2.0 / 3.0) * trac2
        st, tt = tend(dyn2, trac2, start3, (2.0 / 3.0) * dt)
        dyn3 = (1.0 / 3.0) * dyn + (2.0 / 3.0) * dyn2 + (2.0 / 3.0) * dt * st
        trac3 = clamp((1.0 / 3.0) * tracers + (2.0 / 3.0) * trac2 +
                      (2.0 / 3.0) * dt * tt)
        return dyn3, trac3

    def timestep(self, state, dt_phys):
        """Advance the coupler state by dt_phys with sub-cycled SSPRK3
        (ref: Dycore::timeStep, Dycore.h:107-255). The sub-cycle count
        and dt are computed on the device in the state's dtype; the count
        is read on the host and the sub-cycles run as a Python loop
        (departure: the port's compiled step loops on the device)."""
        dyn, tracers = self.coupler_to_dynamics(state)
        tracers = torch.where(self.pos, tracers.clamp(min=0.0), tracers)

        dt_dyn = self.compute_time_step(state)
        ncycles_t = torch.ceil(_over(dt_phys, dt_dyn)).to(torch.int32)
        dt_cyc = _over(dt_phys, ncycles_t.to(dyn.dtype))
        ncycles = int(ncycles_t)
        if not 0 < ncycles < 100000:
            raise FloatingPointError(
                f"AWFL sub-cycle count {ncycles} for dt_phys={dt_phys}: the "
                "CFL time step is not a positive finite number")
        for _ in range(ncycles):
            dyn, tracers = self._ssprk3_cycle(dyn, tracers, dt_cyc, state)
        return self.dynamics_to_coupler(state, dyn, tracers)

    # --------------------------------------------------------- hydrostatics
    def declare_current_profile_as_hydrostatic(self, state):
        """Record the current horizontal-mean profile as the hydrostatic
        background, hy_dens_cells and hy_pressure_cells (ref:
        Dycore.h:1392-1504; departure: no variable_gravity, the port's
        grav_balance mode)."""
        c = self.coupler.const
        dyn, _ = self.coupler_to_dynamics(state)
        to_cpl = lambda a: a.transpose(1, 2)
        out = dict(state)
        press = self.C0 * dyn[ID_T] ** self.gamma_d
        out["hy_pressure_cells"] = hmean(to_cpl(press))
        out["hy_dens_cells"] = hmean(to_cpl(dyn[ID_R]))
        return out

"""AWFL ("PAM-A") finite-volume dycore (port of pam_tpu/dycore/awfl.py;
ref dynamics/awfl/Dycore.h, "SSPRK3+WENO+FV A-grid").

Compressible Euler on an A-grid with characteristic acoustic/advective
upwind WENO reconstruction, FCT tracer positivity, SSPRK3 time stepping
and dynamic acoustic sub-cycling.

* The flux of one direction is one call of ``ops.awfl_flux.flux_direction``
  (the CUDA kernel ``csrc/awfl_flux.cu`` on the card, its plain version on
  the CPU), twice per tendency evaluation in 2-D and three times in 3-D.
* FCT is data-parallel as in ``pam_tpu``: the cell limiter factors are
  computed in one pass and applied to the faces with masked selects; a
  face flux is only ever limited by the single cell it leaves
  (Dycore.h:521-550).
* The data-dependent sub-cycle count (Dycore.h:144) is computed on the
  device and read once per ``timestep`` (one host sync); the sub-cycles
  are a Python loop.
* The internal layout is ``(nvar, nens, ny, nz, nx)`` as in ``pam_tpu``;
  coupler arrays stay ``(nens, nz, ny, nx)`` and the converters swap.

Functions return new tensors and never write into their arguments.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ..core.coupler import Coupler, hmean
from ..ops import awfl_flux, graph
from ..ops import recon_matrices as rm
from ..ops import weno
from ..parallel import comm

# State-vector variable ids (ref: Dycore.h:27-31)
ID_R, ID_U, ID_V, ID_W, ID_T = 0, 1, 2, 3, 4
NUM_STATE = 5

# array axes of stacked fields (nvar, nens, ny, nz, nx)
AX_Y, AX_Z, AX_X = awfl_flux.AX_Y, awfl_flux.AX_Z, awfl_flux.AX_X


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


@dataclasses.dataclass(frozen=True, eq=False)
class AwflDycore:
    """Static configuration and precomputed tables; the methods are pure."""
    coupler: Coupler
    ord: int = 5
    cfl: float = 0.8
    grav_balance: bool = False  # ref option "balance_hydrostasis_with_gravity"
    # filled by `build`
    tables: Any = None
    levels: awfl_flux.LevelMatrices = None
    pos: Any = None     # (ntr, 1, 1, 1, 1) bool: positive-definite tracers
    adds: Any = None    # (ntr,) 1 where a tracer adds mass, else 0
    halo_k: Any = None  # (2, 1, 1, hs, 1): +hs..+1 below ground, -1..-hs above

    # ------------------------------------------------------------------ setup
    @staticmethod
    def build(coupler: Coupler, dz, ord: int = 5, cfl: float = 0.8,
              grav_balance: bool = False) -> "AwflDycore":
        """dz: (nz,) or (nens, nz) static vertical spacings (numpy).

        Where every member has the same dz one set of per-level matrices
        serves them all; otherwise each member gets its own."""
        if ord != awfl_flux.ORD:
            raise ValueError(f"the AWFL flux is order {awfl_flux.ORD}, "
                             f"got ord={ord}")
        dz = np.asarray(dz, np.float64)
        if dz.ndim == 1:
            dz = np.broadcast_to(dz, (coupler.nens, coupler.nz))
        if dz.shape != (coupler.nens, coupler.nz):
            raise ValueError(f"dz {dz.shape} does not match (nens, nz) = "
                             f"({coupler.nens}, {coupler.nz})")
        tables = weno.weno_tables(ord, coupler.dtype)
        if np.allclose(dz, dz[:1]):
            dz = dz[:1]
        levels = awfl_flux.LevelMatrices.build(
            *rm.vertical_recon_matrices(dz, ord), coupler.dtype,
            coupler.device)
        pos = torch.as_tensor(coupler.tracer_positive, dtype=torch.bool,
                              device=coupler.device)
        adds = torch.as_tensor(coupler.tracer_adds_mass.astype(np.float64),
                               dtype=coupler.dtype, device=coupler.device)
        k = np.arange(1.0, (ord + 1) // 2 + 1)
        halo_k = torch.as_tensor(np.stack([k[::-1], -k]), dtype=coupler.dtype,
                                 device=coupler.device)[:, None, None, :, None]
        return AwflDycore(coupler=coupler, ord=ord, cfl=cfl,
                          grav_balance=grav_balance, tables=tables,
                          levels=levels,
                          pos=pos[:, None, None, None, None], adds=adds,
                          halo_k=halo_k)

    @property
    def hs(self) -> int:
        return (self.ord + 1) // 2

    @property
    def name(self) -> str:
        return "SSPRK3+WENO+FV A-grid"  # ref: Dycore.h:1544

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
        tracers = cpl.stack_tracers(state)
        rho = rho_d + self._adds_mass(tracers)
        theta = (press / c.C0) ** (1.0 / c.gamma_d) / rho
        dyn = torch.stack([rho, rho * state["uvel"], rho * state["vvel"],
                           rho * state["wvel"], rho * theta])
        # coupler (.., nz, ny, nx) -> internal (.., ny, nz, nx) layout
        return (dyn.transpose(2, 3).contiguous(),
                tracers.transpose(2, 3).contiguous())

    def dynamics_to_coupler(self, state, dyn, tracers):
        """Inverse conversion (ref: convert_dynamics_to_coupler,
        Dycore.h:1281-1331)."""
        cpl, c = self.coupler, self.coupler.const
        # internal (.., ny, nz, nx) -> coupler (.., nz, ny, nx) layout
        dyn = dyn.transpose(2, 3).contiguous()
        tracers = tracers.transpose(2, 3).contiguous()
        rho = dyn[ID_R]
        press = c.C0 * dyn[ID_T] ** c.gamma_d
        rho_d = rho - self._adds_mass(tracers)
        rho_v = tracers[cpl.idWV]
        temp = press / (rho_d * c.R_d + rho_v * c.R_v)
        out = dict(state)
        out["density_dry"] = rho_d
        out["uvel"] = dyn[ID_U] / rho
        out["vvel"] = dyn[ID_V] / rho
        out["wvel"] = dyn[ID_W] / rho
        out["temp"] = temp
        return cpl.unstack_tracers(out, tracers)

    # ------------------------------------------------------------------- CFL
    def compute_time_step(self, state):
        """Max stable dt from conservative wind+sound speed estimates, a
        0-d tensor (ref: compute_time_step, Dycore.h:65-102)."""
        cpl, c = self.coupler, self.coupler.const
        rho_d = state["density_dry"]
        rho_v = state["water_vapor"]
        rho = rho_d + rho_v
        p = (rho_d * c.R_d + rho_v * c.R_v) * state["temp"]
        cs = torch.sqrt(c.gamma_d * p / rho)
        dz = state["vertical_cell_dz"][:, :, None, None]
        dtx = _over(self.cfl * cpl.dx, state["uvel"].abs() + cs)
        dty = _over(self.cfl * cpl.dy, state["vvel"].abs() + cs)
        dtz = self.cfl * dz / (state["wvel"].abs() + cs)
        return comm.pmin_h(torch.minimum(torch.minimum(dtx, dty), dtz))

    # ----------------------------------------------------------- halo + BCs
    def _pad_all(self, dyn, tracers, pressure, dz):
        """Periodic x/y halos and vertical boundary halos.

        ``dyn`` holds rho and the de-densitized (u, v, w, theta); returns
        the padded (dyn, tracers, pressure) with hs cells per side in z
        and x, and in y of a 3-D run, as views of one array (ref:
        halo_exchange, Dycore.h:608-711). A 2-D run keeps its single y
        row: the reference's edge copies of it feed no flux."""
        cpl, c = self.coupler, self.coupler.const
        hs = self.hs
        ntr = tracers.shape[0]
        grav, gamma, C0 = c.grav, c.gamma_d, c.C0

        # one stacked array -> a single periodic-x (and y) pad for all
        allf = torch.cat([dyn, tracers, pressure[None]], dim=0)
        allf = comm.halo_pad(allf, hs, axis=AX_X, kind="x")
        if not cpl.sim2d:
            allf = comm.halo_pad(allf, hs, axis=AX_Y, kind="y")

        rho, th = allf[0], allf[4]

        # vertical halo blocks (nfields, nens, ny, hs, nx): u/v/theta/
        # tracers zero-gradient; w zero (rigid lid/ground, Dycore.h:
        # 662-677); rho hydrostatic extrapolation (Dycore.h:682-709);
        # pressure an edge copy (or the halo's rho*theta under
        # grav_balance, Dycore.h:691-693,705-707)
        eshape = list(allf.shape)
        eshape[AX_Z] = hs
        bot = allf[:, :, :, :1].expand(eshape).clone()
        top = allf[:, :, :, -1:].expand(eshape).clone()

        # rho_halo(k) = (rho0^(g-1) + sign*g*(g-1)*dz0*k / (gamma*C0*th0^g))
        #               ^(1/(g-1)), k = 1..hs away from the boundary cell;
        # below the ground (sign +) denser, above the lid (sign -) thinner.
        # Both ends and all k in one pass: index 0 of the leading axis is
        # the bottom (farthest cell first), 1 the top (nearest first).
        gm1 = gamma - 1.0
        ends = lambda a: torch.stack([a[:, :, :1], a[:, :, -1:]])
        fac = grav * gm1 * ends(dz[:, None, :, None]) / (
            gamma * C0 * ends(th) ** gamma)
        halo = (ends(rho) ** gm1 + fac * self.halo_k) ** (1.0 / gm1)
        bot[0] = halo[0]
        top[0] = halo[1]
        bot[3] = 0.0
        top[3] = 0.0
        if self.grav_balance:
            bot[-1] = C0 * (bot[0] * bot[4]) ** gamma
            top[-1] = C0 * (top[0] * top[4]) ** gamma
        allp = torch.cat([bot, allf, top], dim=AX_Z)
        return allp[:NUM_STATE], allp[NUM_STATE:NUM_STATE + ntr], allp[-1]

    # ------------------------------------------------------------ tendencies
    def _direction(self, dyn_p, trac_p, pres_p, axis):
        """The flux of one direction from the padded arrays: the interior
        in the other two directions, as views."""
        hs = self.hs
        sl = [slice(None)] * 5
        for a in (AX_Z, AX_Y, AX_X):
            if a != axis and not (a == AX_Y and self.coupler.sim2d):
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
        dx, dy = cpl.dx, cpl.dy
        dz = state["vertical_cell_dz"]  # (nens, nz)
        dz4 = dz[:, None, :, None]      # broadcasts over (nens, ny, nz, nx)
        gamma, C0, grav = c.gamma_d, c.C0, c.grav
        tpos = cpl.tracer_positive

        rho = dyn[ID_R]
        # pressure (perturbation unless grav_balance) and de-densitized
        # variables (ref: Dycore.h:310-321)
        p_full = C0 * dyn[ID_T] ** gamma
        if self.grav_balance:
            pressure = p_full
        else:
            pressure = p_full - state["hy_pressure_cells"][:, None, :, None]
        prim = torch.cat([rho[None], dyn[1:] / rho[None]], dim=0)
        trac_prim = tracers / rho[None]

        dyn_p, trac_p, pres_p = self._pad_all(prim, trac_prim, pressure, dz)

        # per direction (axis, spacing, state flux, tracer flux), in the
        # reference's order x, y, z. In 2-D the reference carries zero y
        # fluxes, whose terms add exact zeros: they are left out here.
        fluxes = []
        for axis, d, tag in ((AX_X, dx, "x"), (AX_Y, dy, "y"),
                             (AX_Z, dz4, "z")):
            if axis == AX_Y and cpl.sim2d:
                continue
            with record_function(f"pam:awfl.flux_{tag}"):
                fluxes.append((axis, d) + self._direction(dyn_p, trac_p,
                                                          pres_p, axis))

        # ---- FCT positivity limiting for positive tracers ----
        # (ref: Dycore.h:525-550, data-parallel; see the module docstring)
        if tpos.any():
            with record_function("pam:awfl.fct"):
                fluxes = self._fct(fluxes, tracers_start, dt, dz4)

        # ---- flux divergence + gravity source ---- (ref: Dycore.h:553-584)
        def div(f, ax, d):
            n = f.shape[ax] - 1
            return (f.narrow(ax, 1, n) - f.narrow(ax, 0, n)) / d

        s_tend = -_total(div(sf, ax, d) for ax, d, sf, _ in fluxes)
        if self.grav_balance:
            gsrc = -state["variable_gravity"][:, None, :, None] * rho
        else:
            gsrc = -grav * (rho - state["hy_dens_cells"][:, None, :, None])
        s_tend[ID_W] = s_tend[ID_W] + gsrc    # s_tend is this call's own
        if cpl.sim2d:
            s_tend[ID_V] = 0.0
        t_tend = -_total(div(tf, ax, d) for ax, d, _, tf in fluxes)
        return s_tend, t_tend

    def _fct(self, fluxes, tracers_start, dt, dz4):
        """Scale the tracer fluxes so that no positive tracer's cell gives
        away more mass than it holds (ref: Dycore.h:525-550). ``fluxes``:
        (axis, spacing, state flux, tracer flux) per direction; returns
        the same with the tracer fluxes limited."""
        cpl = self.coupler
        vol = cpl.dx * cpl.dy * dz4
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
            # A face flux > 0 leaves the cell on its minus side, < 0 the
            # cell on its plus side; only that cell's multiplier applies
            # (the reference's race-freedom argument, Dycore.h:521-524).
            # Horizontal axes wrap periodically, so the duplicated wrap
            # faces get the same scaling (the uniform interior rule, in
            # place of the reference's min() at the seam,
            # Dycore.h:574-579). The vertical axis pads with 1.
            n = mult.shape[ax]
            padded = (_pad_ones(mult, ax) if ax == AX_Z
                      else comm.halo_pad(mult, 1, axis=ax,
                                         kind="x" if ax == AX_X else "y"))
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
            with record_function("pam:awfl.tendencies"):
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
        and the sub-cycle's dt are computed on the device in the state's
        dtype. The eager route reads the count once (one host sync) and
        checks its range; the device route (``ops/graph.py::
        device_loops``, the compiled step) loops on ``i < ncycles`` on the
        device, as pam_tpu's ``lax.while_loop``, runs no sub-cycle for a
        count out of range, and leaves the check to a device flag that
        the compiled step's caller reads (``Graphed.check``)."""
        dyn, tracers = self.coupler_to_dynamics(state)
        tracers = torch.where(self.pos, tracers.clamp(min=0.0), tracers)

        dt_dyn = self.compute_time_step(state)
        ncycles_t = torch.ceil(_over(dt_phys, dt_dyn)).to(torch.int32)
        dt_cyc = _over(dt_phys, ncycles_t.to(dyn.dtype))

        def fault(n):
            return (f"AWFL sub-cycle count {n} for dt_phys={dt_phys}: the "
                    "CFL time step is not a positive finite number")
        if graph.device_loops():
            ok = (ncycles_t > 0) & (ncycles_t < 100000)
            graph.check(ok, FloatingPointError, fault, ncycles_t)
            ncycles = torch.where(ok, ncycles_t, 0)
        else:
            ncycles = int(ncycles_t)
            if not 0 < ncycles < 100000:
                raise FloatingPointError(fault(ncycles))
        dyn, tracers = graph.fori_loop(
            ncycles, lambda c: self._ssprk3_cycle(*c, dt_cyc, state),
            (dyn, tracers))
        graph.count(AwflDycore.timestep, "cycles", ncycles)
        return self.dynamics_to_coupler(state, dyn, tracers)

    # sub-cycles taken by every timestep call so far (a device tensor once
    # the compiled step has added to it)
    timestep.cycles = 0

    # --------------------------------------------------------- hydrostatics
    def declare_current_profile_as_hydrostatic(self, state):
        """Record the current horizontal-mean profile as the hydrostatic
        background (ref: Dycore.h:1392-1504): hy_dens_cells and
        hy_pressure_cells, or variable_gravity under grav_balance."""
        c = self.coupler.const
        dyn, tracers = self.coupler_to_dynamics(state)
        # back to coupler layout for horizontal means
        to_cpl = lambda a: a.transpose(1, 2)
        out = dict(state)
        if not self.grav_balance:
            press = c.C0 * dyn[ID_T] ** c.gamma_d
            out["hy_pressure_cells"] = hmean(to_cpl(press))
            out["hy_dens_cells"] = hmean(to_cpl(dyn[ID_R]))
            return out
        # grav-balance mode: discrete interface pressures by the same
        # vertical reconstruction the solver uses, averaged L/R
        # (ref: Dycore.h:1449-1488)
        dz = state["vertical_cell_dz"]
        rho = dyn[ID_R]
        pressure = c.C0 * dyn[ID_T] ** c.gamma_d
        prim = torch.cat([rho[None], dyn[1:] / rho[None]], dim=0)
        _, _, pres_p = self._pad_all(prim, tracers / rho[None], pressure, dz)
        hs = self.hs
        ys = slice(None) if self.coupler.sim2d else slice(hs, -hs)
        pres_d = pres_p[:, ys, :, hs:-hs]   # y/x interior, z padded
        pL, pR = weno.reconstruct_faces_both(
            pres_d[None], AX_Z, self.tables,
            per_level=(self.levels.s2c, self.levels.wrl), per_level_axis=-2)
        pint = 0.5 * (pL[0] + pR[0])  # (nens, ny, nz+1, nx)
        out["variable_gravity"] = hmean(to_cpl(
            -(pint[:, :, 1:] - pint[:, :, :-1]) / (rho * dz[:, None, :, None])))
        return out

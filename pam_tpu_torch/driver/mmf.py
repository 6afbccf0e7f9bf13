"""MMF standalone driver: GCM loop x CRM physics loop (port of
pam_tpu/driver/mmf.py:29-407; ref standalone/mmf_simplified/
driver.cpp:237-272 — per GCM step compute the forcing tendencies, then
per CRM step apply forcing -> dycore -> sponge -> sgs -> micro).

One CRM step is eager PyTorch over the driver's ensemble
(``crm_phys_step``, ``gcm_step``: pam_tpu's functions to jit). The compiled
step, pam_tpu's ``_jitted_single``, is ``_graphed_single``: the step
captured into one CUDA graph (ops/graph.py), its Kessler, P3
sedimentation and AWFL loops decided on the device; ``run`` and
``crm_phys_step_hostchunked`` replay it once a CRM step and once a chunk,
as pam_tpu dispatches its compiled step. A driver built at a chunk of the
ensemble steps any exact multiple of it in chunks, as pam_tpu's does
(ensemble micro-batching): ``crm_phys_step`` routes such a state through
``crm_phys_step_microbatched``, ``crm_phys_step_hostchunked`` is the same
from the host, and ``run`` in ``mb_mode`` "host" keeps the state chunked
across the GCM loop. Each chunk is a dense copy of its
members, stepped by the chunk driver as a state of its own size; the only
coupling across members in a step, Kessler's rainsplit minimum, becomes
one per chunk (physics/kessler.py, ``KesslerMicro.ens_chunk``).
``pick_ens_chunk`` keeps pam_tpu's chunk, so "auto" picks what pam_tpu
picks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..core.coupler import Coupler
from ..dycore.awfl import AwflDycore
from ..modules import gcm_forcing, sponge
from ..modules.broadcast import broadcast_initial_gcm_column
from ..modules.perturb import perturb_temperature
from ..ops import graph, tridiag
from ..physics import kessler, p3
from ..physics.sgs import shoc
from ..spam.dycore import SpamDycore
from . import supercell_column

# the routes of MmfDriver.run for a state of several chunks
MB_MODES = ("host", "unrolled")


def pick_ens_chunk(nx: int, ny: int, nz: int, dtype=torch.float32,
                   nens_total: int = None) -> int:
    """The largest power-of-two ensemble chunk whose per-field column
    block stays within pam_tpu's budget of 65*50*4 bytes * 128 members,
    clamped to a divisor of ``nens_total`` when a total is given
    (pam_tpu/driver/mmf.py:29-50, the itemsize from the torch dtype).

    The budget is pam_tpu's calibration on a TPU v5e (the CRM step's
    working set stays in VMEM up to 128 members of the 65x1x50 f32
    grid). It says nothing about the H100; it is kept so that "auto"
    picks pam_tpu's chunk, because the chunk decides Kessler's rainsplit
    trip counts and with them the trajectory."""
    per_member = nx * ny * nz * dtype.itemsize
    budget = 65 * 50 * 4 * 128
    chunk = 2 ** max(0, int(math.floor(math.log2(max(
        1.0, budget / max(per_member, 1))))))
    if nens_total is not None:
        while chunk > 1 and nens_total % chunk != 0:
            chunk //= 2
        chunk = min(chunk, nens_total)
    return max(chunk, 1)


def _split_ens(state, n_chunks: int) -> tuple:
    """Every state leaf cut into ``n_chunks`` equal blocks of members
    along the leading axis: a tuple of chunk states. Each block is a
    dense copy (in the leaf's dtype and device, contiguous), not a view,
    so an in-place write to a chunk cannot reach its neighbours and the
    kernels get the layouts of a state of the chunk's size."""
    for k, v in state.items():
        if v.dim() == 0 or v.shape[0] % n_chunks:
            raise ValueError(
                f"state[{k!r}] has shape {tuple(v.shape)}; micro-batching "
                f"into {n_chunks} chunks needs a leading axis that they "
                "divide")
    return tuple({k: v[i * (v.shape[0] // n_chunks):
                       (i + 1) * (v.shape[0] // n_chunks)].clone(
                           memory_format=torch.contiguous_format)
                  for k, v in state.items()} for i in range(n_chunks))


def _join_ens(chunks, consume: bool = False) -> dict:
    """The chunk states concatenated back along the leading axis. With
    ``consume`` each field is popped from the chunks as it is joined, so
    the join holds one field more than the state, not a second state."""
    if consume:
        return {k: torch.cat([c.pop(k) for c in chunks])
                for k in list(chunks[0])}
    return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


@dataclasses.dataclass(eq=False)
class MmfDriver:
    """Composes the dycore and the physics into CRM and GCM steps."""
    coupler: Coupler
    dycore: Any
    micro: Any = None
    sgs: Any = None
    rad: Any = None
    apply_sponge: bool = True
    apply_gcm_forcing: bool = True
    dt_gcm: float = 900.0
    dt_crm_phys: float = 20.0
    # how ``run`` steps a state of several chunks (pam_tpu's mb_mode):
    #   "host"     — split once, then every chunk through the GCM loop on
    #                its own (forcing and steps), joined for each callback
    #                and at the end;
    #   "unrolled" — the full state between steps, split and joined by
    #                every crm_phys_step (pam_tpu's one program per step)
    mb_mode: str = "host"

    def __post_init__(self):
        if self.mb_mode not in MB_MODES:
            raise ValueError(f"mb_mode={self.mb_mode!r}: expected one of "
                             f"{MB_MODES}")

    def n_chunks(self, state) -> int:
        """How many driver-sized chunks ``state`` holds; a state whose
        ensemble is not a multiple of the driver's raises."""
        total = int(state["temp"].shape[0])
        built = int(self.coupler.nens)
        if total % built != 0:
            raise ValueError(
                f"state carries nens={total} but the driver was built with "
                f"nens={built}; micro-batching needs an exact multiple")
        return total // built

    def crm_phys_step(self, state):
        """One CRM physics step. A state that carries an exact multiple of
        the driver's ensemble goes through
        :meth:`crm_phys_step_microbatched` in chunks of the driver's size
        (pam_tpu's automatic route, pam_tpu/driver/mmf.py:95-116)."""
        n = self.n_chunks(state)
        if n > 1:
            return self.crm_phys_step_microbatched(state, n)
        return self._crm_phys_step_single(state)

    def _crm_phys_step_single(self, state):
        # the pam: spans name the layers in a torch.profiler trace
        # (python -m pam_tpu_torch.profile_step)
        cpl = self.coupler
        if self.apply_gcm_forcing:
            with record_function("pam:forcing"):
                state = gcm_forcing.apply_gcm_forcing_tendencies(
                    cpl, state, self.dt_crm_phys, self.dt_gcm)
        with record_function("pam:dycore"):
            state = self.dycore.timestep(state, self.dt_crm_phys)
        if self.apply_sponge:
            with record_function("pam:sponge"):
                state = sponge.sponge_layer(cpl, state, self.dt_crm_phys)
        if self.sgs is not None:
            with record_function("pam:sgs"):
                state = self.sgs.timestep(state, self.dt_crm_phys)
        if self.micro is not None:
            with record_function("pam:micro"):
                state = self.micro.timestep(state, self.dt_crm_phys)
        if self.rad is not None:
            with record_function("pam:rad"):
                state = self.rad.timestep(state, self.dt_crm_phys)
        return state

    def _forcing(self, state):
        """The GCM forcing tendencies of ``state``, chunk by chunk when it
        holds several: they are per member, and on the chunks' shapes they
        take the reduction order that the host route and a chunk stepped
        alone take (pam_tpu computes them on the full state here, the same
        values up to that order)."""
        n = self.n_chunks(state)
        if n == 1:
            return gcm_forcing.compute_gcm_forcing_tendencies(
                self.coupler, state, self.dt_gcm)
        return _join_ens([gcm_forcing.compute_gcm_forcing_tendencies(
            self.coupler, c, self.dt_gcm) for c in _split_ens(state, n)])

    def gcm_step(self, state, step: Callable = None):
        """One GCM step: forcing tendencies (unless apply_gcm_forcing is
        false), then dt_gcm/dt_crm_phys CRM steps, each through ``step``
        (:meth:`crm_phys_step` by default, so in chunks for a multiple of
        the driver's ensemble; :meth:`run` passes :meth:`_graphed_single`
        for a driver-sized state)."""
        step = step or self.crm_phys_step
        if self.apply_gcm_forcing:
            state = self._forcing(state)
        for _ in range(int(round(self.dt_gcm / self.dt_crm_phys))):
            state = step(state)
        return state

    def crm_phys_step_microbatched(self, state, n_chunks: int):
        """One CRM step of a state of ``n_chunks`` times the driver's
        ensemble: the state is split into dense chunks of the driver's
        size, each is stepped in turn, and the chunks are joined. Members
        are independent CRMs, so this is the full step but for Kessler's
        rainsplit minimum, which becomes one per chunk.

        pam_tpu unrolls up to 8 chunks into one program, chained by
        optimization barriers (``PAM_MB_SERIALIZE``), and maps over more
        with ``lax.map``; both only shape XLA's schedule. Eager PyTorch
        runs the chunks in order already, so neither has a counterpart
        here."""
        nens = self.coupler.nens * n_chunks
        for k, v in state.items():
            if v.dim() == 0 or v.shape[0] != nens:
                raise ValueError(
                    f"crm_phys_step_microbatched: state[{k!r}] has shape "
                    f"{tuple(v.shape)}; every leaf must carry the full "
                    f"ensemble (leading axis {nens} = driver nens "
                    f"{self.coupler.nens} x n_chunks {n_chunks})")
        return _join_ens(self.step_chunks(list(_split_ens(state,
                                                           n_chunks))))

    def step_chunks(self, chunks: list, step: Callable = None) -> list:
        """Each chunk of the list stepped in turn by ``step`` (the eager
        :meth:`_crm_phys_step_single` by default; :meth:`run` passes
        :meth:`_graphed_single`), in place: a chunk's input is let go as
        soon as its output is there, so the chunks hold about one state
        between them."""
        step = step or self._crm_phys_step_single
        for i in range(len(chunks)):
            chunks[i] = step(chunks[i])
        return chunks

    def _graphed_single(self) -> graph.GraphedFunction:
        """The compiled chunk step (cached on the driver), the counterpart
        of pam_tpu's ``_jitted_single`` (pam_tpu/driver/mmf.py:221-225):
        :meth:`_crm_phys_step_single` captured into one CUDA graph for the
        state's keys, shapes, dtypes and device and ``PAM_TRIDIAG``'s
        route (a new key captures again), its loops decided on the device.
        A call copies the state in, replays and returns fresh tensors; a
        CPU state takes the eager step; a capture that fails raises. Its
        ``check()`` raises a range check (AWFL's sub-cycle count) that
        failed in a replay."""
        if self.__dict__.get("_graph_single_cache") is None:
            # the route of a card's solves: auto takes PCR there
            self._graph_single_cache = graph.GraphedFunction(
                self._crm_phys_step_single,
                key=lambda: tridiag._TRIDIAG_MODE != "thomas")
        return self._graph_single_cache

    def crm_phys_step_hostchunked(self, state):
        """One CRM step of a multiple of the driver's ensemble by host
        dispatch (pam_tpu/driver/mmf.py:227-260): the compiled chunk step
        (:meth:`_graphed_single`) is replayed once a chunk, one graph for
        every chunk, the chunks split before and joined after. Bit for
        bit :meth:`crm_phys_step`, which runs the same chunks eagerly.
        Nothing here reads the device; ``_graphed_single().check()``
        raises a range check that failed."""
        n = self.n_chunks(state)
        step = self._graphed_single()
        if n == 1:
            return step(state)
        return _join_ens(self.step_chunks(list(_split_ens(state, n)), step))

    def run(self, state, sim_time: float, callback: Callable = None):
        """GCM loop over sim_time (driver.cpp:237-272); callback(state,
        elapsed) after every GCM step. Every CRM step replays the compiled
        step (:meth:`_graphed_single`), once a chunk, as pam_tpu's run
        dispatches its compiled step; the forcing, once a GCM step, stays
        eager. A state of several driver-sized chunks runs as ``mb_mode``
        says: "host" splits it once and runs every chunk through each GCM
        step (forcing, then the CRM steps), joining them for each callback
        and at the end; "unrolled" runs the eager :meth:`gcm_step` on the
        full state. The compiled step's range checks are read before each
        callback and at the end.

        ``state`` may also be a list of driver-sized chunk states (what
        ``_split_ens`` gives), which "host" takes over: it steps them in
        place and empties them into the joined result, so a caller that
        keeps no other reference to the state holds one copy of it
        besides a chunk's working set (run_mmf hands its state over so).
        "unrolled" joins such a list first."""
        nsteps_gcm = int(np.ceil(sim_time / self.dt_gcm))
        etime = 0.0
        if isinstance(state, list):
            for c in state:
                if int(c["temp"].shape[0]) != self.coupler.nens:
                    raise ValueError(
                        f"a chunk carries nens={int(c['temp'].shape[0])} but "
                        f"the driver was built with nens={self.coupler.nens};"
                        " micro-batching takes chunks of the driver's size")
            if self.mb_mode != "host":
                state = _join_ens(state)
        elif self.mb_mode == "host" and self.n_chunks(state) > 1:
            state = list(_split_ens(state, self.n_chunks(state)))
        step = self._graphed_single()
        ncrm = int(round(self.dt_gcm / self.dt_crm_phys))
        if isinstance(state, list):
            for _ in range(nsteps_gcm):
                if self.apply_gcm_forcing:
                    for i in range(len(state)):
                        state[i] = self._forcing(state[i])
                for _ in range(ncrm):
                    self.step_chunks(state, step)
                etime += self.dt_gcm
                if callback is not None:
                    step.check()
                    callback(_join_ens(state), etime)
            step.check()
            return _join_ens(state, consume=True)
        whole = self.n_chunks(state) == 1
        for _ in range(nsteps_gcm):
            state = self.gcm_step(state, step if whole else None)
            etime += self.dt_gcm
            if callback is not None:
                step.check()
                callback(state, etime)
        step.check()
        return state


def setup_supercell_mmf(nx=65, ny=1, nz=50, nens=1, xlen=128000.0,
                        ylen=64000.0, zlen=20000.0, dtype=torch.float64,
                        micro="kessler", sgs="none", dt_gcm=900.0,
                        dt_crm_phys=20.0, perturb_seeds=None,
                        dycore="awfl", crm_per_phys=1,
                        zint=None, dycore_kwargs=None, micro_kwargs=None,
                        state_only=False, device="cuda"):
    """The MMF configuration of inputs/input_pamc.yaml (65x1x50 cells,
    128 km x 64 km, 20 km top) from the supercell column, on ``device``
    in ``dtype``, with pam_tpu's defaults: dycore="awfl" (PAM-A,
    acoustically sub-cycled SSPRK3) or "spam" (PAM-C, MCE_rho,
    semi-implicit with dt_si = dt_crm_phys/crm_per_phys, the reference
    coupled defaults, core/params.h:120-165), with micro="kessler" or
    "p3" and sgs="none" or "shoc" (P3+SHOC is the reference's production
    physics, configs/input_mmf_production.yaml).

    ``zint``: the nz+1 interface heights (a stretched grid, as
    driver/standalone.py::build_zint gives), uniform over zlen if None.
    ``perturb_seeds``: one seed per member, np.arange(nens) if None.
    ``dycore_kwargs`` go to AwflDycore.build or SpamDycore.build_coupled,
    ``micro_kwargs`` to the microphysics object. Returns (driver, state);
    ``state_only=True`` skips the SPAM dycore build and returns
    (None, state) with the same state."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r}: torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    if dycore not in ("spam", "awfl"):
        raise ValueError(f"unknown dycore {dycore!r}")
    micro_mod = {"kessler": kessler, "p3": p3}.get(micro)
    if micro_mod is None:
        # pam_tpu accepts "none" and then fails further on, in either
        # dycore, because no tracer is registered
        raise ValueError(f"micro={micro!r}: the port runs 'kessler' or "
                         "'p3' (a coupled run needs the water tracers)")
    if sgs not in ("none", "shoc"):
        raise ValueError(f"unknown sgs scheme {sgs!r}")
    cpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=xlen, ylen=ylen,
                  dtype=dtype, device=torch.device(device))
    cpl = micro_mod.register(cpl)
    if sgs == "shoc":
        cpl = shoc.register(cpl)

    # vertical interfaces: the caller's (stretched vcoords grids,
    # driver.cpp:135-170) or uniform
    if zint is None:
        zint = np.linspace(0.0, zlen, nz + 1)
    else:
        zint = np.asarray(zint, np.float64)
        if zint.shape != (nz + 1,):
            raise ValueError(f"zint has shape {zint.shape}; nz={nz} needs "
                             f"{nz + 1} interface heights")
    state = cpl.allocate_state(zint)
    state = supercell_column.initialize_from_supercell_column(cpl, state,
                                                              zint)
    state = broadcast_initial_gcm_column(cpl, state)
    seeds = perturb_seeds if perturb_seeds is not None else np.arange(nens)
    state = perturb_temperature(cpl, state, np.asarray(seeds))

    dyc = None
    if dycore == "awfl":
        # built even under state_only: the hydrostatic declaration is part
        # of the initial state
        dyc = AwflDycore.build(cpl, np.diff(zint), **(dycore_kwargs or {}))
        state = dyc.declare_current_profile_as_hydrostatic(state)
    elif not state_only:
        dyc = SpamDycore.build_coupled(cpl, state, zint,
                                       dt_si=dt_crm_phys / crm_per_phys,
                                       **(dycore_kwargs or {}))
    state = micro_mod.init_state(cpl, state)
    if micro == "p3":
        micro_obj = p3.P3Micro(cpl, sgs_shoc=(sgs == "shoc"),
                               **(micro_kwargs or {}))
    else:
        micro_obj = kessler.KesslerMicro(cpl, **(micro_kwargs or {}))

    sgs_obj = None
    if sgs == "shoc":
        state = shoc.init_state(cpl, state)
        # reference pressures for the PBL depth cap (SGS.h:169-178 uses
        # the hydrostatic reference profile), top-down; as in pam_tpu the
        # SPAM setup leaves hy_pressure_cells at zero, so npbl is 1 (AWFL
        # fills it)
        pref = state["hy_pressure_cells"][0].flip(0).cpu().numpy()
        sgs_obj = shoc.ShocSgs.build(cpl, pref_mid=pref)
    if state_only:
        return None, state
    drv = MmfDriver(coupler=cpl, dycore=dyc, micro=micro_obj, sgs=sgs_obj,
                    dt_gcm=dt_gcm, dt_crm_phys=dt_crm_phys)
    return drv, state

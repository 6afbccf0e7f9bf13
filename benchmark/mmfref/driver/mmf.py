"""The MMF step of one chunk of CRMs: apply the GCM forcing, the dycore
(SPAM+SI or AWFL), the sponge, the SGS scheme and the microphysics (ref
standalone/mmf_simplified/driver.cpp:237-272), and the supercell set-up
of a chunk's driver and state; every loop runs on the host."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ..core.coupler import Coupler
from ..dycore.awfl import AwflDycore
from ..modules import gcm_forcing, sponge
from ..modules.broadcast import broadcast_initial_gcm_column
from ..modules.perturb import perturb_temperature
from ..physics import kessler, p3
from ..physics.sgs import shoc
from ..spam.dycore import SpamDycore
from . import supercell_column


@dataclasses.dataclass(eq=False)
class MmfDriver:
    """Composes the dycore and the physics into a CRM step."""
    coupler: Coupler
    dycore: Any
    micro: Any = None
    sgs: Any = None
    rad: Any = None
    apply_sponge: bool = True
    apply_gcm_forcing: bool = True
    dt_gcm: float = 900.0
    dt_crm_phys: float = 20.0

    def forcing(self, state):
        """The GCM forcing tendencies of ``state``, stored in it."""
        return gcm_forcing.compute_gcm_forcing_tendencies(
            self.coupler, state, self.dt_gcm)

    def crm_phys_step(self, state):
        # the pam: spans name the layers in a torch.profiler trace
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


def setup_supercell_mmf(nx=65, ny=1, nz=50, nens=1, xlen=128000.0,
                        ylen=64000.0, zlen=20000.0, dtype=torch.float64,
                        micro="kessler", sgs="none", dt_gcm=900.0,
                        dt_crm_phys=20.0, perturb_seeds=None,
                        dycore="spam", crm_per_phys=1,
                        zint=None, dycore_kwargs=None, micro_kwargs=None,
                        state_only=False, device="cuda", noise_dtype=None):
    """The MMF configuration of inputs/input_pamc.yaml from the supercell
    column, on ``device`` in ``dtype``: dycore="spam" (PAM-C, MCE_rho,
    semi-implicit with dt_si = dt_crm_phys/crm_per_phys) or "awfl"
    (PAM-A, acoustically sub-cycled SSPRK3), with micro="kessler" or "p3"
    and sgs="none" or "shoc".

    ``zint``: the nz+1 interface heights, uniform over zlen if None.
    ``perturb_seeds``: one seed per member, np.arange(nens) if None;
    ``noise_dtype``: the dtype the perturbation is drawn in (``dtype`` if
    None).
    Returns (driver, state); ``state_only=True`` skips the SPAM dycore
    build and returns (None, state) with the same state."""
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
    state = perturb_temperature(cpl, state, np.asarray(seeds),
                                noise_dtype=noise_dtype)

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

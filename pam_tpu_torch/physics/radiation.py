"""Forced radiation: apply an externally computed enthalpy tendency (port
of pam_tpu/physics/radiation.py; ref physics/radiation/forced/
radiation.h).

The GCM (or an external radiation calculation) supplies
``rad_enthalpy_tend`` on a coarse (rad_ny, rad_nx) grid; each CRM column
takes the tendency of the coarse cell that contains it (:40-44).
"""

from __future__ import annotations

import dataclasses

from ..core.coupler import Coupler


def register(coupler: Coupler, rad_nx: int = 1, rad_ny: int = 1) -> Coupler:
    """(ref: Radiation::init, radiation.h:16-24)."""
    return coupler.with_options(radiation="forced", rad_nx=rad_nx,
                                rad_ny=rad_ny)


def init_state(coupler: Coupler, state):
    out = dict(state)
    if "rad_enthalpy_tend" not in out:
        out["rad_enthalpy_tend"] = coupler._zeros(
            coupler.nens, coupler.nz, coupler.get_option("rad_ny", 1),
            coupler.get_option("rad_nx", 1))
    return out


@dataclasses.dataclass(frozen=True)
class ForcedRadiation:
    """(Radiation::timeStep, radiation.h:26-45)."""
    coupler: Coupler

    @property
    def name(self) -> str:
        return "forced"

    def timestep(self, state, dt):
        cpl = self.coupler
        tend = state["rad_enthalpy_tend"]     # (nens, nz, rad_ny, rad_nx)
        # expand the coarse radiation grid onto the CRM grid (:41-43)
        fx = cpl.nx // cpl.get_option("rad_nx", 1)
        fy = cpl.ny // cpl.get_option("rad_ny", 1)
        tend_full = tend.repeat_interleave(fy, dim=2).repeat_interleave(
            fx, dim=3)
        out = dict(state)
        out["temp"] = state["temp"] + tend_full / cpl.const.cp_d * dt
        return out

"""The coupler: static configuration plus a dict of tensors
(port of pam_tpu/core/coupler.py; ref pam_core/pam_coupler.h).

* :class:`Coupler` — grid sizes, domain lengths, constants, tracer
  metadata, options, and the run's ``device`` and ``dtype``.
* ``state`` — a plain ``dict[str, torch.Tensor]``. Functions of the port
  return new dicts and never write into the tensors they were given.

Layout as in ``pam_tpu``: 3-D fields ``(nens, nz, ny, nx)``, columns
``(nens, nz)`` / ``(nens, nz+1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .constants import Constants, DEFAULT_CONSTANTS


@dataclasses.dataclass(frozen=True)
class Tracer:
    """Tracer metadata (ref: PamCoupler::Tracer, pam_coupler.h:26-31)."""
    name: str
    desc: str = ""
    positive: bool = True
    adds_mass: bool = True


# Canonical 3-D prognostic fields (ref: pam_coupler.h:259-263)
STATE_3D = ("density_dry", "uvel", "vvel", "wvel", "temp")
# GCM column fields (ref: pam_coupler.h:268-281)
GCM_COLS = ("gcm_density_dry", "gcm_uvel", "gcm_vvel", "gcm_wvel", "gcm_temp",
            "gcm_water_vapor", "gcm_cloud_water", "gcm_cloud_ice",
            "gcm_num_liq", "gcm_num_ice", "gcm_num_rain", "gcm_pressure_mid")
# Reference-state columns (ref: pam_coupler.h:283-289)
REF_COLS = ("ref_pres", "ref_density_dry", "ref_density_vapor",
            "ref_density_liq", "ref_density_ice", "ref_temp")


@dataclasses.dataclass(frozen=True, eq=False)
class Coupler:
    """Static configuration & tracer registry; the dynamic state is a dict."""
    nz: int
    ny: int
    nx: int
    nens: int
    xlen: float
    ylen: float
    dtype: torch.dtype
    device: torch.device
    const: Constants = DEFAULT_CONSTANTS
    tracers: tuple[Tracer, ...] = ()
    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---- tracer registry (ref: pam_coupler.h:206-251) ----
    def add_tracer(self, name: str, desc: str = "", positive: bool = True,
                   adds_mass: bool = True) -> "Coupler":
        if any(t.name == name for t in self.tracers):
            return self
        return dataclasses.replace(
            self, tracers=self.tracers + (Tracer(name, desc, positive,
                                                 adds_mass),))

    @property
    def tracer_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tracers)

    @property
    def tracer_positive(self) -> np.ndarray:
        return np.array([t.positive for t in self.tracers])

    def with_options(self, **kw) -> "Coupler":
        opts = dict(self.options)
        opts.update(kw)
        return dataclasses.replace(self, options=opts)

    # ---- state construction ----
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def zeros3d(self) -> torch.Tensor:
        return self._zeros(self.nens, self.nz, self.ny, self.nx)

    def zeros_col(self, stag: bool = False) -> torch.Tensor:
        return self._zeros(self.nens, self.nz + (1 if stag else 0))

    def allocate_state(self, zint) -> dict[str, torch.Tensor]:
        """Canonical initial state dict (ref: allocate_coupler_state,
        pam_coupler.h:255-355, plus set_grid, pam_coupler.h:163-202).

        zint: vertical interface heights, shape (nz+1,) or (nens, nz+1)."""
        zint = torch.as_tensor(np.asarray(zint), dtype=self.dtype,
                               device=self.device)
        if zint.ndim == 1:
            zint = zint.expand(self.nens, self.nz + 1)
        state: dict[str, torch.Tensor] = {}
        for name in STATE_3D + self.tracer_names:
            state[name] = self.zeros3d()
        state["vertical_interface_height"] = zint
        state["vertical_cell_dz"] = zint[:, 1:] - zint[:, :-1]
        state["vertical_midpoint_height"] = 0.5 * (zint[:, 1:] + zint[:, :-1])
        for name in GCM_COLS + REF_COLS:
            state[name] = self.zeros_col()
        state["ref_presi"] = self.zeros_col(stag=True)
        state["gcm_pressure_int"] = self.zeros_col(stag=True)
        # hydrostatic background columns of the AWFL dycore (Dycore.h:868)
        for name in ("hy_dens_cells", "hy_pressure_cells",
                     "variable_gravity"):
            state[name] = self.zeros_col()
        return state

    def pressure(self, state) -> torch.Tensor:
        """Moist pressure from dry density, vapor and temperature
        (ref: PamCoupler::compute_pressure_array, pam_coupler.h:360-393)."""
        c = self.const
        return (state["density_dry"] * c.R_d +
                state["water_vapor"] * c.R_v) * state["temp"]


def hmean(x: torch.Tensor) -> torch.Tensor:
    """Horizontal mean over (ny, nx) of an (nens, nz, ny, nx) field ->
    (nens, nz) (ref: the atomicAdd column averages, gcm_forcing.h:101-129)."""
    return torch.mean(x, dim=(-2, -1))

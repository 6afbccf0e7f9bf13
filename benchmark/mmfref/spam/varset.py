"""Variable sets: density bookkeeping for the SPAM model variants (port of
pam_tpu/spam/varset.py; ref dynamics/spam/src/hamiltonians/variableset.h).

dens layout ``(ndensity, nens, nz, nx)`` (slab) or ``(ndensity, nens,
nz, ny, nx)`` (3-D) of twisted n-forms: 0 = rho (total mass), 1 = S
(entropic density), then the physics tracers.
Variant CE is dry compressible Euler (rho, S; VS_CE:50-65), MCE_rho
moist compressible Euler predicting total rho (VS_MCE_rho:108-130).
``pam_tpu``'s default variant is CE; the coupled model passes MCE_rho.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class VariableSet:
    variant: str = "CE"            # "CE" or "MCE_rho"
    tracer_names: tuple = ()       # physics tracer names, in dens order 2..
    tracer_positive: tuple = ()
    geom: object = None            # ExtrudedGeometry
    thermo: object = None

    dens_id_mass = 0
    dens_id_entr = 1
    active_id_mass = 0
    active_id_entr = 1

    @property
    def ntracers_physics(self):
        return len(self.tracer_names)

    @property
    def ndensity(self):
        return 2 + self.ntracers_physics

    @property
    def ndensity_active(self):
        return 2

    @property
    def dens_pos(self) -> np.ndarray:
        return np.array([False, False] + list(self.tracer_positive))

    @property
    def dens_id_vap(self):
        return 2 + self.tracer_names.index("water_vapor")

    @property
    def liq_found(self):
        return any(n in ("cloud_liquid", "cloud_water")
                   for n in self.tracer_names)

    @property
    def ice_found(self):
        return "ice" in self.tracer_names

    @property
    def dens_id_liq(self):
        for n in ("cloud_liquid", "cloud_water"):
            if n in self.tracer_names:
                return 2 + self.tracer_names.index(n)
        raise KeyError("no liquid tracer")

    @property
    def dens_id_ice(self):
        return 2 + self.tracer_names.index("ice")

    # ---- accessors (variableset.h VS_CE/VS_MCE_rho specializations) ----
    def get_total_density(self, dens):
        return dens[self.dens_id_mass]

    def get_entropic_var(self, dens):
        return dens[self.dens_id_entr] / dens[self.dens_id_mass]

    def get_alpha(self, dens):
        area = self.geom.area_n1_t
        # (nens, nz) over the horizontal dims: (nens, nz, nx) in the slab,
        # (nens, nz, ny, nx) in 3-D
        area = area.reshape(area.shape + (1,) * (dens[0].ndim - area.ndim))
        return area / dens[self.dens_id_mass]

    def _water_dens(self, dens):
        w = dens[self.dens_id_vap]
        if self.liq_found:
            w = w + dens[self.dens_id_liq]
        if self.ice_found:
            w = w + dens[self.dens_id_ice]
        return w

    def get_qv(self, dens):
        return dens[self.dens_id_vap] / dens[self.dens_id_mass]

    def get_ql(self, dens):
        return dens[self.dens_id_liq] / dens[self.dens_id_mass]

    def get_qi(self, dens):
        return dens[self.dens_id_ice] / dens[self.dens_id_mass]

    def get_qd(self, dens):
        if self.variant == "CE":
            return torch.ones_like(dens[0])
        return (dens[self.dens_id_mass] - self._water_dens(dens)) / \
            dens[self.dens_id_mass]

    def get_dry_density(self, dens):
        if self.variant == "CE":
            return dens[self.dens_id_mass]
        return dens[self.dens_id_mass] - self._water_dens(dens)

    def moist_qs(self, dens):
        """(qd, qv, ql, qi) with zeros for absent species."""
        if self.variant == "CE":
            z = torch.zeros_like(dens[0])
            return torch.ones_like(dens[0]), z, z, z
        qv = self.get_qv(dens)
        ql = self.get_ql(dens) if self.liq_found else torch.zeros_like(qv)
        qi = self.get_qi(dens) if self.ice_found else torch.zeros_like(qv)
        return self.get_qd(dens), qv, ql, qi

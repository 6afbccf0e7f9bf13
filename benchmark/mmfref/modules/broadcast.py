"""Broadcast GCM initial columns into every CRM cell (port of
pam_tpu/modules/broadcast.py; ref pam_core/modules/
broadcast_initial_gcm_column.h)."""

from __future__ import annotations

from ..core.coupler import Coupler

_PAIRS = (("density_dry", "gcm_density_dry"),
          ("uvel", "gcm_uvel"),
          ("vvel", "gcm_vvel"),
          ("wvel", "gcm_wvel"),
          ("temp", "gcm_temp"),
          ("water_vapor", "gcm_water_vapor"))


def broadcast_initial_gcm_column(coupler: Coupler, state):
    """Ref: broadcast_initial_gcm_column.h:8-41."""
    out = dict(state)
    shape = (coupler.nens, coupler.nz, coupler.ny, coupler.nx)
    for crm, gcm in _PAIRS:
        out[crm] = state[gcm][:, :, None, None].expand(shape).contiguous()
    return out


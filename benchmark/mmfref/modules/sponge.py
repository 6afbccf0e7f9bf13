"""Top-of-domain sponge layer: relax toward the horizontal mean (port of
pam_tpu/modules/sponge.py; ref pam_core/modules/sponge_layer.h:9-99)."""

from __future__ import annotations

import math

import torch

from ..core.coupler import Coupler, hmean


def sponge_layer(coupler: Coupler, state, dt, num_layers: int = 5,
                 time_scale: float = 60.0):
    """Relax the top ``num_layers`` levels toward their horizontal mean
    (w toward zero) with a cosine profile and strength dt/time_scale;
    the defaults are the reference's options (sponge_num_layers=5,
    sponge_time_scale=60 s)."""
    out = dict(state)
    nz = coupler.nz
    zint = state["vertical_interface_height"]
    zmid = state["vertical_midpoint_height"]
    ztop = zint[:, nz:nz + 1]                         # (nens, 1)
    zref = zmid[:, nz - num_layers:nz - num_layers + 1]
    rel_dist = (ztop - zmid) / (ztop - zref)          # (nens, nz)
    space_factor = (torch.cos(math.pi * rel_dist) + 1.0) / 2.0
    k = torch.arange(nz, device=zmid.device)
    active = (k >= nz - num_layers)[None, :]
    factor = torch.where(active, space_factor * (dt / time_scale),
                         torch.zeros_like(space_factor))
    factor = factor[:, :, None, None]
    for name in ("density_dry", "uvel", "vvel", "wvel", "temp") + \
            tuple(coupler.tracer_names):
        f = state[name]
        target = torch.zeros_like(f) if name == "wvel" \
            else hmean(f)[:, :, None, None]  # w relaxes to 0 (WFLD)
        out[name] = f + (target - f) * factor
    return out

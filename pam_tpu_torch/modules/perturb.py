"""Seeded temperature perturbations to break CRM ensemble symmetry (port
of pam_tpu/modules/perturb.py; ref pam_core/modules/
perturb_temperature.h:10-64).

Uniform noise in [-1, 1) in the bottom nz/4 levels, amplitude tapered
with height, then a per-level multiplicative rescale that conserves the
horizontal-mean temperature. Each member draws from its own
``torch.Generator`` seeded with its seed, so members are reproducible
independently of the batch. The draws are not JAX's threefry bits
(ROADMAP queue A lists bitwise parity as open).
"""

from __future__ import annotations

import torch

from ..core.coupler import Coupler, hmean


def perturb_temperature(coupler: Coupler, state, seeds,
                        magnitude: float = 0.1):
    """seeds: (nens,) integers, one per CRM (unique within the batch)."""
    out = dict(state)
    nz = coupler.nz
    num_levels = nz // 4
    temp = state["temp"]
    hmean1 = hmean(temp)
    rand = torch.stack([
        torch.rand((nz, coupler.ny, coupler.nx), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(int(s)))
        for s in seeds]) * 2.0 - 1.0
    rand = rand.to(dtype=temp.dtype, device=temp.device)
    k = torch.arange(nz, device=temp.device)
    scaling = torch.where(k < num_levels,
                          (num_levels - k.to(temp.dtype)) / num_levels,
                          torch.zeros((), dtype=temp.dtype,
                                      device=temp.device))
    temp = temp + rand * magnitude * scaling[None, :, None, None]
    # per-level conservation rescale (ref: perturb_temperature.h:57-61)
    hmean2 = hmean(temp)
    ratio = torch.where((k < num_levels)[None, :], hmean1 / hmean2,
                        torch.ones_like(hmean1))
    out["temp"] = temp * ratio[:, :, None, None]
    return out

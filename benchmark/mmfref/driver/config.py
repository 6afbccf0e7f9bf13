"""A configuration's settings (the keys of ``configs/input_mmf_*.yaml``)
as the reference reads them: the vertical grid and the arguments of
``setup_supercell_mmf``."""

from __future__ import annotations

import numpy as np
import torch


def build_zint(run: dict) -> np.ndarray:
    """The "uniform" interfaces of the reference's driver
    (driver.cpp:137-155): nz - 1 cells of zlen / (nz - 1), with the first
    and the last cut in half."""
    if run.get("vcoords", "uniform") != "uniform":
        raise ValueError("the reference builds the uniform grid only")
    nz = run["crm_nz"]
    zlen = run.get("zlen", 20000.0)
    dz = zlen / (nz - 1)
    zint = np.empty(nz + 1)
    zint[0] = 0.0
    zint[-1] = zlen
    zint[1:-1] = np.arange(1, nz) * dz - dz / 2
    return zint


def dtype(run: dict) -> torch.dtype:
    """The configuration's precision: float64 unless ``f64`` is false."""
    return torch.float64 if run.get("f64", True) else torch.float32


def setup_kwargs(run: dict, nens: int, dtype: torch.dtype, device) -> dict:
    """The arguments of ``driver.mmf.setup_supercell_mmf`` for ``nens``
    members in ``dtype``."""
    zint = build_zint(run)
    return dict(
        nx=run["crm_nx"], ny=run.get("crm_ny", 1), nz=len(zint) - 1,
        nens=nens, xlen=run["xlen"], ylen=run.get("ylen", 64000.0),
        zlen=float(zint[-1]), micro=run.get("micro", "kessler"),
        sgs=run.get("sgs", "none"), dt_gcm=run["dt_gcm"],
        dt_crm_phys=run["dt_crm_phys"], dycore=run.get("dycore", "spam"),
        crm_per_phys=run.get("crm_per_phys", 1), zint=zint, dtype=dtype,
        device=device)

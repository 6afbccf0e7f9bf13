"""Extruded primal/dual geometry for the SPAM dycore, the x-z slab and
the 3-D x-y-z grid (port of pam_tpu/spam/geometry.py; ref
dynamics/spam/src/grids/{topology.h, geometry.h}).

Dual (twisted) grid: nz layers, nz+1 interfaces (``zint_d``, ``dz_d``).
Primal (straight): nz-1 layers between nz interfaces at the dual-layer
midpoints, except the first/last on the boundaries (geometry.h:303-317).
The horizontal grid is uniform and periodic: x alone in the slab
(ndims=1, dy = 1, geometry.h:282-288), x and y in 3-D (ndims=2, ny > 1,
dy = ylen / ny). The numpy arrays are the float64 setup values; the
``*_t`` tensors are the same values cast once to the run's dtype and
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.mesh import per_member


@dataclasses.dataclass(frozen=True, eq=False)
class ExtrudedGeometry:
    nx: int
    nz: int           # dual layers (= CRM nz)
    nens: int
    xlen: float
    dx: float
    dy: float         # 1.0 for ndims=1, ylen / ny for ndims=2
    uniform_vertical: bool
    zint_d: np.ndarray = per_member(0)  # (nens, nz+1) twisted interfaces
    dz_d: np.ndarray = per_member(0)  # (nens, nz)   twisted layer thicknesses
    # (nens, nz)   straight interfaces (v-levels)
    zint_p: np.ndarray = per_member(0)
    # (nens, nz-1) straight layer thicknesses (w-edges)
    dz_p: np.ndarray = per_member(0)
    dtype: torch.dtype
    device: torch.device
    dz_d_t: torch.Tensor = per_member(0)  # dz_d as run tensor
    dz_p_t: torch.Tensor = per_member(0)  # dz_p as run tensor
    area_n1_t: torch.Tensor = per_member(0)  # d_area_n1() as run tensor
    area_nm11_t: torch.Tensor = per_member(0)  # d_area_nm11() as run tensor
    ny: int = 1       # ndims=2 (3-D x-y-z) when > 1
    ylen: float = 1.0

    def d_area_n0(self):
        """dual (n,0) = horizontal face: dx*dy (scalar)."""
        return self.dx * self.dy

    @property
    def zmid_d(self):
        return 0.5 * (self.zint_d[:, :-1] + self.zint_d[:, 1:])

    @staticmethod
    def build(nx: int, zint, xlen: float, nens: int, dtype: torch.dtype,
              device) -> "ExtrudedGeometry":
        zint = np.asarray(zint, np.float64)
        if zint.ndim == 1:
            zint = np.broadcast_to(zint, (nens, len(zint))).copy()
        nz = zint.shape[1] - 1
        dz_d = np.diff(zint, axis=1)
        uniform = bool(np.allclose(dz_d, dz_d[:, :1]))
        # straight interfaces (geometry.h:303-317)
        zint_p = np.empty((nens, nz))
        zint_p[:, 0] = zint[:, 0]
        zint_p[:, -1] = zint[:, -1]
        zint_p[:, 1:-1] = 0.5 * (zint[:, 1:-2] + zint[:, 2:-1])
        dz_p = np.diff(zint_p, axis=1)
        dx, dy = xlen / nx, 1.0
        T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return ExtrudedGeometry(
            nx=nx, nz=nz, nens=nens, xlen=xlen, dx=dx, dy=dy,
            uniform_vertical=uniform, zint_d=zint, dz_d=dz_d, zint_p=zint_p,
            dz_p=dz_p, dtype=dtype, device=torch.device(device),
            dz_d_t=T(dz_d), dz_p_t=T(dz_p), area_n1_t=T(dx * dy * dz_d),
            area_nm11_t=T(dy * dz_d))

"""WENO vertical column interpolation: cell averages -> interface values
(port of pam_tpu/core/vinterp.py).

Parity reference: pam_core/vertical_interp.h — variable-grid WENO with flat
ideal weights [1,...,1,1000] (convexified), full (untruncated) Jiang-Shu
smoothness indicators, no weight mapping, ghost cells extrapolated with
uniform spacing, BC_ZERO_GRADIENT / BC_ZERO_VALUE boundary handling, and
edge reconciliation by simple averaging of the two one-sided estimates.

Used for GCM <-> CRM vertical grid mapping in MMF coupling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import recon_matrices as rm

BC_ZERO_GRADIENT = 0
BC_ZERO_VALUE = 1


@functools.cache
def _idl(ord: int) -> np.ndarray:
    hs = (ord - 1) // 2
    idl = np.ones(hs + 2)
    idl[-1] = 1000.0
    return idl / idl.sum()


def build_matrices(zint: np.ndarray, ord: int = 5):
    """Per-cell variable-grid reconstruction matrices
    (ref: VerticalInterp::init, vertical_interp.h:149-211); numpy.

    zint: (nz+1,) or (nens, nz+1) interface heights. Returns (recon_hi,
    recon_lo): (nens, nz, ord, ord) [c, s] and (nens, nz, hs+1, hs+1,
    hs+1) [i, s, c]."""
    zint = np.asarray(zint, np.float64)
    if zint.ndim == 1:
        zint = zint[None]
    nens, nzp1 = zint.shape
    nz = nzp1 - 1
    hs = (ord - 1) // 2
    # ghost interfaces: uniform extrapolation (ref :157-168)
    dz0 = (zint[:, 1] - zint[:, 0])[:, None]
    dzt = (zint[:, -1] - zint[:, -2])[:, None]
    gl = zint[:, :1] - dz0 * np.arange(hs, 0, -1)[None, :]
    gt = zint[:, -1:] + dzt * np.arange(1, hs + 1)[None, :]
    zg = np.concatenate([gl, zint, gt], axis=1)
    hi = np.empty((nens, nz, ord, ord))
    lo = np.empty((nens, nz, hs + 1, hs + 1, hs + 1))
    for e in range(nens):
        for k in range(nz):
            locs = zg[e, k:k + ord + 1].copy()
            zmid = 0.5 * (locs[hs] + locs[hs + 1])
            dzmid = locs[hs + 1] - locs[hs]
            locs = (locs - zmid) / dzmid
            hi[e, k] = rm.sten_to_coefs(locs)
            lo[e, k] = rm.weno_lower_sten_to_coefs(locs)
    return hi, lo


def cells_to_edges(data: torch.Tensor, zint,
                   bc_lower: int = BC_ZERO_GRADIENT,
                   bc_upper: int = BC_ZERO_GRADIENT, ord: int = 5,
                   matrices=None) -> torch.Tensor:
    """Interpolate (nens, nz, ...) cell-average columns to (nens, nz+1, ...)
    interface values (ref: cells_to_edges, vertical_interp.h:52-120).

    ``data`` may have trailing spatial axes after the level axis (dim 1).
    ``matrices``: build_matrices(zint, ord), to build them once."""
    nz = data.shape[1]
    hs = (ord - 1) // 2
    if matrices is None:
        matrices = build_matrices(np.asarray(zint), ord)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=data.dtype,
                                  device=data.device)
    hi, lo = (T(m) for m in matrices)

    # ghost-cell stencil values per BC
    bot = data[:, :1].repeat_interleave(hs, dim=1)
    if bc_lower != BC_ZERO_GRADIENT:
        bot = torch.zeros_like(bot)
    top = data[:, -1:].repeat_interleave(hs, dim=1)
    if bc_upper != BC_ZERO_GRADIENT:
        top = torch.zeros_like(top)
    pad = torch.cat([bot, data, top], dim=1)
    # stencils per cell: (nens, nz, ..., ord)
    sten = torch.stack([pad[:, s:s + nz] for s in range(ord)], dim=-1)

    idl = T(_idl(ord))
    tvM_hi = T(rm.tv_quadform(ord, truncate=False))
    tvM_lo = T(rm.tv_quadform(hs + 1, truncate=False))
    # expand the matrices over the trailing spatial dims; the leading dim
    # broadcasts (a shared 1-D zint builds nens=1 matrices for nens>1 data)
    extra = data.ndim - 2
    sh = (data.shape[0], nz) + (1,) * extra
    hi_b = hi.reshape((hi.shape[0], nz) + (1,) * extra + (ord, ord)).expand(
        sh + (ord, ord))
    lo_b = lo.reshape((lo.shape[0], nz) + (1,) * extra +
                      (hs + 1, hs + 1, hs + 1)).expand(
        sh + (hs + 1, hs + 1, hs + 1))

    # WENO combination (ref: compute_weno_coefs, vertical_interp.h:287-349;
    # no weight mapping, eps=1e-20)
    uw = torch.stack([sten[..., i:i + hs + 1] for i in range(hs + 1)],
                     dim=-2)
    a_lo = torch.einsum('...is,...isc->...ic', uw, lo_b)
    a_hi = torch.einsum('...s,...cs->...c', sten, hi_b)
    a_lo_full = torch.nn.functional.pad(a_lo, (0, ord - hs - 1))
    a_br = (a_hi - torch.einsum('i,...ic->...c', idl[:hs + 1], a_lo_full)) \
        / idl[-1]
    tv_lo = torch.einsum('...ic,cd,...id->...i', a_lo, tvM_lo, a_lo)
    tv_br = torch.einsum('...c,cd,...d->...', a_br, tvM_hi, a_br)
    tv = torch.cat([tv_lo, tv_br[..., None]], dim=-1)
    wts = idl / (tv * tv + 1.0e-20)
    wts = wts / wts.sum(dim=-1, keepdim=True)
    coefs = wts[..., -1:] * a_br + \
        torch.einsum('...i,...ic->...c', wts[..., :-1], a_lo_full)

    # evaluate at cell edges z = -1/2 (bottom) and +1/2 (top)
    val_bot = torch.einsum('...c,c->...', coefs, T((-0.5) ** np.arange(ord)))
    val_top = torch.einsum('...c,c->...', coefs, T(0.5 ** np.arange(ord)))
    # two estimates per interior edge -> average (ref :115-119)
    interior = 0.5 * (val_top[:, :-1] + val_bot[:, 1:])
    bottom = val_bot[:, :1]
    if bc_lower == BC_ZERO_VALUE:
        bottom = torch.zeros_like(bottom)
    topv = val_top[:, -1:]
    if bc_upper == BC_ZERO_VALUE:
        topv = torch.zeros_like(topv)
    return torch.cat([bottom, interior, topv], dim=1)

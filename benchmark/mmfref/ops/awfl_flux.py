"""The AWFL directional flux in plain PyTorch: a frozen copy of
``pam_tpu_torch/ops/awfl_flux.py::flux_direction_reference`` (the CPU
route of kernel B3) and of the face reconstructions it calls from
``pam_tpu_torch/ops/weno.py`` (``reconstruct_faces_both``,
``reconstruct_faces_upwind``), over this reference's WENO limiter
(``weno._weno_candidates_and_weights``).

For one direction, at every face: the WENO values of rho*u_n and of the
pressure from both sides, the acoustic characteristic split at the frozen
sound speed, the rigid-lid mask in z, then for u, v, w, theta and every
tracer one upwind-selected WENO value times the mass flux, with the
pressure added to the flux of the normal momentum (ref:
dynamics/awfl/Dycore.h:334-519).

Arrays are in the dycore's layout ``(nvar, nens, ny, nz, nx)``; the
inputs of one direction are padded by ``HS`` cells on each side of that
direction's axis only.

Departures from the port: no kernel route (every device takes this
one); :class:`LevelMatrices` holds the plain version's two tensors and
not the kernel's packed set; the per-level matrices are built here
(:func:`vertical_recon_matrices`) from ``recon_matrices``' stencil
maps."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import recon_matrices as rm
from . import weno

CS = 350.0  # frozen acoustic characteristic speed (ref: Dycore.h:335)
AX_Z, AX_X = 3, 4               # axes of (nvar, nens, ny, nz, nx)
ORD = 5
HS = (ORD + 1) // 2
# per direction: index of the normal momentum among (u, v, w); the
# 2-D slab's x and z only
_MOM_Q = {AX_X: 0, AX_Z: 2}


def vertical_recon_matrices(dz: np.ndarray, ord: int) -> tuple:
    """Per-interface variable-grid reconstruction matrices of a
    stretched column (ref: the per-level setup of dynamics/awfl/
    Dycore.h:897-940): matrix ``k`` (0..nz+1) has the ord-cell stencil
    of cells ``k-1-(ord//2) .. k-1+(ord//2)`` clamped into [0, nz-1],
    widths over the central cell's (cell ``k-1``, clamped), centred on
    it. dz: (nz,) or (nens, nz). Returns (s2c, wrl) of shapes
    (..., nz+2, ord, ord) and (..., nz+2, hs, hs, hs)."""
    dz = np.asarray(dz, dtype=np.float64)
    squeeze = dz.ndim == 1
    if squeeze:
        dz = dz[None, :]
    nens, nz = dz.shape
    hs = (ord + 1) // 2
    half = ord // 2
    s2c = np.empty((nens, nz + 2, ord, ord))
    wrl = np.empty((nens, nz + 2, hs, hs, hs))
    for e in range(nens):
        for k in range(nz + 2):
            center = min(nz - 1, max(0, k - 1))
            cells = [min(nz - 1, max(0, k - 1 - half + kk))
                     for kk in range(ord)]
            dzloc = dz[e, cells] / dz[e, center]
            locs = np.concatenate(([0.0], np.cumsum(dzloc)))
            locs -= 0.5 * (locs[half] + locs[half + 1])
            s2c[e, k] = rm.sten_to_coefs(locs)
            wrl[e, k] = rm.weno_lower_sten_to_coefs(locs)
    if squeeze:
        return s2c[0], wrl[0]
    return s2c, wrl


@dataclasses.dataclass(frozen=True)
class LevelMatrices:
    """Per-level reconstruction matrices of the vertical grid for
    ``members`` = nens members or 1 (one set for every member): s2c
    (ord, ord, members, 1, nz+2, 1) and wrl (hs, hs, hs, members, 1,
    nz+2, 1), matrix dims leading, the level axis at -2 of the dycore's
    layout."""
    s2c: torch.Tensor
    wrl: torch.Tensor

    @staticmethod
    def build(s2c: np.ndarray, wrl: np.ndarray, dtype,
              device) -> "LevelMatrices":
        """From :func:`vertical_recon_matrices` output of shapes
        (members, nz+2, ord, ord) and (members, nz+2, hs, hs, hs)."""
        to = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
        vs2c = to(np.moveaxis(s2c, (2, 3), (0, 1)))[:, :, :, None, :, None]
        vwrl = to(np.moveaxis(wrl, (2, 3, 4), (0, 1, 2)))[:, :, :, :, None, :,
                                                          None]
        return LevelMatrices(vs2c, vwrl)


def _weno_coefs_list(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma):
    """WENO-limited monomial coefficients (list of ord tensors)."""
    a_lo, a_br, w, hs, ord = weno._weno_candidates_and_weights(
        u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
    out = []
    for c in range(ord):
        acc = w[hs] * a_br[c]
        if c < hs:
            acc = acc + weno._msum([w[i] * a_lo[i][c] for i in range(hs)])
        out.append(acc)
    return out


def _eval_edge_list(a, g):
    """A monomial coefficient list evaluated at an edge (c2g column g)."""
    g = np.asarray(g)
    return weno._msum([float(g[c]) * a[c] for c in range(len(a))])


def _face_shift_views(u_halo, ord, axis):
    """The ord+1 shifted views of ``u_halo``, each nfaces long along
    ``axis``: views[0:ord] the stencil of each face's left cell,
    views[1:ord+1] its right cell's (cf. Dycore.h:346-351)."""
    nfaces = u_halo.shape[axis] - ord
    return [u_halo.narrow(axis, s, nfaces) for s in range(ord + 1)]


def _level_matrices(per_level, nfaces, lev):
    """(s2cL, s2cR, wrlL, wrlR): matrix f serves the left candidate of
    face f and matrix f+1 its right candidate (Dycore.h:456-469)."""
    s2c_lev, wrl_lev = per_level
    return (s2c_lev.narrow(lev, 0, nfaces), s2c_lev.narrow(lev, 1, nfaces),
            wrl_lev.narrow(lev, 0, nfaces), wrl_lev.narrow(lev, 1, nfaces))


def reconstruct_faces_both(u_halo, axis, tables, per_level=None,
                           per_level_axis=-3):
    """Both one-sided face values (valL, valR) along ``axis``: the left
    cell's right-edge value and the right cell's left-edge value.
    ``per_level``: (s2c, wrl) tensors with leading matrix dims whose batch
    dims hold nfaces+1 levels along ``per_level_axis``."""
    s2c, wrl, tv_hi_M, tv_lo_M, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    views = _face_shift_views(u_halo, ord, axis)
    stenL, stenR = views[:ord], views[1:]
    if per_level is None:
        s2cL = s2cR = s2c
        wrlL = wrlR = wrl
    else:
        s2cL, s2cR, wrlL, wrlR = _level_matrices(
            per_level, stenL[0].shape[axis], per_level_axis)
    aL = _weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = _weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    return _eval_edge_list(aL, c2g[:, 1]), _eval_edge_list(aR, c2g[:, 0])


def reconstruct_faces_upwind(u_halo, axis, tables, upw, per_level=None,
                             per_level_axis=-3):
    """The upwind-selected face value along ``axis`` (ref:
    Dycore.h:368-385): where ``upw`` the left cell's stencil at its right
    edge, else the right cell's at its left edge. With uniform matrices
    the stencils are selected before the limiter; with per-level ones
    both candidates are evaluated and the value selected."""
    s2c, wrl, tv_hi_M, tv_lo_M, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    views = _face_shift_views(u_halo, ord, axis)
    stenL, stenR = views[:ord], views[1:]
    if per_level is None:
        sten = [torch.where(upw, l, r) for l, r in zip(stenL, stenR)]
        a = _weno_coefs_list(sten, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
        return torch.where(upw, _eval_edge_list(a, c2g[:, 1]),
                           _eval_edge_list(a, c2g[:, 0]))
    s2cL, s2cR, wrlL, wrlR = _level_matrices(
        per_level, stenL[0].shape[axis], per_level_axis)
    aL = _weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = _weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    return torch.where(upw, _eval_edge_list(aL, c2g[:, 1]),
                       _eval_edge_list(aR, c2g[:, 0]))


def flux_direction(prim, trac, pres, axis, tables, levels=None):
    """The flux of one direction. prim: (5, nens, ny, nz, nx)
    de-densitized state [rho, u, v, w, theta], ``axis`` padded by HS
    cells each side; trac: (ntr, ...) de-densitized tracers; pres: (...)
    pressure; ``levels``: the :class:`LevelMatrices` of the z direction.
    In z the acoustic mass flux is zero at the first and last face (rigid
    ground and lid, Dycore.h:477-496). Returns (state_flux (5,
    ..faces..), tracer_flux (ntr, ..faces..))."""
    rho = prim[0]
    mom_q = _MOM_Q[axis]
    ru_fld = rho * prim[1 + mom_q]
    pl = None if levels is None else (levels.s2c, levels.wrl)
    kw = dict(per_level=pl, per_level_axis=-2)
    ruL, ruR = reconstruct_faces_both(ru_fld[None], axis, tables, **kw)
    ppL, ppR = reconstruct_faces_both(pres[None], axis, tables, **kw)
    ruL, ruR, ppL, ppR = ruL[0], ruR[0], ppL[0], ppR[0]
    zmask = axis == AX_Z
    if zmask:
        nfaces = ruL.shape[AX_Z - 1]
        mask = torch.zeros(nfaces, dtype=torch.bool, device=prim.device)
        mask[0] = mask[-1] = True
        mask = mask[None, None, :, None]
        ruL = torch.where(mask, 0.0, ruL)
        ruR = torch.where(mask, 0.0, ruR)
    w1 = 0.5 * (ppR - CS * ruR)
    w2 = 0.5 * (ppL + CS * ruL)
    pp = w1 + w2
    ru = (w2 - w1) / CS
    if zmask:
        ru = torch.where(mask, 0.0, ru)
    upw = ru > 0
    # u, v, w, theta and every tracer in one upwind-selected
    # reconstruction
    q = torch.cat([prim[1:], trac], dim=0)
    vals = reconstruct_faces_upwind(q, axis, tables, upw[None], **kw)
    flux_q = ru[None] * vals
    flux_q[mom_q] = flux_q[mom_q] + pp   # flux_q is this function's own
    return torch.cat([ru[None], flux_q[:4]]), flux_q[4:]

"""WENO limited polynomial reconstruction as elementwise torch ops
(port of pam_tpu/ops/weno.py:27-176; ref dynamics/awfl/WenoLimiter.h:98-181
``compute_weno_coefs`` incl. map_weights :12-19).

Every stencil/coefficient contraction is unrolled into multiply-adds of
table entries with the stencil tensors, in the same order as ``pam_tpu``
so the two agree to rounding. Tables come from :mod:`recon_matrices` in
numpy; their entries enter as Python floats. The stencil-to-coefficient
matrices may instead be tensors with leading matrix dims and trailing
batch dims (the per-level matrices of a stretched vertical grid), whose
entries then broadcast against the stencil tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import recon_matrices as rm

_EPS = 1.0e-20

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@functools.cache
def weno_tables(ord: int, dtype: torch.dtype = torch.float64):
    """Static numpy tables for a given order, rounded to ``dtype``:
    (s2c, wrl, tv_hi, tv_lo, c2g, idl, sigma)."""
    s2c = rm.sten_to_coefs(ord)
    wrl = rm.weno_lower_sten_to_coefs(ord)
    tv_hi = rm.tv_quadform(ord)
    tv_lo = rm.tv_quadform((ord + 1) // 2)
    c2g = rm.coefs_to_gll_lower(ord)
    idl, sigma = rm.weno_ideal_weights(ord)
    to = lambda x: np.asarray(x, dtype=_NP_DTYPES[dtype])
    return (to(s2c), to(wrl), to(tv_hi), to(tv_lo), to(c2g), to(idl),
            float(sigma))


def _msum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _entry(m, idx):
    """Entry ``idx`` of a matrix: a Python float from a numpy table, the
    batch-shaped slice from a per-level tensor."""
    v = m[idx]
    return v if isinstance(v, torch.Tensor) else float(v)


def _weno_candidates_and_weights(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma):
    """Candidate polynomials (a_lo list-of-lists, bridge a_br) and the
    mapped nonlinear weights w (WenoLimiter.h compute_weno_coefs:98-181
    through map_weights). u: list of ord tensors; s2c/wrl numpy tables or
    per-level tensors, the other tables numpy."""
    ord = len(u)
    hs = (ord + 1) // 2  # number and size of low-order sub-stencils
    idl = np.asarray(idl, np.float64)
    a_lo = [[_msum([_entry(wrl, (i, s, c)) * u[i + s] for s in range(hs)])
             for c in range(hs)] for i in range(hs)]
    a_hi = [_msum([_entry(s2c, (c, s)) * u[s] for s in range(ord)])
            for c in range(ord)]
    # bridge polynomial: (a_hi - sum_i idl[i]*a_lo[i]) / idl[hs]
    inv_idl_hi = 1.0 / float(idl[hs])
    a_br = []
    for c in range(ord):
        acc = a_hi[c]
        if c < hs:
            acc = acc - _msum([float(idl[i]) * a_lo[i][c] for i in range(hs)])
        a_br.append(acc * inv_idl_hi)

    def quadform(a, M):
        n = len(a)
        terms = []
        for ci in range(n):
            if M[ci, ci] != 0.0:
                terms.append(float(M[ci, ci]) * a[ci] * a[ci])
            for d in range(ci + 1, n):
                if M[ci, d] + M[d, ci] != 0.0:
                    terms.append(float(M[ci, d] + M[d, ci]) * a[ci] * a[d])
        return _msum(terms)

    tv_lo = [quadform(a_lo[i], np.asarray(tv_lo_M)) for i in range(hs)]
    tv_br = quadform(a_br, np.asarray(tv_hi_M))
    lo_avg = _msum(tv_lo) * (1.0 / hs)
    tv_br = lo_avg + (tv_br - lo_avg) * float(sigma)
    tv = tv_lo + [tv_br]
    # nonlinear weights: idl/(tv^2+eps) -> convexify -> map -> convexify
    w = [float(idl[i]) / (tv[i] * tv[i] + _EPS) for i in range(hs + 1)]
    wsum = _msum(w) + _EPS
    w = [wi / wsum for wi in w]
    w = [wi * (float(idl[i]) + float(idl[i]) ** 2 - 3.0 * float(idl[i]) * wi +
               wi * wi) /
         (float(idl[i]) ** 2 + wi * (1.0 - 2.0 * float(idl[i])))
         for i, wi in enumerate(w)]
    wsum = _msum(w) + _EPS
    w = [wi / wsum for wi in w]
    return a_lo, a_br, w, hs, ord


def _quadform_flops(M) -> int:
    M = np.asarray(M)
    n = M.shape[0]
    terms = sum(M[i, i] != 0.0 for i in range(n)) + sum(
        M[i, d] + M[d, i] != 0.0 for i in range(n) for d in range(i + 1, n))
    return 3 * int(terms) - 1    # two products per term, then the sum


def limiter_flops(tables) -> int:
    """Floating-point operations per point of
    :func:`_weno_candidates_and_weights` (adds, multiplies, divisions and
    reciprocals counted as one each), for the kernels' bounds."""
    s2c, _, tv_hi, tv_lo = tables[:4]
    ord = s2c.shape[-1]
    hs = (ord + 1) // 2
    n = hs * hs * (2 * hs - 1) + ord * (2 * ord - 1)       # a_lo, a_hi
    n += hs * (2 * hs + 1) + (ord - hs)                    # bridge
    n += hs * _quadform_flops(tv_lo) + _quadform_flops(tv_hi)
    n += hs + 3                                            # lo_avg, blend
    n += 4 * (hs + 1) + (hs + 1) + (hs + 1)                # w, sum, convexify
    n += 8 * (hs + 1) + (hs + 1) + (hs + 1)                # map, sum, convexify
    return n


def weno_coefs_list(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma):
    """WENO-limited monomial coefficients (list of ord tensors)."""
    a_lo, a_br, w, hs, ord = _weno_candidates_and_weights(
        u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
    out = []
    for c in range(ord):
        acc = w[hs] * a_br[c]
        if c < hs:
            acc = acc + _msum([w[i] * a_lo[i][c] for i in range(hs)])
        out.append(acc)
    return out


def weno_edges_list(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma, c2g):
    """Both limited edge values (left, right): ``weno_coefs_list`` then
    ``_eval_edge_list`` with the sum reassociated (edge = sum_i w_i e_i,
    e_i each candidate evaluated at the edge) — equal to rounding."""
    a_lo, a_br, w, hs, ord = _weno_candidates_and_weights(
        u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
    outs = []
    for g in (np.asarray(c2g)[:, 0], np.asarray(c2g)[:, 1]):
        e_cands = [_msum([float(g[c]) * a_lo[i][c] for c in range(hs)])
                   for i in range(hs)]
        e_cands.append(_msum([float(g[c]) * a_br[c] for c in range(ord)]))
        outs.append(_msum([w[i] * e_cands[i] for i in range(hs + 1)]))
    return outs[0], outs[1]


def cfv_coefs_list(u, s2c):
    """Centered finite-volume coefficients: the full-order map with no
    limiting (operators/cfv_recon.h, RECONSTRUCTION_TYPE::CFV)."""
    ord = len(u)
    return [_msum([_entry(s2c, (c, s)) * u[s] for s in range(ord)])
            for c in range(ord)]


def _eval_edge_list(a, g):
    """Evaluate a monomial coefficient list at an edge via c2g column g."""
    g = np.asarray(g)
    return _msum([float(g[c]) * a[c] for c in range(len(a))])


def _face_shift_views(u_halo, ord, axis):
    """The ord+1 shifted views of u_halo needed for both one-sided face
    candidates: view s has length nfaces along ``axis``. stenL =
    views[0:ord] (stencil of the left cell of each face), stenR =
    views[1:ord+1] (cf. Dycore.h:346-351 stencil indexing)."""
    nfaces = u_halo.shape[axis] - ord
    return [u_halo.narrow(axis, s, nfaces) for s in range(ord + 1)]


def _level_matrices(per_level, nfaces, lev):
    """(s2cL, s2cR, wrlL, wrlR): matrix f serves the left candidate of
    face f and matrix f+1 its right candidate, as the reference indexes
    vert_sten_to_coefs (Dycore.h:456-469)."""
    s2c_lev, wrl_lev = per_level
    return (s2c_lev.narrow(lev, 0, nfaces), s2c_lev.narrow(lev, 1, nfaces),
            wrl_lev.narrow(lev, 0, nfaces), wrl_lev.narrow(lev, 1, nfaces))


def reconstruct_faces_both(u_halo, axis, tables, per_level=None,
                           per_level_axis=-3):
    """Both one-sided face reconstructions (valL, valR) along ``axis``:
    valL = the left cell's right-edge value, valR = the right cell's
    left-edge value (port of pam_tpu/ops/weno.py:224-256).

    per_level: optional (s2c_lev, wrl_lev) variable-grid matrix tensors
    with LEADING matrix dims, shapes (ord, ord, *batch) and
    (hs, hs, hs, *batch), where batch broadcasts against the stencil
    views and holds nlev = nfaces+1 levels along ``per_level_axis``."""
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
    aL = weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    return _eval_edge_list(aL, c2g[:, 1]), _eval_edge_list(aR, c2g[:, 0])


def reconstruct_faces_upwind(u_halo, axis, tables, upw, per_level=None,
                             per_level_axis=-3):
    """Single upwind-selected face reconstruction along ``axis`` (port of
    pam_tpu/ops/weno.py:259-292; ref Dycore.h:368-385).

    ``upw`` is boolean, broadcastable to the face shape: True selects the
    left cell's stencil evaluated at its right edge (flow toward +axis),
    False the right cell's stencil at its left edge. With uniform
    matrices the stencils are selected before the limiter (one WENO
    evaluation per face and quantity); with per-level matrices both
    candidates are evaluated and the result selected."""
    s2c, wrl, tv_hi_M, tv_lo_M, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    views = _face_shift_views(u_halo, ord, axis)
    stenL, stenR = views[:ord], views[1:]
    if per_level is None:
        sten = [torch.where(upw, l, r) for l, r in zip(stenL, stenR)]
        a = weno_coefs_list(sten, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
        return torch.where(upw, _eval_edge_list(a, c2g[:, 1]),
                           _eval_edge_list(a, c2g[:, 0]))
    s2cL, s2cR, wrlL, wrlR = _level_matrices(
        per_level, stenL[0].shape[axis], per_level_axis)
    aL = weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    return torch.where(upw, _eval_edge_list(aL, c2g[:, 1]),
                       _eval_edge_list(aR, c2g[:, 0]))

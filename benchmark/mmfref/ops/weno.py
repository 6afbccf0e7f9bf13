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


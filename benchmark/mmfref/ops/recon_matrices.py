"""Polynomial reconstruction matrices for finite-volume WENO schemes.

Numpy-only copy of pam_tpu/ops/recon_matrices.py. Every matrix is
derived from first principles with numpy at setup time, for uniform and
stretched grids alike, matching the reference's generated tables
(dynamics/awfl/TransformMatrices.h, TransformMatrices_variable.h).

Conventions: coordinates normalized by the central cell width, the
central cell spanning [-1/2, +1/2]; ``sten_to_coefs`` maps ord cell
averages to monomial coefficients; ``coefs_to_gll_lower`` evaluates the
monomials at x = -1/2 (col 0) and +1/2 (col 1); ``tv_quadform`` is the
Jiang-Shu smoothness indicator as a quadratic form.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def gll_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre-Lobatto points/weights on [-1/2, 1/2], weights sum to 1.

    Ref parity: dynamics/awfl/TransformMatrices.h get_gll_points/get_gll_weights.
    """
    if n < 2:
        raise ValueError("GLL rule needs n >= 2")
    from numpy.polynomial import legendre

    c = np.zeros(n)
    c[-1] = 1.0
    interior = legendre.legroots(legendre.legder(c))
    pts = np.concatenate(([-1.0], np.sort(interior), [1.0]))
    # weights: w_i = 2 / (n(n-1) [P_{n-1}(x_i)]^2)
    wts = 2.0 / (n * (n - 1) * legendre.legval(pts, c) ** 2)
    # map [-1,1] -> [-1/2,1/2]; weights scale by 1/2 so they sum to 1
    return pts / 2.0, wts / 2.0


def normalized_edge_locs(ord: int) -> np.ndarray:
    """Uniform-grid normalized edge locations: ord cells of width 1 centered
    so the central cell spans [-1/2, 1/2]."""
    return np.arange(ord + 1, dtype=np.float64) - ord / 2.0


def _avg_matrix(locs: np.ndarray, first: int, n: int) -> np.ndarray:
    """A[j, s] = average of x**s over cell first+j, j, s in range(n)."""
    A = np.empty((n, n))
    for j in range(n):
        lo, hi = locs[first + j], locs[first + j + 1]
        for s in range(n):
            A[j, s] = (hi ** (s + 1) - lo ** (s + 1)) / ((s + 1) * (hi - lo))
    return A


def _locs(locs_or_ord) -> np.ndarray:
    """Normalized edge locations from an integer order (uniform grid) or
    an array of ord+1 edge locations (variable grid)."""
    if np.isscalar(locs_or_ord):
        return normalized_edge_locs(int(locs_or_ord))
    return np.asarray(locs_or_ord, dtype=np.float64)


def sten_to_coefs(locs_or_ord) -> np.ndarray:
    """(ord, ord) matrix mapping ord cell averages -> monomial coefficients
    (row index = coefficient power). ``locs_or_ord``: an integer order
    (uniform grid) or ord+1 normalized edge locations (variable grid; ref
    TransformMatrices::sten_to_coefs, sten_to_coefs_variable)."""
    locs = _locs(locs_or_ord)
    return np.linalg.inv(_avg_matrix(locs, 0, len(locs) - 1))


def coefs_to_gll_lower(ord: int) -> np.ndarray:
    """(ord, 2): evaluate monomial basis at x=-1/2 (col 0) and x=+1/2 (col 1)."""
    out = np.empty((ord, 2))
    for s in range(ord):
        out[s, 0] = (-0.5) ** s
        out[s, 1] = (+0.5) ** s
    return out


def weno_lower_sten_to_coefs(locs_or_ord) -> np.ndarray:
    """(hs, hs, hs) low-order reconstruction matrices, hs = (ord+1)//2.

    result[i, s, c]: contribution of cell average ``u[i+s]`` to monomial
    coefficient ``c`` of the degree-(hs-1) polynomial on sub-stencil ``i``
    (cells i..i+hs-1 of the full stencil), in global normalized coordinates.
    ``locs_or_ord`` as for :func:`sten_to_coefs`.
    """
    locs = _locs(locs_or_ord)
    hs = len(locs) // 2
    out = np.empty((hs, hs, hs))
    for i in range(hs):
        out[i] = np.linalg.inv(_avg_matrix(locs, i, hs)).T  # out[i, s, c]
    return out


@functools.cache
def tv_quadform(ord: int, truncate: bool = True) -> np.ndarray:
    """(ord, ord) symmetric matrix: beta(a) = a @ M @ a is the Jiang-Shu
    smoothness indicator sum_{n>=1} int_{-1/2}^{1/2} (p^(n))^2 dx. With
    ``truncate`` product terms of monomial power above ``ord`` are dropped,
    matching the dycore's generated formulas (TransformMatrices.h
    coefs_to_tv); core/vinterp.py uses the full indicator."""
    M = np.zeros((ord, ord))
    for n in range(1, ord):
        # d^n/dx^n x^s = s!/(s-n)! x^(s-n)  for s >= n
        for s1 in range(n, ord):
            c1 = math.factorial(s1) / math.factorial(s1 - n)
            for s2 in range(n, ord):
                c2 = math.factorial(s2) / math.factorial(s2 - n)
                p = s1 + s2 - 2 * n  # power of the product
                if truncate and p > ord:
                    continue  # reference truncation of high-power terms
                # integral of x^p over [-1/2, 1/2]
                integ = 0.0 if p % 2 == 1 else (0.5 ** p) / (p + 1)
                M[s1, s2] += c1 * c2 * integ
    return M


def weno_ideal_weights(ord: int) -> tuple[np.ndarray, float]:
    """Idealized weights and sigma for the WENO limiter (ref: WenoLimiter.h
    wenoSetIdealSigma). Returns (idl[hs+2], sigma), idl convexified."""
    hs = (ord - 1) // 2
    if ord == 3:
        sigma = 0.0343557947899881
        idl = np.array([1.0, 1.0, 1224.61619926508])
    elif ord == 5:
        sigma = 0.73564225445964
        idl = np.array([1.0, 73.564225445964, 1.0, 1584.89319246111])
    elif ord == 7:
        sigma = 0.125594321575479
        idl = np.array([1.0, 7.35642254459641, 7.35642254459641, 1.0,
                        794.328234724281])
    elif ord == 9:
        sigma = 0.0288539981181442
        idl = np.array([1.0, 2.15766927997459, 2.40224886796286,
                        2.15766927997459, 1.0, 1136.12697719888])
    else:
        sigma = 0.1
        idl = np.ones(hs + 2)
    idl = idl / idl.sum()
    return idl, sigma


def mirror_recon_matrices(dz: np.ndarray, ord: int,
                          iface: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell variable-grid reconstruction matrices for a column with
    MIRROR halos (the SPAM extruded grid, exchange.h:565-606): the stencil
    for cell k uses cells k-hs..k+hs with thicknesses reflected at the
    boundaries (pam_tpu/ops/recon_matrices.py:194-233; ref
    weno_func_recon_variable.h + TransformMatrices_variable.h).

    dz: (nz,) or (nens, nz) cell thicknesses of the recon grid. iface: the
    mirror rule, False = layer rule (halo(-1-m) = dz(m)), True = interface
    rule (halo(-1-m) = dz(m+1)). Returns (s2c, wrl) of shapes
    (..., nz, ord, ord) and (..., nz, nsub, nsub, nsub)."""
    dz = np.asarray(dz, dtype=np.float64)
    squeeze = dz.ndim == 1
    if squeeze:
        dz = dz[None, :]
    nens, nz = dz.shape
    nsub = (ord + 1) // 2
    half = ord // 2
    off = 1 if iface else 0
    pad_lo = dz[:, off:off + half][:, ::-1]
    pad_hi = dz[:, nz - half - off:nz - off][:, ::-1]
    dzm = np.concatenate([pad_lo, dz, pad_hi], axis=1)  # (nens, nz+2*half)
    s2c = np.empty((nens, nz, ord, ord))
    wrl = np.empty((nens, nz, nsub, nsub, nsub))
    for e in range(nens):
        for k in range(nz):
            dzloc = dzm[e, k:k + ord] / dzm[e, k + half]
            locs = np.concatenate(([0.0], np.cumsum(dzloc)))
            locs -= 0.5 * (locs[half] + locs[half + 1])
            s2c[e, k] = sten_to_coefs(locs)
            wrl[e, k] = weno_lower_sten_to_coefs(locs)
    if squeeze:
        return s2c[0], wrl[0]
    return s2c, wrl


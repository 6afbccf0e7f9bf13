"""Host side of ``csrc/weno5.cuh``, the order-5 WENO limiter that the CUDA
kernels ``csrc/weno_x.cu`` and ``csrc/awfl_flux.cu`` share.

:func:`prepare_tables` turns the tables of ``weno.weno_tables(5, dtype)``
into the NTAB constants the header's ``Tables`` struct holds, so that the
kernels test no table entry and add no pair of them;
:func:`bridge_matrix` merges the bridge polynomial into one stencil matrix
(also per level of a stretched grid, ``awfl_flux.LevelMatrices``).
:func:`cell_limiter`, :func:`edges` and :func:`edge` are the header's
functions of the same names in numpy, operation for operation except for
multiply-add contraction and the hardware reciprocal: the CPU tests hold
them against ``weno.weno_edges_list``, which shows here that the header's
order of operations stays inside the tolerance the card-side comparison
allows.
"""

from __future__ import annotations

import numpy as np

ORD = 5
HS = 3
NMAT = ORD * ORD + HS ** 3      # bridge[c][s] then wrl[i][s][c]
NTAB = NMAT + 2 + 6 + ORD + 5 * (HS + 1) + 2
EPS = 1.0e-20
# the entries of the merged upper triangles (M[c][d] + M[d][c], M[c][c])
# that the header evaluates; every other entry must be zero
TVL_TERMS = ((1, 1), (2, 2))
TVH_TERMS = ((1, 1), (1, 3), (2, 2), (2, 4), (3, 3), (4, 4))


def bridge_matrix(s2c, wrl, idl) -> np.ndarray:
    """The bridge polynomial (a_hi - sum_i idl_i a_lo_i) / idl_hi as one
    (..., ord, ord) stencil-to-coefficient matrix, in float64. s2c:
    (..., ord, ord) [c][s]; wrl: (..., hs, hs, hs) [i][s][c]; leading
    dims are levels or members."""
    s2c = np.asarray(s2c, np.float64)
    wrl = np.asarray(wrl, np.float64)
    idl = np.asarray(idl, np.float64)
    br = s2c.copy()
    for i in range(HS):
        for s in range(HS):
            br[..., :HS, i + s] -= idl[i] * wrl[..., i, s, :]
    return br / idl[HS]


def pack_matrices(s2c, wrl, idl) -> np.ndarray:
    """(..., NMAT) float64: the bridge matrix row-major, then wrl."""
    br = bridge_matrix(s2c, wrl, idl)
    lead = br.shape[:-2]
    return np.concatenate(
        [br.reshape(lead + (-1,)),
         np.asarray(wrl, np.float64).reshape(lead + (-1,))], axis=-1)


def _merged_triangle(M, terms, name):
    """The merged upper-triangle entries ``terms`` of a quadratic form,
    summed in the table's dtype as the plain version sums them; raises if
    any other entry is not zero."""
    M = np.asarray(M)
    n = M.shape[0]
    out = []
    for c in range(n):
        for d in range(c, n):
            v = M[c, c] if c == d else M[c, d] + M[d, c]
            if (c, d) in terms:
                out.append(float(v))
            elif v != 0.0:
                raise ValueError(f"{name}[{c}][{d}] = {v} is not zero: "
                                 "csrc/weno5.cuh skips that term")
    return out


def prepare_tables(tables) -> np.ndarray:
    """The NTAB float64 constants of ``csrc/weno5.cuh::Tables`` from the
    tables of ``weno.weno_tables(5, dtype)`` (entries already rounded to
    the field's dtype; the kernel casts each constant to that dtype)."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    if s2c.shape != (ORD, ORD):
        raise ValueError(f"the CUDA WENO kernels are order {ORD}; got "
                         f"tables of order {s2c.shape[-1]}")
    c2g = np.asarray(c2g, np.float64)
    sign = (-1.0) ** np.arange(ORD)
    if c2g[0, 1] != 1.0 or not np.array_equal(c2g[:, 0], sign * c2g[:, 1]):
        raise ValueError("c2g is not the monomials at -1/2 and +1/2")
    d = np.asarray(idl, np.float64)
    out = np.concatenate([
        pack_matrices(s2c, wrl, idl),
        _merged_triangle(tvl, TVL_TERMS, "tv_lo"),
        _merged_triangle(tvh, TVH_TERMS, "tv_hi"),
        c2g[:, 1], d,
        d + d * d, 3.0 * d, d * d, 1.0 - 2.0 * d,   # the map's constants
        [float(np.asarray(sigma, s2c.dtype)), 1.0 / HS]])
    assert out.shape == (NTAB,)
    return np.ascontiguousarray(out)


_PREPARED: dict = {}


def prepared_tables(tables) -> np.ndarray:
    """:func:`prepare_tables`, remembered per tables tuple
    (``weno.weno_tables`` hands out one tuple per order and dtype), so a
    launch pays a dictionary lookup."""
    hit = _PREPARED.get(id(tables))
    if hit is None or hit[0] is not tables:
        hit = _PREPARED[id(tables)] = (tables, prepare_tables(tables))
    return hit[1]


def _split(p):
    """The packed constants by name, as the header's struct lays them."""
    sizes = (("mat", NMAT), ("tvl", 2), ("tvh", 6), ("g", ORD),
             ("idl", HS + 1), ("map_a", HS + 1), ("map_b", HS + 1),
             ("map_c", HS + 1), ("map_d", HS + 1), ("sigma", 1),
             ("third", 1))
    out, k = {}, 0
    for name, n in sizes:
        out[name] = p[k:k + n]
        k += n
    return out


def cell_limiter(u, p, mat=None):
    """``weno5::cell_limiter`` in numpy: u, five stencil arrays; p, the
    constants of :func:`prepare_tables` cast to the arrays' dtype; mat,
    per-level stencil matrices (NMAT arrays that broadcast against u) in
    place of the uniform grid's. Returns the five weighted coefficients."""
    t = _split(p)
    m = t["mat"] if mat is None else mat
    lo = [[sum(m[ORD * ORD + (i * HS + s) * HS + c] * u[i + s]
               for s in range(HS)) for c in range(HS)] for i in range(HS)]
    br = [sum(m[c * ORD + s] * u[s] for s in range(ORD)) for c in range(ORD)]
    tv = [t["tvl"][0] * lo[i][1] * lo[i][1] + t["tvl"][1] * lo[i][2] * lo[i][2]
          for i in range(HS)]
    hi = (br[1] * (t["tvh"][0] * br[1] + t["tvh"][1] * br[3])
          + br[2] * (t["tvh"][2] * br[2] + t["tvh"][3] * br[4])
          + t["tvh"][4] * br[3] * br[3] + t["tvh"][5] * br[4] * br[4])
    lo_avg = (tv[0] + tv[1] + tv[2]) * t["third"][0]
    tv.append(lo_avg + (hi - lo_avg) * t["sigma"][0])
    one = u[0].dtype.type(1)
    eps = u[0].dtype.type(EPS)
    w = [t["idl"][i] * (one / (tv[i] * tv[i] + eps)) for i in range(HS + 1)]
    r = one / (eps + w[0] + w[1] + w[2] + w[3])
    d = []
    for i in range(HS + 1):
        wi = w[i] * r
        w[i] = wi * (t["map_a"][i] + wi * (wi - t["map_b"][i]))
        d.append(t["map_c"][i] + wi * t["map_d"][i])
    d01, d23 = d[0] * d[1], d[2] * d[3]
    w = [w[0] * (d[1] * d23), w[1] * (d[0] * d23), w[2] * (d[3] * d01),
         w[3] * (d[2] * d01)]
    r = one / ((w[0] + w[1]) + (w[2] + w[3]))
    w = [wi * r for wi in w]
    return [w[HS] * br[c] + (sum(w[i] * lo[i][c] for i in range(HS))
                             if c < HS else 0) for c in range(ORD)]


def edges(a, p):
    """``weno5::edges``: (left, right) values of the polynomial a."""
    g = _split(p)["g"]
    even = a[0] + g[2] * a[2] + g[4] * a[4]
    odd = g[1] * a[1] + g[3] * a[3]
    return even - odd, even + odd


def edge(a, p, right):
    """``weno5::edge``: the value at +1/2 where ``right``, else at -1/2."""
    left, rgt = edges(a, p)
    return np.where(right, rgt, left)

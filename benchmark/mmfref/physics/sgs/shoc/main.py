"""SHOC (Simplified Higher-Order Closure) column scheme (port of
pam_tpu/physics/sgs/shoc/main.py; ref physics/sgs/shoc/fortran/shoc.F90,
Bogenschutz & Krueger 2013): TKE prognosis, assumed double-Gaussian PDF
cloud closure, second/third moment diagnostics, implicit vertical
diffusion, PBL height diagnosis and the energy fixer.

Whole-tensor torch ops; the tridiagonal implicit solve runs every field
that shares one matrix through one Thomas recurrence, a Python loop over
levels in ``pam_tpu``'s recurrence order; the PBL Richardson search is an argmax
over the scan window.

Arrays are (nlev, ...cols) with k=0 the model TOP (``thetal[-1]`` is the
surface level); interface arrays are (nlev+1, ...cols); tracers are
(nlev, ...cols, ntr).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import CONST
from ...p3.main import murphy_koop_svp

C = CONST


def _cbrt(x):
    return x ** (1.0 / 3.0)


def _add_at(x, k, v):
    """x with v added at level k (``x.at[k].add(v)``)."""
    y = x.clone()
    y[k] = y[k] + v
    return y


def _take(arr, idx):
    """arr[idx[c], c] for every column c: a per-column level index."""
    return torch.gather(arr, 0, idx[None]).squeeze(0)


# ------------------------------------------------------------ grid / interp
def linear_interp(x1, x2, y1, minthresh):
    """Linear interpolation between mid and interface grids
    (shoc.F90:4576-4659). Direction inferred from shapes; linear
    extrapolation at the ends when going mid -> interface."""
    km1 = y1.shape[0]
    km2 = x2.shape[0]
    if km2 == km1 + 1:  # mid -> interface
        slope = (y1[1:] - y1[:-1]) / (x1[1:] - x1[:-1])
        interior = y1[:-1] + slope * (x2[1:-1] - x1[:-1])
        first = y1[:1] + slope[:1] * (x2[:1] - x1[:1])
        last = y1[-2:-1] + slope[-1:] * (x2[-1:] - x1[-2:-1])
        y2 = torch.cat([first, interior, last], dim=0)
    elif km1 == km2 + 1:  # interface -> mid
        slope = (y1[1:] - y1[:-1]) / (x1[1:] - x1[:-1])
        y2 = y1[:-1] + slope * (x2 - x1[:-1])
    else:
        raise ValueError("linear_interp: incompatible level counts")
    return torch.clamp(y2, min=minthresh)


def shoc_grid(zt_grid, zi_grid, pdel):
    """Thicknesses + density (shoc.F90:567-641). dz_zi[0] is unused
    (zeroed); dz_zi[-1] = zt_grid[-1] (surface condition)."""
    dz_zt = zi_grid[:-1] - zi_grid[1:]
    dz_mid = zt_grid[:-1] - zt_grid[1:]
    dz_zi = torch.cat([torch.zeros_like(zt_grid[:1]), dz_mid,
                       zt_grid[-1:]], dim=0)
    rho_zt = (1.0 / C.ggr) * (pdel / dz_zt)
    return dz_zt, dz_zi, rho_zt


def compute_shoc_vapor(qw, ql):
    """(shoc.F90:645-694)."""
    return qw - ql


# -------------------------------------------------- implicit diffusion solve
def _solve_shared(du, dl, d0, rhs_list, tracers=None):
    """Solve every system that shares one (du, dl, d0) matrix in one
    batched tridiagonal solve (the reference factorizes once and
    back-solves per field, shoc.F90:3504-3643); the fields are stacked
    into one trailing dim, so one Thomas recurrence solves all of them.

    rhs_list: list of (nlev, ...); tracers: (nlev, ..., ntr) or None.
    Returns the solved rhs_list (+ tracers appended when given)."""
    cols = [r[..., None] for r in rhs_list]
    if tracers is not None:
        cols.append(tracers)
    R = torch.cat(cols, dim=-1)                            # (nlev, ..., m)
    X = _thomas_batched(dl[..., None], d0[..., None], du[..., None], R)
    out = list(X[..., :len(rhs_list)].unbind(-1))
    if tracers is not None:
        out.append(X[..., len(rhs_list):])
    return out


def _thomas_batched(L, D, U, R):
    """Thomas along axis 0 for stacked right-hand sides, as a Python loop
    over levels in ``pam_tpu``'s recurrence order (forward factorization
    c[k] = D[k] - (L[k]/c[k-1]) U[k-1], forward substitution, back
    substitution). L/D/U: (nlev, ..., 1), R: (nlev, ..., m)."""
    n = R.shape[0]
    c = [D[0]]
    lk = [None]
    for k in range(1, n):
        lkc = L[k] / c[k - 1]
        lk.append(lkc)
        c.append(D[k] - lkc * U[k - 1])
    y = [R[0]]
    for k in range(1, n):
        y.append(R[k] - lk[k] * y[k - 1])
    x = [None] * n
    x[n - 1] = y[n - 1] / c[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = (y[k] - U[k] * x[k + 1]) / c[k]
    return torch.stack(x)


def vd_shoc_matrix(kv_term, tmpi, rdp_zt, dtime, flux):
    """Build (du, dl, d0) for the implicit solve (vd_shoc_decomp,
    shoc.F90:3504-3587). ``flux`` is the implicit surface drag ksrf."""
    nlev = rdp_zt.shape[0]
    core = -kv_term[1:nlev] * tmpi[1:nlev]               # (nlev-1, ...)
    du = torch.cat([core * rdp_zt[:-1], torch.zeros_like(rdp_zt[:1])], dim=0)
    dl = torch.cat([torch.zeros_like(rdp_zt[:1]), core * rdp_zt[1:]], dim=0)
    d0 = 1.0 - du - dl
    d0 = _add_at(d0, -1, flux * dtime * C.ggr * rdp_zt[-1])
    return du, dl, d0


def update_prognostics_implicit(dtime, dz_zt, dz_zi, rho_zt, zt_grid,
                                zi_grid, tk, tkh, uw_sfc, vw_sfc, wthl_sfc,
                                wqw_sfc, wtracer_sfc, thetal, qw, tracers,
                                tke, u_wind, v_wind):
    """Backward-Euler vertical diffusion of all prognostics
    (shoc.F90:697-849). ``tracers``: (nlev, ..., ntr) or None."""
    tkh_zi = linear_interp(zt_grid, zi_grid, tkh, 0.0)
    tk_zi = linear_interp(zt_grid, zi_grid, tk, 0.0)
    rho_zi = linear_interp(zt_grid, zi_grid, rho_zt, 0.0)

    # tmpi = dt*g*rho/dz at interfaces (:851-887); level 0 unused
    safe_dzi = torch.where(dz_zi == 0.0, 1.0, dz_zi)
    tmpi = dtime * (C.ggr * rho_zi) / safe_dzi
    tmpi = tmpi.clone()
    tmpi[0] = 0.0
    rdp_zt = 1.0 / (C.ggr * rho_zt * dz_zt)              # (:889-926)

    # implicit surface stress (:930-975)
    taux = rho_zi[-1] * uw_sfc
    tauy = rho_zi[-1] * vw_sfc
    ws = torch.clamp(torch.sqrt(u_wind[-1] ** 2 + v_wind[-1] ** 2), min=1.0)
    ksrf = torch.clamp(torch.sqrt(taux ** 2 + tauy ** 2) / ws, min=1.0e-4)
    ustar = torch.clamp(torch.sqrt(torch.sqrt(uw_sfc ** 2 + vw_sfc ** 2)),
                        min=0.01)
    wtke_sfc = ustar ** 3                                # (:977-1000)

    # explicit surface fluxes for thermo + tracers (:1002-1058)
    cmnfac = dtime * (C.ggr * rho_zi[-1] * rdp_zt[-1])
    thetal = _add_at(thetal, -1, cmnfac * wthl_sfc)
    qw = _add_at(qw, -1, cmnfac * wqw_sfc)
    tke = _add_at(tke, -1, cmnfac * wtke_sfc)
    if tracers is not None:
        tracers = _add_at(tracers, -1, cmnfac[..., None] * wtracer_sfc)

    du, dl, d0 = vd_shoc_matrix(tk_zi, tmpi, rdp_zt, dtime, ksrf)
    u_wind, v_wind = _solve_shared(du, dl, d0, [u_wind, v_wind])
    du, dl, d0 = vd_shoc_matrix(tkh_zi, tmpi, rdp_zt, dtime,
                                torch.zeros_like(ksrf))
    if tracers is None:
        thetal, qw, tke = _solve_shared(du, dl, d0, [thetal, qw, tke])
    else:
        thetal, qw, tke, tracers = _solve_shared(du, dl, d0,
                                                 [thetal, qw, tke], tracers)
    return thetal, qw, tracers, tke, u_wind, v_wind


# ------------------------------------------------------------ second moments
def diag_second_shoc_moments(thetal, qw, u_wind, v_wind, tke, isotropy, tkh,
                             tk, dz_zi, zt_grid, zi_grid, shoc_mix,
                             wthl_sfc, wqw_sfc, uw_sfc, vw_sfc):
    """(shoc.F90:1061-1514). Returns dict of interface moments + w_sec."""
    # surface scales (:1201-1265)
    ustar2 = torch.sqrt(uw_sfc ** 2 + vw_sfc ** 2)
    wstar = torch.where(wthl_sfc > 0.0,
                        _cbrt(torch.clamp(
                            (1.0 / C.basetemp) * C.ggr * wthl_sfc * 1.0,
                            min=0.0)), 0.0)

    isotropy_zi = linear_interp(zt_grid, zi_grid, isotropy, 0.0)
    tkh_zi = linear_interp(zt_grid, zi_grid, tkh, 0.0)
    tk_zi = linear_interp(zt_grid, zi_grid, tk, 0.0)

    w_sec = C.w2tune * (2.0 / 3.0) * tke

    def varorcovar(tunefac, a, b):
        """(calc_shoc_varorcovar, :1516-1583) interior interfaces only."""
        gd2 = (1.0 / dz_zi[1:-1]) ** 2
        sm = isotropy_zi[1:-1] * tkh_zi[1:-1]
        return tunefac * sm * gd2 * (a[:-1] - a[1:]) * (b[:-1] - b[1:])

    def vertflux(kv_zi, a):
        """(calc_shoc_vertflux, :1585-1643)."""
        return -kv_zi[1:-1] * (a[:-1] - a[1:]) / dz_zi[1:-1]

    def with_bc(interior, lower):
        """interfaces: [upper bc=0] + interior + [lower bc]."""
        return torch.cat([torch.zeros_like(lower)[None], interior,
                          lower[None]], dim=0)

    # lower boundary (Andre et al 1978, :1267-1367)
    uf = torch.clamp(torch.sqrt(ustar2 + 0.3 * wstar * wstar), min=0.01)
    a_const = 1.8
    thl_sfc = 0.4 * a_const * (wthl_sfc / uf) ** 2
    qw_sfc2 = 0.4 * a_const * (wqw_sfc / uf) ** 2
    qwthl_sfc = 0.2 * a_const * (wthl_sfc / uf) * (wqw_sfc / uf)
    wtke_sfc = torch.clamp(torch.sqrt(ustar2), min=0.01) ** 3

    return dict(
        thl_sec=with_bc(varorcovar(C.thl2tune, thetal, thetal), thl_sfc),
        qw_sec=with_bc(varorcovar(C.qw2tune, qw, qw), qw_sfc2),
        qwthl_sec=with_bc(varorcovar(C.qwthl2tune, thetal, qw), qwthl_sfc),
        wthl_sec=with_bc(vertflux(tkh_zi, thetal), wthl_sfc),
        wqw_sec=with_bc(vertflux(tkh_zi, qw), wqw_sfc),
        wtke_sec=with_bc(vertflux(tkh_zi, tke), wtke_sfc),
        uw_sec=with_bc(vertflux(tk_zi, u_wind), uw_sfc),
        vw_sec=with_bc(vertflux(tk_zi, v_wind), vw_sfc),
        w_sec=w_sec)


# ------------------------------------------------------------- third moments
def diag_third_shoc_moments(w_sec, thl_sec, wthl_sec, isotropy, brunt,
                            thetal, tke, dz_zt, dz_zi, zt_grid, zi_grid):
    """w3 closure of Canuto et al. (diag_third_shoc_moments + helpers,
    shoc.F90:1715-2148). Interface array out; top/bottom zero."""
    isotropy_zi = linear_interp(zt_grid, zi_grid, isotropy, 0.0)
    brunt_zi = linear_interp(zt_grid, zi_grid, brunt, C.largeneg)
    w_sec_zi = linear_interp(zt_grid, zi_grid, w_sec,
                             (2.0 / 3.0) * C.mintke)
    thetal_zi = linear_interp(zt_grid, zi_grid, thetal, 0.0)

    nlev = w_sec.shape[0]
    # interior interfaces k=1..nlev-1 (Fortran k=2..nlev); kc=k-1, kb=k+1
    sl = lambda a: a[1:nlev]               # interface arrays at k
    thedz = 1.0 / dz_zi[1:nlev]
    thedz2 = 1.0 / (dz_zt[1:] + dz_zt[:-1])
    iso = sl(isotropy_zi)
    isosqrd = iso ** 2
    buoy_sgs2 = isosqrd * sl(brunt_zi)
    bet2 = C.ggr / sl(thetal_zi)

    thl_sec_diff = thl_sec[:nlev - 1] - thl_sec[2:]
    wthl_sec_diff = wthl_sec[:nlev - 1] - wthl_sec[2:]
    wthl_k = wthl_sec[1:nlev]
    wsec_diff = w_sec[:-1] - w_sec[1:]
    tke_diff = tke[:-1] - tke[1:]
    wsec_zik = sl(w_sec_zi)

    f0 = thedz2 * bet2 ** 3 * iso ** 4 * wthl_k * thl_sec_diff
    f1 = thedz2 * bet2 ** 2 * iso ** 3 * (wthl_k * wthl_sec_diff +
                                          0.5 * wsec_zik * thl_sec_diff)
    f2 = thedz * bet2 * isosqrd * wthl_k * wsec_diff + \
        2.0 * thedz2 * bet2 * isosqrd * wsec_zik * wthl_sec_diff
    f3 = thedz2 * bet2 * isosqrd * wsec_zik * wthl_sec_diff + \
        thedz * bet2 * isosqrd * (wthl_k * tke_diff)
    f4 = thedz * iso * wsec_zik * (wsec_diff + tke_diff)
    f5 = thedz * iso * wsec_zik * wsec_diff

    c = C.c_diag_3rd_mom
    a4 = 2.4 / (3.0 * c + 5.0)
    a5 = 0.6 / (c * (3.0 + 5.0 * c))
    omega0 = a4 / (1.0 - a5 * buoy_sgs2)
    omega1 = omega0 / (2.0 * c)
    omega2 = omega1 * f3 + (5.0 / 4.0) * omega0 * f4

    a0 = (0.52 / c ** 2) / (c - 2.0)
    a1 = 0.87 / c ** 2
    a2 = 0.5 / c
    a3 = 0.6 / (c * (c - 2.0))
    x0 = (a2 * buoy_sgs2 * (1.0 - a3 * buoy_sgs2)) / \
        (1.0 - (a1 + a3) * buoy_sgs2)
    y0 = (2.0 * a2 * buoy_sgs2 * x0) / (1.0 - a3 * buoy_sgs2)
    x1 = (a0 * f0 + a1 * f1 + a2 * (1.0 - a3 * buoy_sgs2) * f2) / \
        (1.0 - (a1 + a3) * buoy_sgs2)
    y1 = (2.0 * a2 * (buoy_sgs2 * x1 + (a0 / a1) * f0 + f1)) / \
        (1.0 - a3 * buoy_sgs2)
    aa0 = omega0 * x0 + omega1 * y0
    aa1 = omega0 * x1 + omega1 * y1 + omega2
    w3_int = (aa1 - 1.2 * x1 - 1.5 * f5) / (c - 1.2 * x0 + aa0)

    w3 = torch.cat([torch.zeros_like(w3_int[:1]), w3_int,
                    torch.zeros_like(w3_int[:1])], dim=0)
    # clipping (:2099-2148): |w3| > 1.2*sqrt(2 w_sec_zi^3) -> 0.02
    cond = C.w3clip * torch.sqrt(2.0 * torch.clamp(w_sec_zi, min=0.0) ** 3)
    return torch.where(w3.abs() > cond, 0.02, w3)


# ------------------------------------------------------------ assumed PDF
def shoc_assumed_pdf(thetal, qw, w_field, thl_sec, qw_sec, wthl_sec, w_sec,
                     wqw_sec, qwthl_sec, w3, pres, zt_grid, zi_grid):
    """Double-Gaussian PDF closure for SGS cloud + buoyancy flux
    (shoc.F90:2150-2927). Returns (cldfrac, ql, wqls, wthv_sec, ql2)."""
    epsterm = C.rgas / C.rv
    thl_tol, rt_tol = 1.0e-2, 1.0e-4
    w_tol_sqd = (2.0e-2) ** 2

    w3_zt = linear_interp(zi_grid, zt_grid, w3, C.largeneg)
    thl_sec_zt = linear_interp(zi_grid, zt_grid, thl_sec, 0.0)
    wthl_sec_zt = linear_interp(zi_grid, zt_grid, wthl_sec, C.largeneg)
    qwthl_sec_zt = linear_interp(zi_grid, zt_grid, qwthl_sec, C.largeneg)
    wqw_sec_zt = linear_interp(zi_grid, zt_grid, wqw_sec, C.largeneg)
    qw_sec_zt = linear_interp(zi_grid, zt_grid, qw_sec, 0.0)

    sqrtw2 = torch.sqrt(torch.clamp(w_sec, min=0.0))
    sqrtthl = torch.clamp(torch.sqrt(torch.clamp(thl_sec_zt, min=0.0)),
                          min=thl_tol)
    sqrtqt = torch.clamp(torch.sqrt(torch.clamp(qw_sec_zt, min=0.0)),
                         min=rt_tol)

    # vertical velocity parameters (:2431-2486)
    skew_w = w3_zt / torch.clamp(
        torch.sqrt(torch.clamp(w_sec, min=1e-30) ** 3), min=1e-30)
    small_w = w_sec <= w_tol_sqd
    skew_w = torch.where(small_w, 0.0, skew_w)
    w2t = 0.4
    a = torch.clamp(0.5 * (1.0 - skew_w * torch.sqrt(
        1.0 / (4.0 * (1.0 - w2t) ** 3 + skew_w ** 2))), 0.01, 0.99)
    a = torch.where(small_w, 0.5, a)
    sqrtw2t = np.sqrt(1.0 - w2t)
    w1_1t = torch.where(small_w, 0.0, torch.sqrt(
        (1.0 - a) / torch.clamp(a, min=1e-12)) * sqrtw2t)
    w1_2t = torch.where(small_w, 0.0, -torch.sqrt(
        a / torch.clamp(1.0 - a, min=1e-12)) * sqrtw2t)

    def scalar_params(wxsec, sqrtx, xsec, x_first, tol, do_skew):
        """thl/qw double-gaussian parameters (:2488-2647)."""
        corr = torch.clamp(wxsec / (sqrtw2 * sqrtx), -1.0, 1.0)
        degenerate = (xsec <= tol ** 2) | small_w
        x1_1t = -corr / torch.where(small_w, 1.0, w1_2t)
        x1_2t = -corr / torch.where(small_w, 1.0, w1_1t)
        tsign = (x1_2t - x1_1t).abs()
        if do_skew:
            skew_x = torch.where(tsign > 0.4, 1.2 * skew_w,
                                 torch.where(tsign <= 0.2, 0.0,
                                             (1.2 * skew_w / 0.2) *
                                             (tsign - 0.2)))
        else:
            skew_x = torch.zeros_like(tsign)
        common = 1.0 - a * x1_1t ** 2 - (1.0 - a) * x1_2t ** 2
        cube = skew_x - a * x1_1t ** 3 - (1.0 - a) * x1_2t ** 3
        diff = torch.where((x1_2t - x1_1t).abs() < 1e-30, 1e-30,
                           x1_2t - x1_1t)
        x2_1 = torch.clamp((3.0 * x1_2t * common - cube) /
                           (3.0 * a * diff), 0.0, 100.0)
        x2_2 = torch.clamp((-3.0 * x1_1t * common + cube) /
                           (3.0 * (1.0 - a) * diff), 0.0, 100.0)
        x2_1 = torch.where(degenerate, 0.0, x2_1 * xsec)
        x2_2 = torch.where(degenerate, 0.0, x2_2 * xsec)
        x1_1 = torch.where(degenerate, x_first, x1_1t * sqrtx + x_first)
        x1_2 = torch.where(degenerate, x_first, x1_2t * sqrtx + x_first)
        return x1_1, x1_2, x2_1, x2_2, torch.sqrt(x2_1), torch.sqrt(x2_2)

    thl1_1, thl1_2, thl2_1, thl2_2, sqrtthl2_1, sqrtthl2_2 = scalar_params(
        wthl_sec_zt, sqrtthl, thl_sec_zt, thetal, thl_tol, False)
    qw1_1, qw1_2, qw2_1, qw2_2, sqrtqw2_1, sqrtqw2_2 = scalar_params(
        wqw_sec_zt, sqrtqt, qw_sec_zt, qw, rt_tol, True)

    w1_1 = w1_1t * sqrtw2 + w_field
    w1_2 = w1_2t * sqrtw2 + w_field

    # in-plume correlation (:2668-2706)
    testvar = a * sqrtqw2_1 * sqrtthl2_1 + (1.0 - a) * sqrtqw2_2 * sqrtthl2_2
    r_qwthl = torch.where(testvar == 0.0, 0.0, torch.clamp(
        (qwthl_sec_zt - a * (qw1_1 - qw) * (thl1_1 - thetal) -
         (1.0 - a) * (qw1_2 - qw) * (thl1_2 - thetal)) /
        torch.where(testvar == 0.0, 1.0, testvar), -1.0, 1.0))

    # plume temperatures + saturation (:2708-2771)
    exner_term = (C.basepres / pres) ** (C.rgas / C.cp)
    Tl1_1 = thl1_1 / exner_term
    Tl1_2 = thl1_2 / exner_term

    def qs_beta(Tl):
        es = murphy_koop_svp(Tl, False)
        qs = 0.622 * es / torch.maximum(es, pres - es)
        beta = (C.rgas / C.rv) * (C.lcond / (C.rgas * Tl)) * \
            (C.lcond / (C.cp * Tl))
        return qs, beta

    qs1, beta1 = qs_beta(torch.clamp(Tl1_1, min=1.0))
    qs2, beta2 = qs_beta(torch.clamp(Tl1_2, min=1.0))

    def compute_s(qw1, qs, beta, thl2, qw2, sqthl2, sqqw2):
        """(:2773-2835)."""
        s = qw1 - qs * ((1.0 + beta * qw1) / (1.0 + beta * qs))
        cthl = ((1.0 + beta * qw1) / (1.0 + beta * qs) ** 2) * \
            (C.cp / C.lcond) * beta * qs * (pres / C.basepres) ** \
            (C.rgas / C.cp)
        cqt = 1.0 / (1.0 + beta * qs)
        tmp = torch.clamp(cthl ** 2 * thl2 + cqt ** 2 * qw2 -
                          2.0 * cthl * sqthl2 * cqt * sqqw2 * r_qwthl,
                          min=0.0)
        std_s = torch.sqrt(tmp)
        tiny_std = std_s <= np.sqrt(np.finfo(np.float64).tiny) * 100
        safe_std = torch.clamp(std_s, min=1e-300)
        pos = s > 0.0
        Cf = torch.where(tiny_std, pos.to(s.dtype),
                         0.5 * (1.0 + torch.erf(
                             s / (np.sqrt(2.0) * safe_std))))
        qn = torch.where(
            tiny_std, torch.where(pos, s, 0.0),
            torch.where(Cf != 0.0,
                        s * Cf + (std_s / np.sqrt(2.0 * np.pi)) *
                        torch.exp(-0.5 * (s / safe_std) ** 2),
                        0.0))
        bad = qn <= 0.0
        return s, std_s, torch.where(bad, 0.0, qn), torch.where(bad, 0.0, Cf)

    s1, std_s1, qn1, C1 = compute_s(qw1_1, qs1, beta1, thl2_1, qw2_1,
                                    sqrtthl2_1, sqrtqw2_1)
    s2, std_s2, qn2, C2 = compute_s(qw1_2, qs2, beta2, thl2_2, qw2_2,
                                    sqrtthl2_2, sqrtqw2_2)
    ql1 = torch.minimum(qn1, qw1_1)
    ql2 = torch.minimum(qn2, qw1_2)

    cldfrac = torch.clamp(a * C1 + (1.0 - a) * C2, max=1.0)
    ql = torch.clamp(a * ql1 + (1.0 - a) * ql2, min=0.0)
    ql2_var = torch.clamp(a * (s1 * ql1 + C1 * std_s1 ** 2) +
                          (1.0 - a) * (s2 * ql2 + C2 * std_s2 ** 2) -
                          ql ** 2, min=0.0)
    wqls = a * ((w1_1 - w_field) * ql1) + (1.0 - a) * ((w1_2 - w_field) *
                                                       ql2)
    wthv_sec = wthl_sec_zt + ((1.0 - epsterm) / epsterm) * C.basetemp * \
        wqw_sec_zt + ((C.lcond / C.cp) * exner_term -
                      (1.0 / epsterm) * C.basetemp) * wqls

    # top level: no cloud (:2204-2205 shoc_ql(:,1)=0)
    ql = ql.clone()
    ql[0] = 0.0
    return cldfrac, ql, wqls, wthv_sec, ql2_var


# ----------------------------------------------------------------- TKE
def shoc_tke(dtime, wthv_sec, shoc_mix, dz_zi, dz_zt, pres, u_wind, v_wind,
             brunt, obklen, zt_grid, zi_grid, pblh, tke, tk, tkh):
    """Advance SGS TKE + diagnose eddy diffusivities
    (shoc.F90:2929-3376). Returns (tke, tk, tkh, isotropy)."""
    # column stability integral below 800mb (:3025-3070)
    brunt_int = torch.where(pres > C.troppres, dz_zt * brunt, 0.0).sum(0)
    # shear production on interfaces (:3072-3130)
    gd = 1.0 / dz_zi[1:-1]
    u_grad = gd * (u_wind[:-1] - u_wind[1:])
    v_grad = gd * (v_wind[:-1] - v_wind[1:])
    sterm_int = 0.1 * (u_grad ** 2 + v_grad ** 2)
    sterm = torch.cat([torch.zeros_like(u_wind[:1]), sterm_int,
                       torch.zeros_like(u_wind[:1])], dim=0)
    sterm_zt = linear_interp(zi_grid, zt_grid, sterm, 0.0)

    # advance TKE (:3132-3210)
    Cs, Ck = 0.15, 0.1
    Ce = Ck ** 3 / Cs ** 4
    Cee = Ce / 0.7 * (0.19 + 0.51)
    a_prod_bu = (C.ggr / C.basetemp) * wthv_sec
    tke = torch.clamp(tke, min=0.0)
    a_prod_sh = tk * sterm_zt
    a_diss = Cee / shoc_mix * tke ** 1.5
    tke = torch.clamp(tke + dtime * (torch.clamp(a_prod_sh + a_prod_bu,
                                                 min=0.0) - a_diss),
                      min=C.mintke)
    tke = torch.clamp(tke, max=C.maxtke)

    # return-to-isotropy timescale (:3212-3277)
    tscale = (2.0 * tke) / torch.clamp(a_diss, min=1e-30)
    lam = C.lambda_low + ((brunt_int / C.ggr) -
                          C.lambda_thresh) * C.lambda_slope
    lam = torch.clamp(lam, C.lambda_low, C.lambda_high)
    lam = torch.where(brunt <= 0.0, 0.0, lam)
    isotropy = torch.clamp(tscale / (1.0 + lam * brunt * tscale ** 2),
                           max=20000.0)

    # eddy diffusivities (:3279-3376)
    z_over_L = zt_grid[-1] / obklen
    stable_pbl = (z_over_L > 0.0) & (zt_grid < pblh + 200.0)
    Ckh_s = torch.clamp(z_over_L / 100.0, C.Ckh_s_min, C.Ckh_s_max)
    Ckm_s = torch.clamp(z_over_L / 100.0, C.Ckm_s_min, C.Ckm_s_max)
    tkh = torch.where(stable_pbl,
                      Ckh_s * shoc_mix ** 2 * torch.sqrt(sterm_zt),
                      C.Ckh * isotropy * tke)
    tk = torch.where(stable_pbl,
                     Ckm_s * shoc_mix ** 2 * torch.sqrt(sterm_zt),
                     C.Ckm * isotropy * tke)
    return tke, tk, tkh, isotropy


def check_tke(tke):
    """(shoc.F90:3378-3417)."""
    return torch.clamp(tke, min=C.mintke)


# ---------------------------------------------------------------- length
def shoc_length(host_dx, host_dy, zt_grid, zi_grid, dz_zt, tke, thv):
    """Turbulent length scale (shoc.F90:3419-3502 + helpers :4661-4824).
    Returns (brunt, shoc_mix)."""
    thv_zi = linear_interp(zt_grid, zi_grid, thv, 0.0)
    brunt = (C.ggr / thv) * (thv_zi[:-1] - thv_zi[1:]) / dz_zt
    tkes = torch.sqrt(tke)
    numer = (tkes * zt_grid * dz_zt).sum(0)
    denom = (tkes * dz_zt).sum(0)
    l_inf = 0.1 * (numer / denom)
    brunt2 = torch.clamp(brunt, min=0.0)
    tscale = 400.0
    shoc_mix = torch.clamp((2.8284 * torch.sqrt(1.0 / (
        (1.0 / (tscale * tkes * C.vk * zt_grid)) +
        (1.0 / (tscale * tkes * l_inf)) +
        0.01 * (brunt2 / tke)))) / C.length_fac, max=C.maxlen)
    shoc_mix = torch.clamp(shoc_mix, C.minlen, C.maxlen)
    return brunt, torch.minimum(torch.sqrt(host_dx * host_dy), shoc_mix)


# -------------------------------------------------------------- PBL height
def shoc_diag_obklen(uw_sfc, vw_sfc, wthl_sfc, wqw_sfc, thl_sfc, cldliq_sfc,
                     qv_sfc):
    """Surface friction velocity + Obukhov length (shoc.F90:4049-4114)."""
    th_sfc = thl_sfc + (C.lcond / C.cp) * cldliq_sfc
    thv_sfc = th_sfc * (1.0 + C.eps * qv_sfc - cldliq_sfc)
    ustar = torch.clamp(torch.sqrt(uw_sfc ** 2 + vw_sfc ** 2),
                        min=C.ustar_min)
    kbfs = wthl_sfc + C.eps * th_sfc * wqw_sfc
    tiny = torch.full_like(kbfs, 1e-10)
    obklen = -thv_sfc * ustar ** 3 / \
        (C.ggr * C.vk * (kbfs + torch.where(kbfs >= 0, tiny, -tiny)))
    return ustar, kbfs, obklen


def _pblintd_height(z, u, v, ustar, thv, thv_ref, npbl, pblh0, active):
    """Richardson-number PBL height search (pblintd_height,
    shoc.F90:4330-4395): compute rino over the scan window and pick the
    LOWEST interface where rino crosses ricr."""
    nlev = z.shape[0]
    vvk = (u - u[-1:]) ** 2 + (v - v[-1:]) ** 2 + C.fac * ustar ** 2
    vvk = torch.clamp(vvk, min=C.tinyw)
    rino = C.ggr * (thv - thv_ref) * (z - z[-1:]) / (thv[-1:] * vvk)
    rino = rino.clone()
    rino[-1] = 0.0
    # scan k=nlev-2 down to nlev-npbl (0-based), i.e. upward from surface
    ks = torch.arange(nlev, device=z.device).reshape(
        (nlev,) + (1,) * (rino.ndim - 1))
    in_window = (ks >= nlev - npbl) & (ks <= nlev - 2)
    crossed = (rino >= C.ricr) & in_window
    any_cross = crossed.any(0)
    # largest k (lowest level) with crossing
    kcross = torch.where(crossed, ks, -1).argmax(0)
    kp = torch.clamp(kcross + 1, max=nlev - 1)
    r_k = _take(rino, kcross)
    r_kp = _take(rino, kp)
    z_k = _take(z, kcross)
    z_kp = _take(z, kp)
    pblh_new = z_kp + (C.ricr - r_kp) / torch.where(r_k == r_kp, 1.0,
                                                    r_k - r_kp) * (z_k - z_kp)
    found = active & any_cross
    pblh = torch.where(found, pblh_new, pblh0)
    return pblh, active & ~any_cross


def pblintd(z, zi, thl, ql, q, u, v, ustar, obklen, kbfs, cldn, npbl):
    """PBL depth diagnosis (pblintd + helpers, shoc.F90:4116-4574)."""
    th = thl + (C.lcond / C.cp) * ql
    thv = th * (1.0 + C.eps * q - ql)
    nlev = z.shape[0]

    pblh = z[-1]
    check = torch.ones_like(pblh, dtype=torch.bool)
    pblh, check = _pblintd_height(z, u, v, ustar, thv, thv[-1], npbl,
                                  pblh, check)
    # surface temperature excess pass (:4397-4461)
    pblh = torch.where(check, z[nlev - npbl], pblh)
    check = kbfs > 0.0
    binm = 15.0 * 0.1
    phiminv = _cbrt(torch.clamp(1.0 - binm * pblh / obklen, min=1e-30))
    tlv = torch.where(check, thv[-1] + kbfs * 8.5 / (ustar * phiminv),
                      thv[-1])
    pblh2, check2 = _pblintd_height(z, u, v, ustar, thv, tlv, npbl, pblh,
                                    check)
    pblh = torch.where(check, pblh2, pblh)
    check = check & check2
    # final checks (:4463-4517)
    pblh = torch.where(check, z[nlev - npbl], pblh)
    pblh = torch.maximum(pblh, 700.0 * ustar)
    # cloud check (:4519-4574)
    cldcheck = cldn[-1] >= 0.0
    return torch.where(cldcheck, torch.maximum(pblh, zi[-2] + 50.0), pblh)


# ----------------------------------------------------------- energy fixer
def shoc_energy_integrals(host_dse, pdel, rtm, rcm, u_wind, v_wind):
    """(shoc.F90:3644-3715)."""
    w = pdel / C.ggr
    se = (host_dse * w).sum(0)
    ke = (0.5 * (u_wind ** 2 + v_wind ** 2) * w).sum(0)
    wv = ((rtm - rcm) * w).sum(0)
    wl = (rcm * w).sum(0)
    return se, ke, wv, wl


def update_host_dse(thlm, shoc_ql, inv_exner, zt_grid, phis):
    """(shoc.F90:3717-3774)."""
    temp = (thlm / inv_exner) + (C.lcond / C.cp) * shoc_ql
    return C.cp * temp + C.ggr * zt_grid + phis


def shoc_energy_fixer(dtime, nadv, zt_grid, zi_grid, before, after,
                      wthl_sfc, wqw_sfc, rho_zt, tke, presi, host_dse):
    """Spread the column energy imbalance below SHOC's top
    (shoc.F90:3776-4047)."""
    se_b, ke_b, wv_b, wl_b = before
    se_a, ke_a, wv_a, wl_a = after
    hdtime = dtime * nadv
    rho_zi = linear_interp(zt_grid, zi_grid, rho_zt, 0.0)
    shf = wthl_sfc * C.cp * rho_zi[-1]
    lhf = wqw_sfc * rho_zi[-1]
    te_a = se_a + ke_a + (C.lcond + C.lice) * wv_a + C.lice * wl_a
    te_b = se_b + ke_b + (C.lcond + C.lice) * wv_b + C.lice * wl_b
    te_b = te_b + (shf + lhf * (C.lcond + C.lice)) * hdtime
    # shoctop: first level from top where tke > mintke (:3963-4011)
    nlev = tke.shape[0]
    active = tke > C.mintke
    shoctop = active.to(torch.uint8).argmax(0)
    shoctop = torch.where(active.any(0), shoctop, nlev - 2)
    shoctop = torch.clamp(shoctop, max=nlev - 2)
    se_dis = (te_a - te_b) / (presi[-1] - _take(presi, shoctop))
    ks = torch.arange(nlev, device=tke.device).reshape(
        (nlev,) + (1,) * (tke.ndim - 1))
    return torch.where(ks >= shoctop[None], host_dse - se_dis * C.ggr,
                       host_dse)


# ------------------------------------------------------------------ main
def shoc_main(dtime, nadv, host_dx, host_dy, thv, zt_grid, zi_grid, pres,
              presi, pdel, wthl_sfc, wqw_sfc, uw_sfc, vw_sfc, wtracer_sfc,
              w_field, inv_exner, phis, host_dse, tke, thetal, qw, u_wind,
              v_wind, qtracers, wthv_sec, tkh, tk, shoc_ql, shoc_cldfrac,
              npbl):
    """Full SHOC step over (nlev, ...cols) z-leading columns
    (shoc.F90 shoc_main:187-565). Returns dict of updated state + diags."""
    before = shoc_energy_integrals(host_dse, pdel, qw, shoc_ql, u_wind,
                                   v_wind)
    dz_zt, dz_zi, rho_zt = shoc_grid(zt_grid, zi_grid, pdel)
    diags = {}
    for _ in range(nadv):
        tke = check_tke(tke)
        shoc_qv = compute_shoc_vapor(qw, shoc_ql)
        ustar, kbfs, obklen = shoc_diag_obklen(
            uw_sfc, vw_sfc, wthl_sfc, wqw_sfc, thetal[-1],
            shoc_ql[-1], shoc_qv[-1])
        pblh = pblintd(zt_grid, zi_grid, thetal, shoc_ql, shoc_qv, u_wind,
                       v_wind, ustar, obklen, kbfs, shoc_cldfrac, npbl)
        brunt, shoc_mix = shoc_length(host_dx, host_dy, zt_grid, zi_grid,
                                      dz_zt, tke, thv)
        tke, tk, tkh, isotropy = shoc_tke(
            dtime, wthv_sec, shoc_mix, dz_zi, dz_zt, pres, u_wind, v_wind,
            brunt, obklen, zt_grid, zi_grid, pblh, tke, tk, tkh)
        thetal, qw, qtracers, tke, u_wind, v_wind = \
            update_prognostics_implicit(
                dtime, dz_zt, dz_zi, rho_zt, zt_grid, zi_grid, tk, tkh,
                uw_sfc, vw_sfc, wthl_sfc, wqw_sfc, wtracer_sfc, thetal, qw,
                qtracers, tke, u_wind, v_wind)
        mom = diag_second_shoc_moments(
            thetal, qw, u_wind, v_wind, tke, isotropy, tkh, tk, dz_zi,
            zt_grid, zi_grid, shoc_mix, wthl_sfc, wqw_sfc, uw_sfc, vw_sfc)
        w3 = diag_third_shoc_moments(
            mom["w_sec"], mom["thl_sec"], mom["wthl_sec"], isotropy, brunt,
            thetal, tke, dz_zt, dz_zi, zt_grid, zi_grid)
        shoc_cldfrac, shoc_ql, wqls, wthv_sec, shoc_ql2 = shoc_assumed_pdf(
            thetal, qw, w_field, mom["thl_sec"], mom["qw_sec"],
            mom["wthl_sec"], mom["w_sec"], mom["wqw_sec"],
            mom["qwthl_sec"], w3, pres, zt_grid, zi_grid)
        tke = check_tke(tke)
        diags = dict(mom, w3=w3, wqls_sec=wqls, shoc_ql2=shoc_ql2,
                     brunt=brunt, shoc_mix=shoc_mix, isotropy=isotropy,
                     pblh=pblh, ustar=ustar, obklen=obklen)

    host_dse = update_host_dse(thetal, shoc_ql, inv_exner, zt_grid, phis)
    after = shoc_energy_integrals(host_dse, pdel, qw, shoc_ql, u_wind,
                                  v_wind)
    host_dse = shoc_energy_fixer(dtime, nadv, zt_grid, zi_grid, before,
                                 after, wthl_sfc, wqw_sfc, rho_zt, tke,
                                 presi, host_dse)
    # final PBL diagnosis (:537-556)
    shoc_qv = compute_shoc_vapor(qw, shoc_ql)
    ustar, kbfs, obklen = shoc_diag_obklen(
        uw_sfc, vw_sfc, wthl_sfc, wqw_sfc, thetal[-1],
        shoc_ql[-1], shoc_qv[-1])
    pblh = pblintd(zt_grid, zi_grid, thetal, shoc_ql, shoc_qv, u_wind,
                   v_wind, ustar, obklen, kbfs, shoc_cldfrac, npbl)
    diags.update(pblh=pblh, ustar=ustar, obklen=obklen)

    state = dict(host_dse=host_dse, tke=tke, thetal=thetal, qw=qw,
                 u_wind=u_wind, v_wind=v_wind, qtracers=qtracers,
                 wthv_sec=wthv_sec, tk=tk, tkh=tkh, shoc_ql=shoc_ql,
                 shoc_cldfrac=shoc_cldfrac)
    return state, diags

"""DEC operators, Hodge stars and wedge/Q/W products for the extruded SPAM
x-z slab (port of pam_tpu/spam/operators.py:26-297; ref
dynamics/spam/src/operators/{ext_deriv.h, hodge_star.h,
hodge_star_extruded.h, wedge.h}).

Layout (…, nens, nlev, nx); x periodic (rolls), z stencils by mirror
padding as the reference's Exchange::exchange_mirror (exchange.h:565-606):

* layer fields:     halo(-1-m) = a(m),   halo(n+m) = a(n-1-m)
* interface fields: halo(-1-m) = a(m+1), halo(n+m) = a(n-2-m)
"""

from __future__ import annotations

import torch

from ..parallel import comm

AXZ = -2  # z axis
AXX = -1  # x axis


def rollm(a, s):
    """result[i] = a[i+s] along x (periodic)."""
    return comm.proll(a, s, axis=AXX)


def _flip(a, start, stop):
    return torch.flip(a[..., start:stop, :], dims=(AXZ,))


def mirror_layer(a, h: int):
    """Mirror-pad a layer field along z by h (exchange.h:571-585)."""
    n = a.shape[AXZ]
    return torch.cat([_flip(a, 0, h), a, _flip(a, n - h, n)], dim=AXZ)


def mirror_iface(a, h: int):
    """Mirror-pad an interface field along z by h (exchange.h:589-602)."""
    n = a.shape[AXZ]
    return torch.cat([_flip(a, 1, h + 1), a, _flip(a, n - 1 - h, n - 1)],
                     dim=AXZ)


# ---------------------------------------------------------------------------
# exterior derivatives
# ---------------------------------------------------------------------------


def Dnm1bar_x(U, recon=None):
    """Horizontal dual divergence: out[i] = U[i+1]r[i+1] - U[i]r[i]."""
    UR = U if recon is None else U * recon
    return rollm(UR, 1) - UR


def Dnm1bar_vert(UW, recon=None):
    """Vertical part: out[k] = UW[k+1]r[k+1] - UW[k]r[k] (interfaces ->
    layers)."""
    UR = UW if recon is None else UW * recon
    return UR[..., 1:, :] - UR[..., :-1, :]


def D1_ext(v, w_pad):
    """Curl at dual vertices k=0..nz: zeta[k] = v[k-1] - v[k] + w[k-1,i] -
    w[k-1,i-1] (ext_deriv.h:822-843); w_pad = mirror_layer(w, 1)."""
    v_pad = mirror_iface(v, 1)  # v_pad[k] = v[k-1]
    dv = v_pad[..., :-1, :] - v_pad[..., 1:, :]
    dw = w_pad - rollm(w_pad, -1)
    return dv + dw


# ---------------------------------------------------------------------------
# Hodge stars (diagonal, 2nd order)
# ---------------------------------------------------------------------------

def H10(v, geom):
    """U[k] = v[k] dz_d(k)/dx (hodge_star_extruded.h:111-147)."""
    return v * (geom.dz_d_t[:, :, None] / geom.dx)


def H01(w, geom):
    """UW[k] = w[k-1] dx/dz_p(k-1) for k=1..nz-1, zero at the rigid
    boundaries (hodge_star_extruded.h:197-237). (nens,nz-1,nx) ->
    (nens,nz+1,nx)."""
    inner = w * (geom.dx / geom.dz_p_t[:, :, None])
    z = torch.zeros_like(inner[..., :1, :])
    return torch.cat([z, inner, z], dim=AXZ)


def Hn1bar(dens, geom):
    """0-form from dual n-form: dens[k]/(dx dz_d(k))
    (hodge_star_extruded.h:517-624)."""
    return dens / (geom.dx * geom.dz_d_t[:, :, None])


# ---------------------------------------------------------------------------
# wedge / W / Q operators (ndims=1 signs)
# ---------------------------------------------------------------------------

def Wxz_u(FW):
    """Tangent average of FW onto v-points (wedge.h:811-856)."""
    s = FW + rollm(FW, -1)
    interior = -0.25 * (s[..., 1:-2, :] + s[..., 2:-1, :])
    bot = -0.5 * s[..., 0:1, :]
    top = -0.5 * s[..., -1:, :]
    return torch.cat([bot, interior, top], dim=AXZ)


def Wxz_w(F):
    """Tangent average of F onto w-points; the boundary rows read the
    interior-shifted dual layer with coefficient 0.25 (wedge.h:880-902)."""
    s = F + rollm(F, 1)
    interior = 0.25 * (s[..., 1:-2, :] + s[..., 2:-1, :])
    bot = 0.25 * s[..., 1:2, :]
    top = 0.25 * s[..., -2:-1, :]
    return torch.cat([bot, interior, top], dim=AXZ)


def R_avg(D):
    """Dual-vertex average of total density with the reference's interior,
    bottom (k=1) and top (k=nz-1) forms (functionals.h R/Rbnd); rows 0 and
    nz are zero. (nens,nz,nx) -> (nens,nz+1,nx)."""
    Ds = D + rollm(D, -1)
    nz = D.shape[AXZ]
    full_int = 0.25 * (Ds[..., :-1, :] + Ds[..., 1:, :])
    bot = 0.25 * Ds[..., 1:2, :] + 0.5 * Ds[..., 0:1, :]
    top = 0.25 * Ds[..., -2:-1, :] + 0.5 * Ds[..., -1:, :]
    z = torch.zeros_like(bot)
    if nz > 2:
        return torch.cat([z, bot, full_int[..., 1:-1, :], top, z], dim=AXZ)
    return torch.cat([z, bot, top, z], dim=AXZ)


def Qxz_w(qr, qvr, F):
    """PV flux term of the w-tendency, energy-conserving form
    (wedge.h compute_Qxz_w_EC + _top/_bottom, ndims=1 => sgn=+1).
    qr (nens,nz-1,nx), qvr (nens,nz,nx), F (nens,nz,nx)."""
    Fp = rollm(F, 1)
    qvrp = rollm(qvr, 1)
    t = (F[..., 1:-2, :] * (qvr[..., 1:-2, :] + qr[..., 1:-1, :]) +
         Fp[..., 1:-2, :] * (qvrp[..., 1:-2, :] + qr[..., 1:-1, :]) +
         F[..., 2:-1, :] * (qvr[..., 2:-1, :] + qr[..., 1:-1, :]) +
         Fp[..., 2:-1, :] * (qvrp[..., 2:-1, :] + qr[..., 1:-1, :]))
    interior = 0.125 * t
    bot = 0.125 * (F[..., 1:2, :] * (qvr[..., 1:2, :] + qr[..., 0:1, :]) +
                   Fp[..., 1:2, :] * (qvrp[..., 1:2, :] + qr[..., 0:1, :]))
    top = 0.125 * (F[..., -2:-1, :] * (qvr[..., -2:-1, :] + qr[..., -1:, :]) +
                   Fp[..., -2:-1, :] * (qvrp[..., -2:-1, :] + qr[..., -1:, :]))
    return torch.cat([bot, interior, top], dim=AXZ)


def Qxz_u(qr_pad, qvr, FW):
    """PV flux term of the v-tendency, EC form (wedge.h compute_Qxz_u_EC +
    _top/_bottom, ndims=1 => sgn=-1). qr_pad = mirror_layer(qhzrecon, 1),
    qvr (nens,nz,nx), FW (nens,nz+1,nx)."""
    FWm = rollm(FW, -1)
    qrm = rollm(qr_pad, -1)
    t = (FW[..., 1:-2, :] * (qr_pad[..., 1:-2, :] + qvr[..., 1:-1, :]) +
         FWm[..., 1:-2, :] * (qrm[..., 1:-2, :] + qvr[..., 1:-1, :]) +
         FW[..., 2:-1, :] * (qr_pad[..., 2:-1, :] + qvr[..., 1:-1, :]) +
         FWm[..., 2:-1, :] * (qrm[..., 2:-1, :] + qvr[..., 1:-1, :]))
    interior = -0.125 * t
    bot = -0.5 * (FW[..., 0:1, :] + FWm[..., 0:1, :]) * qvr[..., 0:1, :]
    top = -0.5 * (FW[..., -1:, :] + FWm[..., -1:, :]) * qvr[..., -1:, :]
    return torch.cat([bot, interior, top], dim=AXZ)


def phi_x(dens0):
    """Edge average along x: he[k,i] = 0.5*(dens0[k,i]+dens0[k,i-1])."""
    return 0.5 * (dens0 + rollm(dens0, -1))


def phi_z_iface(dens0tot_pad):
    """Edge average onto dual interfaces from a mirror-padded-by-1 field."""
    return 0.5 * (dens0tot_pad[..., 1:, :] + dens0tot_pad[..., :-1, :])


# ---------------------------------------------------------------------------
# higher-order Hodge stars: horizontal stencil corrections of diff_ord
# 2/4/6 (hodge_star.h H1 / H2bar 3- and 5-point variants:30-193); the
# vertical factors stay diagonal (vert_diff_ord=2, the compile default)
# ---------------------------------------------------------------------------

def _h1_stencil_x(v, ord: int):
    """Flux-averaging correction along x of a 1-form component
    (hodge_star.h H1:43-73)."""
    if ord == 2:
        return v
    if ord == 4:
        return (-1.0 / 24.0) * rollm(v, -1) + (26.0 / 24.0) * v + \
            (-1.0 / 24.0) * rollm(v, 1)
    if ord == 6:
        return ((9.0 / 1920.0) * rollm(v, -2) +
                (-116.0 / 1920.0) * rollm(v, -1) +
                (2134.0 / 1920.0) * v +
                (-116.0 / 1920.0) * rollm(v, 1) +
                (9.0 / 1920.0) * rollm(v, 2))
    raise ValueError(f"diff_ord must be 2, 4 or 6, got {ord}")


def _h2bar_stencil_x(a, ord: int):
    """0-form recovery correction along x (hodge_star.h H2bar:153-193)."""
    if ord == 2:
        return a
    if ord == 4:
        return a + ((-1.0 / 24.0) * rollm(a, -1) + (2.0 / 24.0) * a +
                    (-1.0 / 24.0) * rollm(a, 1))
    if ord == 6:
        return a + ((9.0 / 1920.0) * rollm(a, -2) +
                    (-116.0 / 1920.0) * rollm(a, -1) +
                    (214.0 / 1920.0) * a +
                    (-116.0 / 1920.0) * rollm(a, 1) +
                    (9.0 / 1920.0) * rollm(a, 2))
    raise ValueError(f"diff_ord must be 2, 4 or 6, got {ord}")


def H10_ho(v, geom, ord: int = 2):
    """H10 with horizontal diff_ord 2/4/6."""
    return H10(_h1_stencil_x(v, ord), geom)


def Hn1bar_ho(dens, geom, ord: int = 2):
    """Hn1bar with horizontal diff_ord 2/4/6."""
    return _h2bar_stencil_x(Hn1bar(dens, geom), ord)

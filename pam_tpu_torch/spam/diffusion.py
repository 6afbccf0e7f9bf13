"""Scalar and velocity diffusion of the SPAM x-z slab (port of
pam_tpu/spam/diffusion.py; ref dynamics/spam/src/models/extrudedmodel.h
add_scalar_diffusion :1176-1293 and add_velocity_diffusion_2d
:1294-1438, applied at the end of the right-hand side when a coefficient
is positive, :2439-2484). The velocity diffusion is the vorticity /
divergence (Hodge-Laplacian) split

    dv/dt += nu_div * grad(div u) - nu_vort * curl(zeta).

Both functions ADD to the right-hand side F of d(state)/dt = -F. The
diagonal Hodge factors are hodge_star_extruded.h's (H10:111, H01:197,
Hn1:456, Hn1bar, Hnm11bar:356, Hn0bar:411) for ndims=1, uniform x.
"""

from __future__ import annotations

import torch

from . import operators as op
from .operators import AXZ, mirror_layer, rollm


def scalar_diffusion(tend, dens, denstend, coeff_h, coeff_v,
                     diffused_ids=None):
    """``denstend`` plus the diffusion of the diffused densities: the
    concentrations q = dens / rho are diffused and the flux divergence is
    multiplied back by rho (extrudedmodel.h:1204-1292). By default the
    entropic density and every physics tracer are diffused, the mass is
    not (variableset.h:991, 1104)."""
    g, vs = tend.geom, tend.varset
    if diffused_ids is None:
        diffused_ids = [vs.dens_id_entr] + [
            2 + i for i in range(vs.ntracers_physics)]
    rho_n = vs.get_total_density(dens)
    q = dens[diffused_ids] / rho_n[None]
    if tend.force_refstate_hydrostatic_balance and tend.ref_q_pi is not None:
        q = q - tend.ref_q_pi[diffused_ids][:, :, :, None]
    dz_d = g.dz_d_t[:, :, None]
    dz_p = g.dz_p_t[:, :, None]

    # horizontal flux at x-edges: D0 * H10 (dz_d/dx)
    hdiv = op.Dnm1bar_x(op.D0_x(q) * (dz_d / g.dx))
    # vertical flux at interior interfaces: D0_vert * H01 (dx/dz_p)
    Fz_int = (q[..., 1:, :] - q[..., :-1, :]) * (g.dx / dz_p)
    zeros = torch.zeros_like(Fz_int[..., :1, :])
    vdiv = op.Dnm1bar_vert(torch.cat([zeros, Fz_int, zeros], dim=AXZ))

    Hn1bar_diag = 1.0 / (g.dx * dz_d)
    diff = (-coeff_h * rho_n[None] * Hn1bar_diag * hdiv
            - coeff_v * rho_n[None] * Hn1bar_diag * vdiv)
    out = denstend.clone()
    out[diffused_ids] = denstend[diffused_ids] + diff
    return out


def velocity_diffusion(tend, v, w, vtend, wtend,
                       vort_h, vort_v, div_h, div_v):
    """(vtend, wtend) plus the vorticity/divergence diffusion of the
    primal 1-forms v (nens, nz, nx) and w (nens, nz-1, nx)
    (extrudedmodel.h add_velocity_diffusion_2d:1294-1438)."""
    g = tend.geom
    dz_d = g.dz_d_t[:, :, None]
    dz_p = g.dz_p_t[:, :, None]

    # vorticity: qhz = Hn1 D1(v, w) at dual vertices; Hn1 at interior
    # vertex k is 1/(dx dz_p[k-1]) (hodge:456-461), zero on the boundary
    # rows (set_bnd, :1229)
    zeta = op.D1_ext(v, mirror_layer(w, 1))
    zrow = torch.zeros_like(dz_p[..., :1, :])
    inv_area = torch.cat([zrow, 1.0 / (g.dx * dz_p), zrow], dim=AXZ)
    qhz = zeta * inv_area
    # v: +c (dx/dz_d[k]) (qhz[k+1] - qhz[k]) (Hnm11bar = -dx/dz_d)
    vtend = vtend + vort_h * (g.dx / dz_d) * (qhz[..., 1:, :] -
                                             qhz[..., :-1, :])
    # w: -c (dz_p[k]/dx) (qhz[k+1,i+1] - qhz[k+1,i]) (Hn0bar = -dz_p/dx)
    qhz_in = qhz[..., 1:-1, :]
    wtend = wtend - vort_v * (dz_p / g.dx) * (rollm(qhz_in, 1) - qhz_in)

    # divergence: Hn1bar (Dnm1bar H10 v + Dnm1bar_vert H01 w)
    div = (op.Dnm1bar_x(op.H10(v, g)) +
           op.Dnm1bar_vert(op.H01(w, g))) / (g.dx * dz_d)
    vtend = vtend - div_h * op.D0_x(div)
    wtend = wtend - div_v * (div[..., 1:, :] - div[..., :-1, :])
    return vtend, wtend

"""P3 hydrometeor sedimentation with adaptive Courant substepping (port of
pam_tpu/physics/p3/sedimentation.py; ref micro_p3.F90
cloud_sedimentation :3587-3747, rain_sedimentation :3749-3870,
ice_sedimentation :3911-4065, generalized_sedimentation :4067-4104,
calc_first_order_upwind_step :4106-4143).

The reference's per-column ``do while (dt_left > 1e-4)`` becomes one
loop over a whole batch of columns, ``ops/graph.py::while_loop`` as in
pam_tpu's ``lax.while_loop``: every column carries its own ``dt_left``;
finished columns take zero-length substeps, and every in-loop update is
gated on the column still being active, so those substeps are exact
no-ops. The loop's condition, ``any(dt_left > 1e-4)``, is a device
tensor: the eager route reads it once a substep round (a host sync on
the card), the compiled step (``MmfDriver._graphed_single``) tests it on
the device. ``combined_sedimentation`` (the one the P3 step runs) adds
the rounds it took to its ``rounds`` count.

In-cloud values are carried as the reference carries them: the first
substep uses part2's final in-cloud mixing ratios, every later substep
the plain cell-average/cld_frac division.

Orientation: (nz, ...batch) with k=0 the TOP. Falling flux moves k ->
k+1; the flux leaving k=nz-1 accumulates as surface precipitation.
"""

from __future__ import annotations

import torch

from ...ops import graph
from .constants import CONST, QSMALL, NSMALL
from . import tables as tbl
from .main import cloud_dsd, rain_dsd, bulk_rho_rime, _gamma

C = CONST


def _upwind(qs, Vs, rho, inv_rho, inv_dz, dt_sub):
    """First-order upwind update for several species sharing one substep
    (calc_first_order_upwind_step, :4106-4143). Returns the updated
    arrays and the mass flux of the first species."""
    outs = []
    flux_q = None
    for q, V in zip(qs, Vs):
        flux = V * q * rho
        if flux_q is None:
            flux_q = flux
        fup = torch.cat([torch.zeros_like(flux[:1]), flux[:-1]], dim=0)
        outs.append(q + (fup - flux) * inv_dz * dt_sub * inv_rho)
    return outs, flux_q


def _dt_sub(co_max, dt_left):
    """generalized_sedimentation substep length (:4090-4092)."""
    nsub = torch.floor(co_max + 1.0)
    active = dt_left > 1.0e-4
    return torch.where(active, torch.minimum(
        dt_left, dt_left / torch.clamp(nsub, min=1.0)), 0.0)


# ---------------------------------------------------------------------------
# per-species substep bodies, shared by the single-species loops and the
# combined loop
# ---------------------------------------------------------------------------

def _cloud_substep(qc, nc, qc_in, nc_in, dt_left, prt, rho, inv_rho,
                   cld_frac_l, acn, inv_dz, do_predict_nc):
    """One adaptive substep of cloud sedimentation (:3587-3747).
    Returns (qc, nc, qc_in, nc_in, dt_left, prt)."""
    act = dt_left > 1.0e-4
    has = (qc_in > QSMALL) & act
    nc_in2, mu_c, lamc, _, _ = cloud_dsd(qc_in, nc_in, rho)
    nc_new = torch.where(has, nc_in2 * cld_frac_l, nc)
    dum = 1.0 / torch.clamp(lamc, min=1e-300) ** C.bcn
    v_qc = torch.where(has, acn * _gamma(4.0 + C.bcn + mu_c) * dum /
                       _gamma(mu_c + 4.0), 0.0)
    v_nc = torch.where(has, acn * _gamma(1.0 + C.bcn + mu_c) * dum /
                       _gamma(mu_c + 1.0), 0.0)
    co_max = (v_qc * dt_left * inv_dz).amax(dim=0)
    dts = _dt_sub(co_max, dt_left)
    if do_predict_nc:
        (qc2, nc2), flux_q = _upwind([qc, nc_new], [v_qc, v_nc],
                                     rho, inv_rho, inv_dz, dts)
    else:
        (qc2,), flux_q = _upwind([qc], [v_qc], rho, inv_rho, inv_dz, dts)
        nc2 = nc_new
    # post-substep in-cloud refresh (:3702-3706); finished columns keep
    # their carried values
    qc_in2 = torch.where(act, qc2 / cld_frac_l, qc_in)
    nc_in2b = torch.where(act, nc2 / cld_frac_l, nc_in)
    return (qc2, nc2, qc_in2, nc_in2b, dt_left - dts,
            prt + flux_q[-1] * dts)


def _rain_substep(qr, nr, qr_in, nr_in, dt_left, prt, rho, inv_rho,
                  cld_frac_r, rhofacr, inv_dz, vn_t, vm_t):
    """One adaptive substep of rain sedimentation (:3749-3870).
    Returns (qr, nr, qr_in, nr_in, dt_left, prt)."""
    act = dt_left > 1.0e-4
    has = (qr_in > QSMALL) & act
    nr_in2, mu_r, lamr, _, _ = rain_dsd(qr_in, nr_in)
    nr_new = torch.where(has, nr_in2 * cld_frac_r, nr)
    ii, jj, rii, rjj = tbl.indices_3(mu_r, torch.clamp(lamr, min=1e-300))
    vm_val, vn_val = tbl.access_rain_table_multi((vm_t, vn_t), rii, rjj)
    v_qr = torch.where(has, vm_val * rhofacr, 0.0)
    v_nr = torch.where(has, vn_val * rhofacr, 0.0)
    co_max = (v_qr * dt_left * inv_dz).amax(dim=0)
    dts = _dt_sub(co_max, dt_left)
    (qr2, nr2), flux_q = _upwind([qr, nr_new], [v_qr, v_nr], rho,
                                 inv_rho, inv_dz, dts)
    qr_in2 = torch.where(act, qr2 / cld_frac_r, qr_in)
    nr_in2b = torch.where(act, nr2 / cld_frac_r, nr_in)
    return (qr2, nr2, qr_in2, nr_in2b, dt_left - dts,
            prt + flux_q[-1] * dts)


def _ice_substep(qi, ni, qm, bm, qi_in, ni_in, qm_in, bm_in, dt_left, prt,
                 rho, inv_rho, cld_frac_i, rhofaci, inv_dz, ice_tab):
    """One adaptive substep of ice sedimentation (:3911-4065).
    Returns (qi, ni, qm, bm, qi_in, ni_in, qm_in, bm_in, dt_left, prt)."""
    act = dt_left > 1.0e-4
    has = (qi_in > QSMALL) & act
    ni_in = torch.clamp(ni_in, min=NSMALL)
    qm_in2, bm_in2, rhop = bulk_rho_rime(qi_in, qm_in, bm_in)
    qm_new = torch.where(has, qm_in2 * cld_frac_i, qm)
    bm_new = torch.where(has, bm_in2 * cld_frac_i, bm)
    di, djj, dii, d1, d4, d5 = tbl.indices_1a(
        torch.clamp(qi_in, min=1e-300), ni_in, qm_in2, rhop)
    # number- and mass-weighted fall speeds and the lambda limits at one
    # fractional position
    v_n, v_q, lammax, lammin = tbl.access_ice_table_multi(
        ice_tab, (0, 1, 6, 7), d1, d4, d5)
    ni_in = torch.where(has, torch.clamp(
        ni_in, lammin * ni_in, torch.maximum(lammax * ni_in,
                                             lammin * ni_in)), ni_in)
    ni_new = torch.where(has, ni_in * cld_frac_i, ni)
    v_qit = torch.where(has, v_q * rhofaci, 0.0)
    v_nit = torch.where(has, v_n * rhofaci, 0.0)
    co_max = (v_qit * dt_left * inv_dz).amax(dim=0)
    dts = _dt_sub(co_max, dt_left)
    (qi2, ni2, qm2, bm2), flux_q = _upwind(
        [qi, ni_new, qm_new, bm_new],
        [v_qit, v_nit, v_qit, v_qit], rho, inv_rho, inv_dz, dts)
    qi_in2 = torch.where(act, qi2 / cld_frac_i, qi_in)
    ni_in2 = torch.where(act, ni2 / cld_frac_i, ni_in)
    qm_in2c = torch.where(act, qm2 / cld_frac_i, qm_in)
    bm_in2c = torch.where(act, bm2 / cld_frac_i, bm_in)
    return (qi2, ni2, qm2, bm2, qi_in2, ni_in2, qm_in2c, bm_in2c,
            dt_left - dts, prt + flux_q[-1] * dts)


def _active(*dt_lefts):
    """Whether any column of any species has time left: the loops'
    predicate, a 0-d bool tensor."""
    m = dt_lefts[0]
    for d in dt_lefts[1:]:
        m = torch.maximum(m, d)
    return torch.any(m > 1.0e-4)


def _start(q):
    """(dt_left, prt) of a fresh loop: zeros of the batch shape."""
    return torch.zeros_like(q[0]), torch.zeros_like(q[0])


# ---------------------------------------------------------------------------
# single-species loops
# ---------------------------------------------------------------------------

def cloud_sedimentation(qc, nc, rho, inv_rho, cld_frac_l, acn, inv_dz, dt,
                        do_predict_nc=False, qc_in=None, nc_in=None):
    """Stokes-regime cloud droplet sedimentation (:3587-3747); with
    do_predict_nc=False only qc sediments. qc_in/nc_in: first-substep
    in-cloud values (default qc/cld_frac_l).
    Returns (qc, nc, precip_liq_surf [m/s])."""
    if qc_in is None:
        qc_in, nc_in = qc / cld_frac_l, nc / cld_frac_l
    dtl, prt = _start(qc)
    qc, nc, qc_in, nc_in, dtl, prt = graph.while_loop(
        lambda c: _active(c[4]),
        lambda c: _cloud_substep(*c, rho, inv_rho, cld_frac_l, acn, inv_dz,
                                 do_predict_nc),
        (qc, nc, qc_in, nc_in, dtl + dt, prt))
    return qc, nc, prt * C.inv_rho_h2o / dt


def rain_sedimentation(qr, nr, rho, inv_rho, rhofacr, cld_frac_r, inv_dz,
                       dt, qr_in=None, nr_in=None):
    """Rain sedimentation with table-interpolated fall speeds (:3749-3870,
    compute_rain_fall_velocity :3872-3909).
    Returns (qr, nr, precip_liq_surf [m/s])."""
    _, _, vn_t, vm_t, _ = tbl.device_tables(qr.device, qr.dtype)
    if qr_in is None:
        qr_in, nr_in = qr / cld_frac_r, nr / cld_frac_r
    dtl, prt = _start(qr)
    qr, nr, qr_in, nr_in, dtl, prt = graph.while_loop(
        lambda c: _active(c[4]),
        lambda c: _rain_substep(*c, rho, inv_rho, cld_frac_r, rhofacr,
                                inv_dz, vn_t, vm_t),
        (qr, nr, qr_in, nr_in, dtl + dt, prt))
    return qr, nr, prt * C.inv_rho_h2o / dt


def ice_sedimentation(qi, ni, qm, bm, rho, inv_rho, rhofaci, cld_frac_i,
                      inv_dz, dt, qi_in=None, ni_in=None, qm_in=None,
                      bm_in=None):
    """Ice sedimentation: qi/qm/bm fall at the mass-weighted speed, ni at
    the number-weighted speed (:3911-4065).
    Returns (qi, ni, qm, bm, precip_ice_surf [m/s])."""
    ice_tab = tbl.device_tables(qi.device, qi.dtype)[0]
    if qi_in is None:
        qi_in, ni_in, qm_in, bm_in = (x / cld_frac_i
                                      for x in (qi, ni, qm, bm))
    dtl, prt = _start(qi)
    qi, ni, qm, bm, _, _, _, _, dtl, prt = graph.while_loop(
        lambda c: _active(c[8]),
        lambda c: _ice_substep(*c, rho, inv_rho, cld_frac_i, rhofaci,
                               inv_dz, ice_tab),
        (qi, ni, qm, bm, qi_in, ni_in, qm_in, bm_in, dtl + dt, prt))
    return qi, ni, qm, bm, prt * C.inv_rho_h2o / dt


def combined_sedimentation(qc, nc, qr, nr, qi, ni, qm, bm, rho, inv_rho,
                           cld_frac_l, cld_frac_r, cld_frac_i, acn, rhofacr,
                           rhofaci, inv_dz, dt, do_predict_nc=False,
                           inc=None):
    """All three species' substep loops in one loop: each species keeps
    its own per-column ``dt_left`` and substep length and every update is
    gated on that species' column being active, so a finished species
    takes exact no-op substeps and the results match the three loops run
    separately. One predicate a substep round (not three).

    inc: part2's final (qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in,
    bm_in) for the first substep; default plain division.

    Returns (qc, nc, prt_liq_c, qr, nr, prt_liq_r, qi, ni, qm, bm, prt_ice).
    """
    ice_tab, _, vn_t, vm_t, _ = tbl.device_tables(qc.device, qc.dtype)
    if inc is None:
        qc_in, nc_in = qc / cld_frac_l, nc / cld_frac_l
        qr_in, nr_in = qr / cld_frac_r, nr / cld_frac_r
        qi_in, ni_in, qm_in, bm_in = (x / cld_frac_i
                                      for x in (qi, ni, qm, bm))
    else:
        qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in, bm_in = inc
    zero, prt_c = _start(qc)
    prt_r, prt_i = torch.zeros_like(zero), torch.zeros_like(zero)
    dtl = zero + dt

    def round_(c):
        cloud, rain, ice = c
        return (_cloud_substep(*cloud, rho, inv_rho, cld_frac_l, acn,
                               inv_dz, do_predict_nc),
                _rain_substep(*rain, rho, inv_rho, cld_frac_r, rhofacr,
                              inv_dz, vn_t, vm_t),
                _ice_substep(*ice, rho, inv_rho, cld_frac_i, rhofaci,
                             inv_dz, ice_tab))
    cloud, rain, ice = graph.while_loop(
        lambda c: _active(c[0][4], c[1][4], c[2][8]), round_,
        ((qc, nc, qc_in, nc_in, dtl, prt_c),
         (qr, nr, qr_in, nr_in, dtl, prt_r),
         (qi, ni, qm, bm, qi_in, ni_in, qm_in, bm_in, dtl, prt_i)),
        counter=(combined_sedimentation, "rounds"), name="p3.sedimentation")
    qc, nc, _, _, _, prt_c = cloud
    qr, nr, _, _, _, prt_r = rain
    qi, ni, qm, bm, _, _, _, _, _, prt_i = ice
    s = C.inv_rho_h2o / dt
    return (qc, nc, prt_c * s, qr, nr, prt_r * s,
            qi, ni, qm, bm, prt_i * s)


combined_sedimentation.rounds = 0

"""Kessler warm-rain microphysics (qv / qc / qr) (port of
pam_tpu/physics/kessler.py:26-215; ref physics/micro/kessler/
Microphysics.h, the Klemp-Wilhelmson (1978) scheme with CFL-sub-cycled
upstream rain sedimentation).

Whole-array torch ops over columns. The rain sub-cycle count is one
global minimum over the whole batch (Microphysics.h:372-390), a device
tensor as in pam_tpu. The sub-cycles are ``ops/graph.py::fori_loop``: the
eager route reads the count once a call, the compiled step
(``MmfDriver._graphed_single``) loops on the device, as pam_tpu's
``lax.while_loop`` on ``nt < rainsplit``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import Constants
from ..core.coupler import Coupler
from ..ops import graph
from ..parallel import comm

TRACER_NAMES = ("water_vapor", "cloud_liquid", "precip_liquid")


def register(coupler: Coupler) -> Coupler:
    """Add Kessler's tracers and set the scheme option (ref: init,
    Microphysics.h:58-97)."""
    cpl = coupler
    cpl = cpl.add_tracer("water_vapor", "Water Vapor", True, True)
    cpl = cpl.add_tracer("cloud_liquid", "Cloud liquid", True, True)
    cpl = cpl.add_tracer("precip_liquid", "precip_liquid", True, True)
    return cpl.with_options(micro="kessler")


def init_state(coupler: Coupler, state):
    out = dict(state)
    if "precl" not in out:
        out["precl"] = torch.zeros((coupler.nens, coupler.ny, coupler.nx),
                                   dtype=coupler.dtype, device=coupler.device)
    return out


def _terminal_velocity(qr, r, rhalf):
    """Liquid water terminal velocity, KW eq. 2.15 (Microphysics.h:370)."""
    return 36.34 * torch.clamp(qr * r, min=0.0) ** 0.1364 * rhalf


def _over_count(x, n):
    """x / n for a trip count n (a 0-d integer tensor), rounded as x /
    int(n) rounds on x's device: PyTorch's CUDA division by a host scalar
    multiplies by the scalar's reciprocal, the CPU's divides."""
    n = n.to(x.dtype)
    return x * torch.reciprocal(n) if x.is_cuda else x / n


def kessler_column(theta, qv, qc, qr, rho, z, exner, dt, c: Constants):
    """Advance the Kessler scheme by dt in column layout: every field is
    (nz, ...cols...) with z leading (surface at 0); rho is dry density, z
    the midpoint height broadcastable to the fields, exner = (p/p0)^(R/cp).
    Returns (theta, qv, qc, qr, precl), precl in m/s
    (Microphysics::kessler, Microphysics.h:346-449)."""
    if dt <= 0.0:
        raise ValueError(f"kessler called with nonpositive dt={dt}")
    psl = c.p0 / 100.0
    rhoqr = 1000.0
    lv = 2.5e6
    Rd, cp = c.R_d, c.cp_d

    r = 0.001 * rho
    rhalf = torch.sqrt(rho[:1] / rho)
    pc = 3.8 / (exner ** (cp / Rd) * psl)
    velqr = _terminal_velocity(qr, r, rhalf)

    # global CFL-limited sub-step over the whole batch (:372-390), in the
    # state's dtype as pam_tpu computes it (in float32 a dt / dt_max next
    # to an integer rounds there, not in double)
    dz_up = z[1:] - z[:-1]
    dt_t = torch.full((), dt, dtype=theta.dtype, device=theta.device)
    dt2d = torch.where(velqr[:-1] > 1.0e-10, 0.8 * dz_up / velqr[:-1], dt_t)
    dt_max = torch.minimum(comm.pmin_h(dt2d), dt_t)
    rainsplit = torch.ceil(dt_t / dt_max).to(torch.int32)
    graph.publish(kessler_column, "rainsplit", rainsplit)
    dt0 = _over_count(dt_t, rainsplit)

    def subcycle(carry):
        theta, qv, qc, qr, velqr, precl = carry
        # surface precipitation accumulation (:399-401)
        precl = precl + rho[0] * qr[0] * velqr[0] / rhoqr
        # upstream sedimentation (:403-408)
        rqv = r * qr * velqr
        sed_int = dt0 * (rqv[1:] - rqv[:-1]) / (r[:-1] * dz_up)
        sed_top = -dt0 * qr[-1:] * velqr[-1:] / (0.5 * (z[-1:] - z[-2:-1]))
        sed = torch.cat([sed_int, sed_top], dim=0)
        # autoconversion + accretion, KW eq. 2.13 (:413-417)
        qrprod = qc - (qc - dt0 * torch.clamp(0.001 * (qc - 0.001), min=0.0)) \
            / (1.0 + dt0 * 2.2 * torch.clamp(qr, min=0.0) ** 0.875)
        qc = torch.clamp(qc - qrprod, min=0.0)
        qr = torch.clamp(qr + qrprod + sed, min=0.0)
        # saturation adjustment, KW eq. 2.11/3.10 (:419-438)
        tmp = exner * theta - 36.0
        qvs = pc * torch.exp(17.27 * (exner * theta - 273.0) / tmp)
        prod = (qv - qvs) / (1.0 + qvs * (4093.0 * lv / cp) / (tmp * tmp))
        rq = torch.clamp(r * qr, min=0.0)
        tmp1 = dt0 * (((1.6 + 124.9 * rq ** 0.2046) * rq ** 0.525) /
                      (2550000.0 * pc / (3.8 * qvs) + 540000.0)) * \
            (torch.clamp(qvs - qv, min=0.0) / (r * qvs))
        ern = torch.minimum(tmp1, torch.minimum(
            torch.clamp(-prod - qc, min=0.0), qr))
        cond = torch.maximum(prod, -qc)
        theta = theta + lv / (cp * exner) * (cond - ern)
        qv = torch.clamp(qv - cond + ern, min=0.0)
        qc = qc + cond
        qr = qr - ern
        velqr = _terminal_velocity(qr, r, rhalf)
        return theta, qv, qc, qr, velqr, precl

    # the eager route's one host sync reads rainsplit here
    theta, qv, qc, qr, _, precl = graph.fori_loop(
        rainsplit, subcycle,
        (theta, qv, qc, qr, velqr, torch.zeros_like(theta[0])),
        name="kessler.rain")
    return theta, qv, qc, qr, _over_count(precl, rainsplit)


kessler_column.rainsplit = 0   # the trip count of the last call (a tensor)


@dataclasses.dataclass(frozen=True, eq=False)
class KesslerMicro:
    """Coupler-facing wrapper (Microphysics::timeStep,
    Microphysics.h:123-274).

    ens_chunk: if set, the ensemble is processed in chunks of this size,
    each with its OWN rainsplit count; the default None keeps the
    reference's one global minimum over the batch."""
    coupler: Coupler
    ens_chunk: int | None = None

    @property
    def name(self) -> str:
        return "kessler"

    def timestep(self, state, dt):
        c = self.coupler.const
        out = dict(state)
        nens, nz, ny, nx = state["temp"].shape

        # column layout (nz, ny*nx, nens), as pam_tpu (the reference's
        # get_lev_col view, DataManager.h:322)
        def col(f):
            return f.permute(1, 2, 3, 0).reshape(nz, ny * nx, nens)

        def uncol(f):
            return f.reshape(nz, ny, nx, nens).permute(3, 0, 1, 2)

        rho_d = col(state["density_dry"])
        temp = col(state["temp"])
        rho_v = col(state["water_vapor"])
        qv = rho_v / rho_d
        qc = col(state["cloud_liquid"]) / rho_d
        qr = col(state["precip_liquid"]) / rho_d
        pressure = c.R_d * rho_d * temp + c.R_v * rho_v * temp
        exner = (pressure / c.p0) ** (c.R_d / c.cp_d)
        theta = temp / exner
        zmid = state["vertical_midpoint_height"].permute(1, 0)[:, None, :]

        ck = self.ens_chunk
        if ck is None or ck >= nens:
            theta, qv, qc, qr, precl = kessler_column(
                theta, qv, qc, qr, rho_d, zmid, exner, dt, c)
        else:
            parts = []
            for s in range(0, nens, ck):
                sl = (slice(None), slice(None), slice(s, s + ck))
                parts.append(kessler_column(
                    theta[sl], qv[sl], qc[sl], qr[sl], rho_d[sl],
                    zmid[:, :, s:s + ck], exner[sl], dt, c))
            theta, qv, qc, qr, precl = (
                torch.cat([p[i] for p in parts], dim=-1) for i in range(5))
        out["water_vapor"] = uncol(qv * rho_d)
        out["cloud_liquid"] = uncol(qc * rho_d)
        out["precip_liquid"] = uncol(qr * rho_d)
        # theta is defined wrt the pre-micro exner (Microphysics.h:251-258)
        out["temp"] = uncol(theta * exner)
        out["precl"] = precl.reshape(ny, nx, nens).permute(2, 0, 1)
        return out

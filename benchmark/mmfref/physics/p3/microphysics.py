"""P3 microphysics coupler wrapper (port of
pam_tpu/physics/p3/microphysics.py; ref physics/micro/p3/Microphysics.h).

Registers the 9 P3 tracers (:119-127), converts coupler densities to dry
mixing ratios, builds the exner/theta/dpres_dry inputs (:344-385), runs
the column scheme, and maps the results back with the constant-volume
cv/cp temperature correction (:676-704). Without SHOC a saturation
adjustment stands in for macrophysics (:344-348).

The column scheme works top-down (k=0 = top), so columns are flipped on
the way in and out (``k_p3 = nz-1-k``, Microphysics.h:463). The column
layout at the scheme's boundary is ``pam_tpu``'s: (nz, ny*nx, nens).
State carried across calls (q_prev as a density, t_prev,
Microphysics.h:700-703) lives in the coupler state dict; ``init_state``
seeds it.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core.coupler import Coupler
from .constants import CONST
from .main import p3_main

C = CONST

TRACER_NAMES = ("cloud_water", "cloud_water_num", "rain", "rain_num", "ice",
                "ice_num", "ice_rime", "ice_rime_vol", "water_vapor")


def register(coupler: Coupler) -> Coupler:
    """Add P3's 9 tracers (ref: Microphysics::init, Microphysics.h:119-127).
    Number concentrations and rime fields carry no mass."""
    cpl = coupler
    cpl = cpl.add_tracer("cloud_water", "Cloud Water Mass", True, True)
    cpl = cpl.add_tracer("cloud_water_num", "Cloud Water Number", True, False)
    cpl = cpl.add_tracer("rain", "Rain Water Mass", True, True)
    cpl = cpl.add_tracer("rain_num", "Rain Water Number", True, False)
    cpl = cpl.add_tracer("ice", "Ice Mass", True, True)
    cpl = cpl.add_tracer("ice_num", "Ice Number", True, False)
    cpl = cpl.add_tracer("ice_rime", "Ice-Rime Mass", True, False)
    cpl = cpl.add_tracer("ice_rime_vol", "Ice-Rime Volume", True, False)
    cpl = cpl.add_tracer("water_vapor", "Water Vapor", True, True)
    return cpl.with_options(micro="p3")


def init_state(coupler: Coupler, state):
    """Seed persistent fields (ref: Microphysics.h:135-143 and the
    first_step branch :379-381). Call after water_vapor/temp are set."""
    cpl = coupler
    out = dict(state)
    shape = (cpl.nens, cpl.nz, cpl.ny, cpl.nx)
    kw = dict(dtype=cpl.dtype, device=cpl.device)
    out.setdefault("q_prev", state["water_vapor"])
    out.setdefault("t_prev", state["temp"])
    for name in ("nc_nuceat_tend", "nccn_prescribed", "ni_activated",
                 "liq_ice_exchange_out", "vap_liq_exchange_out",
                 "vap_ice_exchange_out"):
        out.setdefault(name, torch.zeros(shape, **kw))
    out.setdefault("inv_qc_relvar", torch.ones(shape, **kw))
    for name in ("precip_liq_surf_out", "precip_ice_surf_out"):
        out.setdefault(name, torch.zeros((cpl.nens, cpl.ny, cpl.nx), **kw))
    return out


def to_cols_batch(arrays, nz):
    """Many (nens, nz, ny, nx) fields -> (nz, ny*nx, nens) each, flipped
    to top-down, through one stacked copy; each result is contiguous."""
    st = torch.stack(arrays).flip(2)              # (F, nens, nz, ny, nx)
    c = st.permute(0, 2, 3, 4, 1).reshape(
        st.shape[0], nz, -1, st.shape[1]).contiguous()
    return list(c.unbind(0))


def from_cols_batch(arrays, shape):
    """Inverse of :func:`to_cols_batch` for many (nz, nyx, nens)."""
    nens, nz, ny, nx = shape
    st = torch.stack(arrays).flip(1)              # (F, nz, nyx, nens)
    r = st.reshape(st.shape[0], nz, ny, nx, nens).permute(
        0, 4, 1, 2, 3).contiguous()
    return list(r.unbind(0))


@dataclasses.dataclass(frozen=True, eq=False)
class P3Micro:
    """Coupler-facing wrapper (analog of Microphysics::timeStep,
    Microphysics.h:225-722)."""
    coupler: Coupler
    sgs_shoc: bool = False

    def timestep(self, state, dt):
        shape = tuple(state["temp"].shape)
        nens, nz, ny, nx = shape
        out = dict(state)

        rho_d = state["density_dry"]
        temp = state["temp"]
        rho_v = state["water_vapor"]
        rho_c = state["cloud_water"]

        if not self.sgs_shoc:
            raise NotImplementedError(
                "P3 without SHOC (a saturation adjustment in place of the "
                "macrophysics): no configuration of the benchmark runs it")

        # dry mixing ratios + thermodynamic inputs (Microphysics.h:349-374)
        dens = {"qc": rho_c, "qv": rho_v}
        for key, name in (("nc", "cloud_water_num"), ("qr", "rain"),
                          ("nr", "rain_num"), ("qi", "ice"),
                          ("ni", "ice_num"), ("qm", "ice_rime"),
                          ("bm", "ice_rime_vol")):
            dens[key] = state[name]

        pressure = C.rd * rho_d * temp + C.rv * rho_v * temp
        exner = (pressure / 1.0e5) ** (C.rd / C.cp)
        inv_exner = 1.0 / exner
        theta = temp * inv_exner
        zint = state["vertical_interface_height"]      # (nens, nz+1)
        dz = (zint[:, 1:] - zint[:, :-1])[:, :, None, None].expand(shape)
        pres_dry = C.rd * rho_d * temp
        dpres_dry = rho_d * C.g * dz

        # all inputs through one batched layout conversion (q_prev is
        # carried as a density -> mixing ratio, Microphysics.h:382-384)
        qkeys = list(dens.keys())
        fields = [dens[k] / rho_d for k in qkeys] + [
            theta, pres_dry, dz, state["nc_nuceat_tend"],
            state["ni_activated"], state["inv_qc_relvar"], dpres_dry,
            inv_exner, state["q_prev"] / rho_d, state["t_prev"],
            state["nccn_prescribed"]]
        cols = to_cols_batch(fields, nz)
        q = dict(zip(qkeys, cols[:len(qkeys)]))
        (th_c, pres_c, dz_c, nuceat_c, niact_c, relvar_c, dpres_c,
         invex_c, q_prev, t_prev, nccn_c) = cols[len(qkeys):]
        ones = torch.ones_like(q["qc"])

        st, diag = p3_main(
            qc=q["qc"], nc=q["nc"], qr=q["qr"], nr=q["nr"], qv=q["qv"],
            th=th_c, qi=q["qi"], qm=q["qm"], ni=q["ni"],
            bm=q["bm"], pres=pres_c, dz=dz_c,
            nc_nuceat_tend=nuceat_c, ni_activated=niact_c,
            inv_qc_relvar=relvar_c, dt=dt,
            dpres=dpres_c, inv_exner=invex_c,
            qv_prev=q_prev, t_prev=t_prev, cld_frac_i=ones, cld_frac_l=ones,
            cld_frac_r=ones, nccn_prescribed=nccn_c)

        # post-process (Microphysics.h:676-704); one batched conversion back
        out_keys = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv")
        backs = from_cols_batch(
            [st[k] for k in out_keys] + [st["th"], diag["liq_ice_exchange"],
                                         diag["vap_liq_exchange"],
                                         diag["vap_ice_exchange"]], shape)
        for i, name in enumerate(("cloud_water", "cloud_water_num", "rain",
                                  "rain_num", "ice", "ice_num", "ice_rime",
                                  "ice_rime_vol", "water_vapor")):
            out[name] = torch.clamp(backs[i] * rho_d, min=0.0)
        # constant-volume correction: scale dT by cv/cp (Microphysics.h:
        # 692-698); theta defined wrt the pre-micro exner
        temp_new = backs[len(out_keys)] * exner
        out["temp"] = temp + (temp_new - temp) * (C.cp - C.rd) / C.cp
        out["q_prev"] = out["water_vapor"]
        out["t_prev"] = out["temp"]
        out["liq_ice_exchange_out"] = backs[len(out_keys) + 1]
        out["vap_liq_exchange_out"] = backs[len(out_keys) + 2]
        out["vap_ice_exchange_out"] = backs[len(out_keys) + 3]

        def _sfc(a):
            # (nyx, nens) -> (nens, ny, nx)
            return a.reshape(ny, nx, nens).permute(2, 0, 1).contiguous()
        out["precip_liq_surf_out"] = _sfc(st["precip_liq_surf"])
        out["precip_ice_surf_out"] = _sfc(st["precip_ice_surf"])
        return out

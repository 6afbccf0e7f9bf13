"""SHOC coupler wrapper (port of pam_tpu/physics/sgs/shoc/sgs.py; ref
physics/sgs/shoc/SGS.h).

Registers the ``tke`` tracer and the persistent fields (:103-120),
converts coupler densities to SHOC's wet mixing ratios / thetal / thv /
dse inputs with the top-down flip (``k_shoc = nz-1-k``, :354), runs
shoc_main, and maps back with the constant-volume cv/cp temperature
correction (:700-733).

The micro scheme determines which tracers SHOC diffuses (:237-250):
kessler -> [precip_liquid]; p3 -> [cloud_water_num, rain, rain_num, ice,
ice_num, ice_rime, ice_rime_vol]. Cloud mass and vapor ride in qw/ql.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ....core.coupler import Coupler
from ...p3.microphysics import from_cols_batch, to_cols_batch
from .constants import CONST
from .main import shoc_main

C = CONST


def register(coupler: Coupler) -> Coupler:
    """Add the tke tracer (ref: SGS.h:103) and set the sgs option."""
    cpl = coupler.add_tracer("tke", "Turbulent Kinetic Energy (m^2/s^2)",
                             True, False)
    return cpl.with_options(sgs="shoc")


def init_state(coupler: Coupler, state):
    """Persistent SHOC fields (ref: SGS.h:108-120, zeroed at :125-136)."""
    cpl = coupler
    out = dict(state)
    kw = dict(dtype=cpl.dtype, device=cpl.device)
    shape = (cpl.nens, cpl.nz, cpl.ny, cpl.nx)
    for name in ("wthv_sec", "tk", "tkh", "cldfrac"):
        out.setdefault(name, torch.zeros(shape, **kw))
    out.setdefault("inv_qc_relvar", torch.ones(shape, **kw))
    for name in ("sfc_shf", "sfc_lhf", "sfc_mom_flx_u", "sfc_mom_flx_v",
                 "pblh"):
        out.setdefault(name, torch.zeros((cpl.nens, cpl.ny, cpl.nx), **kw))
    return out


def _npbl(pref_mid: np.ndarray) -> int:
    """Max number of PBL levels: count of reference pressures >= 400mb
    (shoc_init, shoc.F90:159-170)."""
    return max(int(np.sum(np.asarray(pref_mid) >= C.pblmaxp)), 1)


@dataclasses.dataclass(frozen=True, eq=False)
class ShocSgs:
    """Coupler-facing wrapper (analog of SGS::timeStep, SGS.h:195-760)."""
    coupler: Coupler
    npbl: int

    @classmethod
    def build(cls, coupler: Coupler, pref_mid=None):
        """pref_mid: reference mid-level pressures (nz,), TOP-DOWN, used
        only to bound the PBL search depth; defaults to all levels."""
        npbl = coupler.nz if pref_mid is None else _npbl(pref_mid)
        return cls(coupler=coupler, npbl=min(npbl, coupler.nz))

    def _micro_fields(self):
        micro = self.coupler.options.get("micro", "none")
        if micro == "kessler":
            return "cloud_liquid", ["precip_liquid"]
        if micro == "p3":
            return "cloud_water", ["cloud_water_num", "rain", "rain_num",
                                   "ice", "ice_num", "ice_rime",
                                   "ice_rime_vol"]
        raise ValueError(
            "SHOC requires the micro option to be set (SGS.h:194-200); "
            f"got {micro!r}")

    def timestep(self, state, dt):
        cpl = self.coupler
        shape = tuple(state["temp"].shape)
        nens, nz, ny, nx = shape
        kw = dict(dtype=state["temp"].dtype, device=state["temp"].device)
        out = dict(state)
        cloud_name, tracer_names = self._micro_fields()

        rho_d = state["density_dry"]
        rho_v = torch.clamp(state["water_vapor"], min=0.0)
        rho_c = torch.clamp(state[cloud_name], min=0.0)
        rho_total = rho_d + rho_v
        temp = state["temp"]

        zint = state["vertical_interface_height"]       # (nens, nz+1)
        zmid = state["vertical_midpoint_height"]        # (nens, nz)
        z0 = zint[:, :1]
        dz = (zint[:, 1:] - zint[:, :-1])
        dx = cpl.xlen / cpl.nx
        dy = dx if cpl.ny == 1 else cpl.ylen / cpl.ny

        pmid = cpl.pressure(state)                       # moist pressure
        qv = rho_v / rho_total
        ql = rho_c / rho_total
        exner = (pmid / 1.0e5) ** (C.rgas / C.cp)
        theta = temp / exner
        theta_v = theta * (1.0 + 0.61 * qv - ql)
        theta_l = theta - (1.0 / exner) * (C.lcond / C.cp) * ql

        def bc(a):
            return a[:, :, None, None].expand(shape)
        ones_col = torch.ones((ny * nx, nens), **kw)

        zi = to_cols_batch([(zint - z0)[:, :, None, None].expand(
            nens, nz + 1, ny, nx)], nz + 1)[0]

        # interface pressure (SGS.h:398-411)
        half = C.ggr * rho_total * dz[:, :, None, None] * 0.5
        p_up = pmid + half      # value extrapolated to lower interface
        p_dn = pmid - half      # value extrapolated to upper interface
        pint_full = torch.cat([p_up[:, :1],
                               0.5 * (p_dn[:, :-1] + p_up[:, 1:]),
                               p_dn[:, -1:]], dim=1)
        presi = to_cols_batch([pint_full], nz + 1)[0]

        def sfc(name):
            # (nens, ny, nx) -> (nyx, nens)
            return state[name].permute(1, 2, 0).reshape(-1, nens)
        phis = (z0[:, 0] * C.ggr)[None, :].expand(ny * nx, nens)

        tke_in = torch.clamp(state["tke"] / rho_total, min=0.004)
        tr4 = [torch.clamp(state[n] / rho_total, min=0.0)
               for n in tracer_names]

        # all mid-level inputs (incl. the diffused tracers) through one
        # batched layout conversion
        base = [theta_v, bc(zmid - z0), pmid,
                C.ggr * rho_total * dz[:, :, None, None], state["wvel"],
                1.0 / exner, C.cp * temp + C.ggr * bc(zmid - z0), tke_in,
                theta_l, qv + ql, state["uvel"], state["vvel"],
                state["wthv_sec"], state["tkh"], state["tk"], ql,
                state["cldfrac"]]
        cols_all = to_cols_batch(base + tr4, nz)
        (thv_c, zt, pmid_c, pdel, w_c, invex_c, dse_c, tke_c, thl_c, qw_c,
         u_c, v_c, wthv_c, tkh_c, tk_c, ql_c, cf_c) = cols_all[:len(base)]
        qtr_cols = torch.stack(cols_all[len(base):], dim=-1)

        st, diags = shoc_main(
            dtime=dt, nadv=1,
            host_dx=dx * ones_col, host_dy=dy * ones_col,
            thv=thv_c, zt_grid=zt, zi_grid=zi, pres=pmid_c,
            presi=presi, pdel=pdel,
            wthl_sfc=0.0 * ones_col, wqw_sfc=0.0 * ones_col,
            uw_sfc=sfc("sfc_mom_flx_u"), vw_sfc=sfc("sfc_mom_flx_v"),
            wtracer_sfc=torch.zeros_like(qtr_cols[0]),
            w_field=w_c, inv_exner=invex_c,
            phis=phis,
            host_dse=dse_c + phis,
            tke=tke_c, thetal=thl_c, qw=qw_c,
            u_wind=u_c, v_wind=v_c,
            qtracers=qtr_cols, wthv_sec=wthv_c,
            tkh=tkh_c, tk=tk_c,
            shoc_ql=ql_c, shoc_cldfrac=cf_c,
            npbl=self.npbl)

        # post-process (SGS.h:700-733); one batched conversion back
        okeys = ["qw", "shoc_ql", "thetal", "u_wind", "v_wind", "tke",
                 "wthv_sec", "tk", "tkh", "shoc_cldfrac"]
        ntr = len(tracer_names)
        backs = from_cols_batch(
            [st[k] for k in okeys] + list(st["qtracers"].unbind(-1)) +
            [diags["shoc_ql2"]], shape)
        (qw_new, ql_new, thl_new, u_new, v_new, tke_new, wthv_new, tk_new,
         tkh_new, cf_new) = backs[:len(okeys)]
        qv_new = qw_new - ql_new
        temp_new = thl_new * exner + (C.lcond / C.cp) * ql_new
        out["temp"] = temp + (temp_new - temp) * (C.cp - C.rgas) / C.cp
        rho_v_new = torch.clamp(qv_new * rho_d / (1.0 - qv_new), min=0.0)
        out["water_vapor"] = rho_v_new
        rho_total_new = rho_d + rho_v_new
        out[cloud_name] = torch.clamp(ql_new * rho_total_new, min=0.0)
        out["uvel"] = u_new
        out["vvel"] = v_new
        out["tke"] = tke_new * rho_total_new
        out["wthv_sec"] = wthv_new
        out["tk"] = tk_new
        out["tkh"] = tkh_new
        out["cldfrac"] = torch.clamp(cf_new, 0.0, 1.0)
        for i, n in enumerate(tracer_names):
            out[n] = torch.clamp(backs[len(okeys) + i] * rho_total_new,
                                 min=0.0)
        rcm = ql_new
        rcm2 = backs[len(okeys) + ntr]
        out["inv_qc_relvar"] = torch.where(
            (rcm != 0.0) & (rcm2 != 0.0),
            torch.clamp(rcm * rcm / torch.clamp(rcm2, min=1e-300),
                        0.001, 10.0), 1.0)
        out["pblh"] = diags["pblh"].reshape(ny, nx, nens).permute(
            2, 0, 1).contiguous()
        return out

"""Gravity-wave exact-solution verification (port of
pam_tpu/utils/gw_verification.py; ref standalone/mmf_simplified/pam-c/
gravitywave/convergence.py): the Skamarock-Klemp inertia-gravity wave at
a sequence of refinement levels with the SI integrator, its (rho, S, w,
T) fields against the analytic linear solution (GravityWave.sum_series
and the Exact* diagnostics, extrudedmodel.h:6707-6990), Linf / L2
errors, observed rates and the dissipation/dispersion split.

Run:  python -m pam_tpu_torch.utils.gw_verification [nlevels] [base_dt]

on the card; ``run_level(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..spam.testcases import GravityWave


def ediss_edisp(a, b):
    """Dissipation/dispersion error decomposition (convergence.py:24-33)."""
    a = np.ravel(np.asarray(a))
    b = np.ravel(np.asarray(b))
    cov = np.cov(np.vstack((a, b)))
    sa, sb = np.sqrt(cov[0, 0]), np.sqrt(cov[1, 1])
    ediss = (sa - sb) ** 2 + (a.mean() - b.mean()) ** 2
    edisp = 2 * sa * sb - 2 * cov[0, 1]
    return ediss, edisp


def _metrics(got, exact):
    err = np.asarray(got) - np.asarray(exact)
    linf = float(np.max(np.abs(err)))
    l2 = float(np.sqrt(np.mean(err ** 2)))
    ediss, edisp = ediss_edisp(got, exact)
    return linf, l2, float(ediss), float(edisp)


def _host(a):
    return a.detach().cpu().numpy().astype(np.float64) \
        if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)


def gravity_wave_errors(tc, geom, thermo, varset, dens, w, t):
    """Error metrics of a simulated GravityWave state (tensors) against
    the exact linear solution at time t, as compute_errors
    (convergence.py:35-81) takes them: rho and S de-scaled to
    concentrations against the projection of the exact fields ("dense"),
    the cell-centre T against Texact, point w at interior interfaces
    against wexact. Returns {var: (Linf, L2, Ediss, Edisp)}."""
    from ..spam.diagnostics import gravity_wave_exact

    vol = geom.dx * geom.dz_d                     # (nens, nz), dy = 1
    dz_p = geom.dz_p[:, :, None]
    ex = gravity_wave_exact(tc, geom, thermo, t)
    T = _host(thermo.compute_T_from_alpha(varset.get_alpha(dens),
                                          varset.get_entropic_var(dens),
                                          1.0, 0, 0, 0))
    dens, w = _host(dens), _host(w)
    rho = dens[0] / vol[:, :, None]
    S = dens[1] / vol[:, :, None]
    rho_e = ex["dense"][0] / vol[:, :, None]
    S_e = ex["dense"][1] / vol[:, :, None]
    return {"rho": _metrics(rho, rho_e), "S": _metrics(S, S_e),
            "T": _metrics(T, ex["Te"]),
            "w": _metrics(w / dz_p, ex["we"] / dz_p)}


def run_level(nx, nz, dt, timeend, dtype=torch.float64, si_max_iters=3,
              si_nquad=2, device="cuda"):
    """One refinement level of the gravity wave with the SI integrator
    (the reference convergence setup: tstype=si, uniform levels, one
    member) on ``device``, set up as run_idealized sets it up; returns
    (errors dict, tc, geom)."""
    from ..driver.standalone import idealized_setup
    cfg = dict(init_data="gravitywave", crm_nx=nx, crm_nz=nz, nens=1,
               tstype="si", dtcrm=dt, sim_time=timeend,
               si_max_iters=si_max_iters, si_nquad=si_nquad,
               f64=dtype == torch.float64)
    tend, step, (dens, v, w), _, _, _ = idealized_setup(cfg, device)
    nsteps = int(round(timeend / dt))
    for _ in range(nsteps):
        dens, v, w = step(dens, v, w)
    tc = GravityWave()
    errs = gravity_wave_errors(tc, tend.geom, tend.thermo, tend.varset, dens,
                               w, nsteps * dt)
    return errs, tc, tend.geom


def convergence_study(nlevels: int = 2, base_dt: float = 20.0,
                      base_nz: int = 20, timeend: float = 1800.0,
                      nx_per_nz: int = 15, verbose: bool = True,
                      device="cuda"):
    """The convergence.py loop: refine (nx, nz, dt) together and report
    observed rates. Returns the per-level error dicts."""
    results, dxs = [], []
    for lev in range(nlevels):
        nz = base_nz * 2 ** lev
        nx = nx_per_nz * nz
        dt = base_dt / 2 ** lev
        if verbose:
            print(f"level {lev}: nx={nx} nz={nz} dt={dt} "
                  f"steps={int(round(timeend / dt))}", flush=True)
        errs, tc, _ = run_level(nx, nz, dt, timeend, device=device)
        results.append(errs)
        dxs.append(tc.Lx / nx)
    if verbose:
        print(f"{'var':4} {'lev':3} {'dx':>9} {'Linf':>10} {'rate':>6} "
              f"{'L2':>10} {'rate':>6} {'Ediss':>10} {'Edisp':>10}")
        for var in ("T", "w", "rho", "S"):
            for lev, errs in enumerate(results):
                linf, l2, ediss, edisp = errs[var]
                r_inf = r_l2 = 0.0
                if lev > 0:
                    r_inf = np.log2(results[lev - 1][var][0] / linf)
                    r_l2 = np.log2(results[lev - 1][var][1] / l2)
                print(f"{var:4} {lev:3} {dxs[lev]:9.1f} {linf:10.2e} "
                      f"{r_inf:6.2f} {l2:10.2e} {r_l2:6.2f} "
                      f"{ediss:10.2e} {edisp:10.2e}")
    return results


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    nlevels = int(argv[0]) if argv else 2
    base_dt = float(argv[1]) if len(argv) > 1 else 20.0
    convergence_study(nlevels=nlevels, base_dt=base_dt)
    return 0


if __name__ == "__main__":
    sys.exit(main())

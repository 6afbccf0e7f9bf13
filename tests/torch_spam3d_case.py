"""The seeded 3-D case that tests/test_torch_spam3d.py and chip_smoke.py
hold the port's Tendencies3D with against the numpy oracle
tests/spam3d_oracle.py. Imports torch and pam_tpu_torch, nothing of JAX.
"""

import numpy as np
import torch

from pam_tpu_torch.ops import recon_matrices as rm
from pam_tpu_torch.spam import si, testcases as tcs
from pam_tpu_torch.spam.extruded3d import Tendencies3D
from pam_tpu_torch.spam.geometry import ExtrudedGeometry
from pam_tpu_torch.spam.thermo import IdealGasPottemp
from pam_tpu_torch.spam.varset import VariableSet


def oracle_case_3d(device, nx=6, ny=4, nz=5, seed=17):
    """A y-varying 3-D state for Tendencies3D against the numpy oracle
    tests/spam3d_oracle.py (tests/test_spam3d_oracle.py's case): the
    rising bubble of a CE model with a positive tracer, the SI reference
    state on, densities modulated along y with noise, a tracer sharp
    enough that the 3-D FCT fires, and random v (both components) and w.
    Returns (tend on ``device`` in float64, numpy (dens, v, w, geop), the
    oracle's keyword arguments after (…, dt))."""
    tc = tcs.RisingBubble()
    geom = ExtrudedGeometry.build3d(nx, ny, np.linspace(0.0, tc.Lz, nz + 1),
                                    tc.Lx, tc.Lx, 1, torch.float64, device)
    thermo = IdealGasPottemp()
    vs = VariableSet(variant="CE", tracer_names=("puff",),
                     tracer_positive=(True,), geom=geom, thermo=thermo)
    ref = si.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: tc.refnsq_f(z, thermo), tc.g)
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    tend = Tendencies3D(
        geom=geom, varset=vs, thermo=thermo, grav=tc.g,
        force_refstate_hydrostatic_balance=True, refdens=T(ref["dens"]),
        ref_rho_pi=T(ref["rho_pi"]), ref_q_pi=T(ref["q_pi"]),
        ref_rho_di=T(ref["rho_di"]), ref_q_di=T(ref["q_di"]),
        ref_B=T(ref["B"]))
    dens2, _, _, geop = (a.cpu().numpy() for a in
                         tcs.setup_testcase_3d(tc, geom, thermo))
    rng = np.random.default_rng(seed)
    shape = (1, nz, ny, nx)
    ymod = (1.0 + 0.02 * np.sin(2 * np.pi * np.arange(ny) / ny)
            )[None, None, :, None]
    dens = np.zeros((3,) + shape)
    for k in (0, 1):
        dens[k] = dens2[k] * ymod * (1.0 + 3e-3 * rng.standard_normal(shape))
    puff = np.zeros(shape)
    puff[:, nz // 2, 1, 0] = 1e-3
    puff[:, nz // 2, :, nx // 2] = 2e-3
    puff[:, nz // 3] = 1e-4 * rng.random((1, ny, nx))
    dens[2] = puff * dens[0]
    v = np.stack([3.0 * rng.standard_normal(shape),
                  2.0 * rng.standard_normal(shape)])
    w = 1.5 * rng.standard_normal((1, nz - 1, ny, nx))
    idl, sigma = rm.weno_ideal_weights(tend.ord)
    oracle = dict(
        dz_d=geom.dz_d, dz_p=geom.dz_p, dx=float(geom.dx), dy=float(geom.dy),
        cst=thermo.cst,
        mats=dict(s2c=rm.sten_to_coefs(tend.ord),
                  wrl=rm.weno_lower_sten_to_coefs(tend.ord),
                  c2g=rm.coefs_to_gll_lower(tend.ord), idl=idl, sigma=sigma),
        ref=dict(refdens=ref["dens"], rho_pi=ref["rho_pi"],
                 q_pi=ref["q_pi"], rho_di=ref["rho_di"], q_di=ref["q_di"],
                 B_ref=ref["B"]),
        dens_pos=list(vs.dens_pos))
    return tend, (dens, v, w, geop), oracle

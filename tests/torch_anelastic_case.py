"""The seeded anelastic case that tests/test_torch_anelastic.py and
chip_smoke.py hold the port's AnelasticTendencies and ManTendencies with,
against pam_tpu and against the numpy oracle tests/spam_oracle.py (the
AN case of tests/test_anelastic_oracle.py). Imports torch and
pam_tpu_torch, nothing of JAX.
"""

import numpy as np
import torch

from pam_tpu_torch.ops import recon_matrices as rm
from pam_tpu_torch.spam import si, testcases as tcs
from pam_tpu_torch.spam.anelastic import (AnelasticPressureSolver,
                                          AnelasticTendencies, ManTendencies)
from pam_tpu_torch.spam.geometry import ExtrudedGeometry
from pam_tpu_torch.spam.thermo import (ConstantKappaVirtualPottemp,
                                       IdealGasPottemp)
from pam_tpu_torch.spam.varset import VariableSet

# the dry (AN) case is the rising bubble, the moist (MAN) one its moist
# variant with a water vapour tracer
CASES = {"an": (tcs.RisingBubble, IdealGasPottemp, AnelasticTendencies,
                ()),
         "man": (tcs.MoistRisingBubble, ConstantKappaVirtualPottemp,
                 ManTendencies, ("water_vapor",))}


def an_case(device, hamil="an", nx=10, nz=8, nens=2, seed=3):
    """An anelastic state of the ``hamil`` model: rho pinned to the
    reference profile, the entropic density (and the vapour density)
    perturbed by seeded noise, random v and w. Returns (tend on
    ``device`` in float64, numpy (dens, v, w, geop), the oracle's keyword
    arguments after (…, dt) for the AN model, the reference state)."""
    tc_cls, thermo_cls, tend_cls, tracers = CASES[hamil]
    tc, thermo = tc_cls(), thermo_cls()
    geom = ExtrudedGeometry.build(nx, np.linspace(0.0, tc.Lz, nz + 1), tc.Lx,
                                  nens, torch.float64, device)
    vs = VariableSet(variant="MCE_rho" if tracers else "CE",
                     tracer_names=tracers,
                     tracer_positive=(True,) * len(tracers), geom=geom,
                     thermo=thermo)
    ref = si.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: tc.refnsq_f(z, thermo), tc.g)
    psolver = AnelasticPressureSolver.build(geom, ref["rho_pi"],
                                            ref["rho_di"])
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    tend = tend_cls(
        geom=geom, varset=vs, thermo=thermo, grav=tc.g,
        force_refstate_hydrostatic_balance=True, refdens=T(ref["dens"]),
        ref_rho_pi=T(ref["rho_pi"]), ref_q_pi=T(ref["q_pi"]),
        ref_rho_di=T(ref["rho_di"]), ref_q_di=T(ref["q_di"]),
        ref_B=T(ref["B"]), psolver=psolver)
    rng = np.random.default_rng(seed)
    rows = [np.broadcast_to(ref["dens"][0][:, :, None],
                            (nens, nz, nx)).copy()]
    S0 = tcs.project_n1form(lambda x, z: tc.refrho_f(z, thermo) *
                            tc.entropicvar_f(x, z, thermo), geom)
    rows.append(S0 * (1.0 + 2e-3 * rng.standard_normal(S0.shape)))
    if tracers:
        rv = tcs.project_n1form(lambda x, z: tc.rhov_f(x, z, thermo), geom)
        rows.append(rv * (1.0 + 1e-2 * rng.random(rv.shape)))
    dens = np.stack(rows)
    geop = tcs.project_n1form(lambda x, z: tc.g * z, geom)
    v = 3.0 * rng.standard_normal((nens, nz, nx))
    w = 2.0 * rng.standard_normal((nens, nz - 1, nx))
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
    return tend, (dens, v, w, geop), oracle, ref

"""Built-in SPAM diagnostics of the x-z slab and the 3-D model (port of
pam_tpu/spam/diagnostics.py; ref dynamics/spam/src/models/
extrudedmodel.h:21-189 TotalDensityDiagnostic, Dens0Diagnostic,
QHZDiagnostic, QXYDiagnostic, and the ExactDensity / ExactTemperature /
ExactW / BackgroundDensity diagnostics of the gravity wave, :6876-6990).
Each is a function of the prognostic state returning a named tensor;
``compute_diagnostics`` evaluates a selection for output. The 3-D model
(Tendencies3D) carries its own Hodge star and its PV as (qhz, qxy);
QXYl exists only there and raises for the slab, as in pam_tpu.
"""

from __future__ import annotations

import numpy as np

from . import operators as op
from .extruded3d import Tendencies3D
from .operators import mirror_layer
from .testcases import project_n1form


def total_density(tend, dens, v=None, w=None):
    """Total (moist) density as a twisted n-form (extrudedmodel.h:21-54)."""
    return tend.varset.get_total_density(dens)


def dens0(tend, dens, v=None, w=None):
    """Concentration 0-forms dens / cell area ("densl",
    extrudedmodel.h:56-91)."""
    if isinstance(tend, Tendencies3D):
        return tend.Hn1bar(dens)
    return op.Hn1bar(dens, tend.geom)


def qhz(tend, dens, v, w):
    """Relative PV at dual vertices ("QHZl", extrudedmodel.h:93-131), the
    dycore's PVPE functional (q_and_f); in 3-D the 2-dof (qxz, qyz)
    stack."""
    if isinstance(tend, Tendencies3D):
        return tend.q_and_f(dens, v, w)[0]
    return tend.q_and_f(dens, v, w)


def qxy(tend, dens, v, w):
    """Vertical-vorticity PV at the dual layers ("QXYl",
    extrudedmodel.h:133-189), ndims=2 only."""
    if not isinstance(tend, Tendencies3D):
        raise ValueError("QXYl requires the 3-D (ndims=2) model")
    return tend.q_and_f(dens, v, w)[1]


def relative_vorticity(tend, dens, v, w):
    """Raw circulation zeta = D1(v, w) (interior vertices)."""
    return op.D1_ext(v, mirror_layer(w, 1))


def gravity_wave_exact(tc, geom, thermo, t):
    """Exact-solution and background fields of the GravityWave run at time
    t ("dense", "Te", "we", "densb"; extrudedmodel.h:6876-6990), numpy
    float64: dense/densb (2, nens, nz, nx) twisted n-forms, Te cell-centre
    temperatures, we the w 1-form at interior interfaces."""
    dense = np.stack([
        project_n1form(lambda x, z: tc.rhoexact_f(x, z, t, thermo), geom),
        project_n1form(lambda x, z: tc.entropicdensityexact_f(x, z, t,
                                                              thermo), geom)])
    densb = np.stack([
        project_n1form(lambda x, z: tc.refrho_f(z, thermo) + 0.0 * x, geom),
        project_n1form(lambda x, z: tc.refentropicdensity_f(z, thermo) +
                       0.0 * x, geom)])
    xc = (np.arange(geom.nx) + 0.5) * geom.dx
    zc = 0.5 * (geom.zint_d[:, :-1] + geom.zint_d[:, 1:])
    X, Z = xc[None, None, :], zc[:, :, None]
    Te = tc.Texact_f(X + 0 * Z, Z + 0 * X, t, thermo)
    Zw = geom.zint_d[:, 1:-1][:, :, None]
    we = tc.wexact_f(X + 0 * Zw, Zw + 0 * X, t, thermo) * \
        geom.dz_p[:, :, None]
    return {"dense": dense, "Te": Te, "we": we, "densb": densb}


DIAGNOSTICS = {
    "total_dens": total_density,
    "densl": dens0,
    "QHZl": qhz,
    "QXYl": qxy,
    "zeta": relative_vorticity,
}


def compute_diagnostics(tend, dens, v, w, names=None):
    """The named diagnostics; by default every one the model has: all but
    QXYl in the slab, all but the slab-layout circulation "zeta" in 3-D."""
    if names is None:
        skip = "zeta" if isinstance(tend, Tendencies3D) else "QXYl"
        names = [n for n in DIAGNOSTICS if n != skip]
    return {n: DIAGNOSTICS[n](tend, dens, v, w) for n in names}

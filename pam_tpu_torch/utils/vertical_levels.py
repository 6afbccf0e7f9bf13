"""Vertical grid generators: equal / exponential / tanh spacing.

Numpy-only copy of pam_tpu/utils/vertical_levels.py (ref:
utils/generate_vertical_levels.py, equal, exp and tanh functions with the
same parameter meanings). Returns interface heights; `save_netcdf` writes
the `vcoords.nc` format that driver/standalone.py::build_zint reads
(variable "vertical_interfaces"), through scipy.io.netcdf_file.

Usage: python -m pam_tpu_torch.utils.vertical_levels --function tanh
       --nlev 64 --output vcoords.nc
"""

from __future__ import annotations

import numpy as np


def equal_levels(nlev: int, z0: float = 0.0, ztop: float = 10000.0):
    return np.linspace(z0, ztop, nlev + 1)


def _levels_from_template(template, nlev: int, z0: float, ztop: float,
                          niter: int = 200, tol: float = 1e-15):
    """Self-consistent dz from a dz-vs-height template: fixed-point
    iteration dz[i]/dz[i-1] = template(zmid[i])/template(zmid[i-1]) with
    zmid the CONVERGED physical midpoints, normalized to span the domain
    each sweep (ref: generate_vertical_levels.py:105-131 — evaluating the
    template at uniform index fractions instead gives a substantially
    different grid: ~1900 m interface error for the default tanh)."""
    zthick = ztop - z0
    dz = np.full(nlev, zthick / nlev)
    for _ in range(niter):
        dz_old = dz.copy()
        zmid = np.cumsum(dz) - dz / 2           # heights above z0
        t = template(zmid)
        dz = dz[0] * np.concatenate([[1.0], np.cumprod(t[1:] / t[:-1])])
        dz *= zthick / dz.sum()
        if np.abs(dz - dz_old).sum() / dz.sum() < tol:
            break
    return np.concatenate([[z0], z0 + np.cumsum(dz)])


def exp_levels(nlev: int, z0: float = 0.0, ztop: float = 10000.0,
               base: float = 10.0):
    """dz grows exponentially IN PHYSICAL HEIGHT; top/bottom dz ratio ->
    base (generate_vertical_levels.py --function=exp: template
    base**(z/zthick) iterated to self-consistency)."""
    zthick = ztop - z0
    return _levels_from_template(lambda z: base ** (z / zthick), nlev,
                                 z0, ztop)


def tanh_levels(nlev: int, z0: float = 0.0, ztop: float = 10000.0,
                inflect: float = 2000.0, steep: float = 8.0,
                scale: float = 10.0):
    """Concentrates layers near the surface, ~constant above the tanh
    inflection at PHYSICAL height ``inflect``
    (generate_vertical_levels.py --function=tanh, incl. the z0 offset of
    the inflection, :102 tanh_inflect_p = (tanh_inflect - z0)/zthick):
    dz(z) propto ((tanh((z - (inflect-z0))/zthick * steep) + 1)/2
    * (scale-1)) + 1, iterated to self-consistency in z."""
    zthick = ztop - z0
    ip = (inflect - z0) / zthick

    def template(z):
        return (np.tanh((z / zthick - ip) * steep) + 1.0) / 2.0 * \
            (scale - 1.0) + 1.0

    return _levels_from_template(template, nlev, z0, ztop)


def generate(function: str = "tanh", nlev: int = 64, z0: float = 0.0,
             ztop: float = 10000.0, **kw):
    if function == "equal":
        return equal_levels(nlev, z0, ztop)
    if function == "exp":
        return exp_levels(nlev, z0, ztop, base=kw.get("exp_base", 10.0))
    if function == "tanh":
        return tanh_levels(nlev, z0, ztop,
                           inflect=kw.get("tanh_inflect", 2000.0),
                           steep=kw.get("tanh_steep", 8.0),
                           scale=kw.get("tanh_scale", 10.0))
    raise ValueError(f"unknown vertical-grid function {function!r}")


def save_netcdf(path: str, zint: np.ndarray):
    """Write a vcoords file that driver/standalone.py::build_zint reads."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as f:
        f.createDimension("num_interfaces", len(zint))
        v = f.createVariable("vertical_interfaces", "d", ("num_interfaces",))
        v[:] = np.asarray(zint, np.float64)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--function", default="tanh",
                   choices=("equal", "exp", "tanh"))
    p.add_argument("--nlev", type=int, default=64)
    p.add_argument("--z0", type=float, default=0.0)
    p.add_argument("--ztop", type=float, default=10000.0)
    p.add_argument("--exp-base", type=float, default=10.0)
    p.add_argument("--tanh-inflect", type=float, default=2000.0)
    p.add_argument("--tanh-steep", type=float, default=8.0)
    p.add_argument("--tanh-scale", type=float, default=10.0)
    p.add_argument("--output", default="vcoords.nc")
    a = p.parse_args(argv)
    zint = generate(a.function, a.nlev, a.z0, a.ztop,
                    exp_base=a.exp_base, tanh_inflect=a.tanh_inflect,
                    tanh_steep=a.tanh_steep, tanh_scale=a.tanh_scale)
    save_netcdf(a.output, zint)
    print(f"wrote {a.output}: {len(zint)} interfaces, "
          f"dz [{np.diff(zint).min():.1f}, {np.diff(zint).max():.1f}] m")


if __name__ == "__main__":
    main()

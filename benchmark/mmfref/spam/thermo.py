"""The thermodynamic potential of the SPAM dycore that the benchmark's
configurations run, ConstantKappa_VirtualPottemp (port of
pam_tpu/spam/thermo.py; ref dynamics/spam/src/hamiltonians/thermo.h,
formulas transcribed exactly).

The methods are plain arithmetic, so they take numpy arrays (setup) and
torch tensors (the step) alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ThermoConstants:
    """(ref: thermo.h:42-60)."""
    Rd: float = 287.0
    Rv: float = 461.0
    Cpd: float = 1004.0
    Cpv: float = 1885.0
    Cvd: float = 717.0
    Cvv: float = 1424.0
    Cl: float = 4186.0
    Ci: float = 2050.0
    pr: float = 1000.0 * 100.0
    Tr: float = 273.15
    Lv0: float = 3.1285e6
    Lfr: float = 333.55e6

    @property
    def Lvr(self):
        return self.Lv0 + (self.Cpv - self.Cl) * self.Tr

    @property
    def gamma_d(self):
        return self.Cpd / self.Cvd

    @property
    def kappa_d(self):
        return self.Rd / self.Cpd

    @property
    def delta_d(self):
        return self.Rd / self.Cvd


@dataclasses.dataclass(frozen=True)
class ConstantKappaVirtualPottemp:
    """Moist air, constant-kappa approximation, virtual potential
    temperature as entropic variable (thermo.h:342-470)."""
    cst: ThermoConstants = ThermoConstants()
    moist_species_decouple_from_dynamics = True

    def compute_U(self, alpha, entropic_var, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        c = self.cst
        Rstar = qd * c.Rd + qv * c.Rv
        return (c.Cvd * entropic_var ** c.gamma_d *
                (c.Rd / (alpha * c.pr)) ** c.delta_d
                - c.Cvd * Rstar / c.Rd * c.Tr - qv * c.Rv * c.Tr
                + qv * (c.Lvr + c.Lfr) + ql * c.Lfr)

    def compute_dUdalpha(self, alpha, entropic_var, qd=0.0, qv=0.0, ql=0.0,
                         qi=0.0):
        c = self.cst
        return -c.pr * (entropic_var * c.Rd / (alpha * c.pr)) ** c.gamma_d

    def compute_dUdentropic_var(self, alpha, entropic_var, qd=0.0, qv=0.0,
                                ql=0.0, qi=0.0):
        c = self.cst
        return c.Cpd * (entropic_var * c.Rd / (alpha * c.pr)) ** c.delta_d

    def compute_dUdq(self, alpha, entropic_var, qd=0.0, qv=0.0, ql=0.0,
                     qi=0.0):
        c = self.cst
        dUdqd = -c.Cvd * c.Tr
        dUdqv = -c.Cvd * c.Rv / c.Rd * c.Tr + c.Lvr + c.Lfr - c.Rv * c.Tr
        dUdql = c.Lfr
        dUdqi = 0.0
        return dUdqd, dUdqv, dUdql, dUdqi

    def compute_entropic_var_from_alpha_T(self, alpha, T, qd=0.0, qv=0.0,
                                          ql=0.0, qi=0.0):
        c = self.cst
        Rstar = c.Rd * qd + c.Rv * qv
        p = Rstar * T / alpha
        return Rstar * T / c.Rd * (c.pr / p) ** c.kappa_d

    def solve_p(self, rho, entropic_var, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        c = self.cst
        return c.pr * (entropic_var * rho * c.Rd / c.pr) ** c.gamma_d

    def compute_T_from_alpha(self, alpha, entropic_var, qd=0.0, qv=0.0,
                             ql=0.0, qi=0.0):
        c = self.cst
        Rstar = c.Rd * qd + c.Rv * qv
        p = c.pr * (entropic_var * c.Rd / (alpha * c.pr)) ** c.gamma_d
        return alpha * p / Rstar

    def compute_dpdentropic_var(self, alpha, entropic_var, qd=0.0, qv=0.0,
                                ql=0.0, qi=0.0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return self.cst.gamma_d * p / entropic_var

    def compute_soundspeed(self, alpha, entropic_var, qd=0.0, qv=0.0, ql=0.0,
                           qi=0.0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return (self.cst.gamma_d * p * alpha) ** 0.5

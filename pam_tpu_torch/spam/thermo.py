"""Pluggable thermodynamic potentials of the SPAM dycore (port of
pam_tpu/spam/thermo.py; ref dynamics/spam/src/hamiltonians/thermo.h,
formulas transcribed exactly): IdealGas_Pottemp, IdealGas_Entropy,
ConstantKappa_VirtualPottemp, the no-thermodynamics marker of the layer
models and the reference's three declared-but-empty potentials.

The methods are plain arithmetic, so they take numpy arrays (setup) and
torch tensors (the step) alike; the exp and log of IdealGas_Entropy pick
numpy's or torch's by the argument.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


@dataclasses.dataclass(frozen=True)
class IdealGasPottemp:
    """Dry ideal gas, potential temperature as entropic variable
    (thermo.h:70-200 IdealGas_Pottemp)."""
    cst: ThermoConstants = ThermoConstants()
    moist_species_decouple_from_dynamics = True

    def compute_U(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return c.Cvd * entropic_var ** c.gamma_d * \
            (c.Rd / (alpha * c.pr)) ** c.delta_d

    def compute_dUdalpha(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return -c.pr * (entropic_var * c.Rd / (alpha * c.pr)) ** c.gamma_d

    def compute_dUdentropic_var(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        c = self.cst
        return c.Cpd * (entropic_var * c.Rd / (alpha * c.pr)) ** c.delta_d

    def compute_dUdq(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        """All chemical potentials vanish for this potential."""
        return 0.0, 0.0, 0.0, 0.0

    def compute_alpha(self, p, T, qd=0, qv=0, ql=0, qi=0):
        return self.cst.Rd * T / p

    def compute_entropic_var_from_p_T(self, p, T, qd=0, qv=0, ql=0, qi=0):
        return T * (self.cst.pr / p) ** self.cst.kappa_d

    def compute_entropic_var_from_alpha_T(self, alpha, T, qd=0, qv=0, ql=0,
                                          qi=0):
        p = self.cst.Rd * T / alpha
        return T * (self.cst.pr / p) ** self.cst.kappa_d

    def solve_p(self, rho, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return c.pr * (entropic_var * rho * c.Rd / c.pr) ** c.gamma_d

    def compute_T_from_alpha(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                             qi=0):
        c = self.cst
        p = c.pr * (entropic_var * c.Rd / (alpha * c.pr)) ** c.gamma_d
        return alpha * p / c.Rd

    def compute_T_from_p(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        return (p / self.cst.pr) ** self.cst.kappa_d * entropic_var

    def compute_dpdentropic_var(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return self.cst.gamma_d * p / entropic_var

    def compute_soundspeed(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return (self.cst.gamma_d * p * alpha) ** 0.5

    def compute_H(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        """Specific enthalpy at pressure p (thermo.h:112-115)."""
        c = self.cst
        return c.Cpd * entropic_var * (p / c.pr) ** c.kappa_d

    def compute_dHdentropic_var(self, p, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        """(thermo.h:122-125)."""
        c = self.cst
        return c.Cpd * (p / c.pr) ** c.kappa_d

    def compute_dHdq(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        """Chemical potentials (mu_d, mu_v, mu_l, mu_i); zero for the dry
        ideal gas (thermo.h:127-145)."""
        return 0.0, 0.0, 0.0, 0.0


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

    def compute_alpha(self, p, T, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        c = self.cst
        return (qd * c.Rd + qv * c.Rv) * T / p

    def compute_entropic_var_from_alpha_T(self, alpha, T, qd=0.0, qv=0.0,
                                          ql=0.0, qi=0.0):
        c = self.cst
        Rstar = c.Rd * qd + c.Rv * qv
        p = Rstar * T / alpha
        return Rstar * T / c.Rd * (c.pr / p) ** c.kappa_d

    def compute_entropic_var_from_p_T(self, p, T, qd=0.0, qv=0.0, ql=0.0,
                                      qi=0.0):
        c = self.cst
        return (qd * c.Rd + qv * c.Rv) * T / c.Rd * (c.pr / p) ** c.kappa_d

    def solve_p(self, rho, entropic_var, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        c = self.cst
        return c.pr * (entropic_var * rho * c.Rd / c.pr) ** c.gamma_d

    def compute_T_from_alpha(self, alpha, entropic_var, qd=0.0, qv=0.0,
                             ql=0.0, qi=0.0):
        c = self.cst
        Rstar = c.Rd * qd + c.Rv * qv
        p = c.pr * (entropic_var * c.Rd / (alpha * c.pr)) ** c.gamma_d
        return alpha * p / Rstar

    def compute_T_from_p(self, p, entropic_var, qd=0.0, qv=0.0, ql=0.0,
                         qi=0.0):
        c = self.cst
        Rstar = c.Rd * qd + c.Rv * qv
        return (p / c.pr) ** c.kappa_d * entropic_var * c.Rd / Rstar

    def compute_dpdentropic_var(self, alpha, entropic_var, qd=0.0, qv=0.0,
                                ql=0.0, qi=0.0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return self.cst.gamma_d * p / entropic_var

    def compute_soundspeed(self, alpha, entropic_var, qd=0.0, qv=0.0, ql=0.0,
                           qi=0.0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return (self.cst.gamma_d * p * alpha) ** 0.5

    def compute_H(self, p, entropic_var, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        """Moist specific enthalpy at pressure p (thermo.h:388-394)."""
        c = self.cst
        Rstar = qd * c.Rd + qv * c.Rv
        return (c.Cpd * entropic_var * (p / c.pr) ** c.kappa_d -
                c.Cpd * Rstar / c.Rd * c.Tr + qd * c.Rd * c.Tr +
                qv * (c.Lvr + c.Lfr) + ql * c.Lfr)

    def compute_dHdentropic_var(self, p, entropic_var, qd=0.0, qv=0.0,
                                ql=0.0, qi=0.0):
        """(thermo.h:401-404)."""
        c = self.cst
        return c.Cpd * (p / c.pr) ** c.kappa_d

    def compute_dHdq(self, p, entropic_var, qd=0.0, qv=0.0, ql=0.0, qi=0.0):
        """Chemical potentials (mu_d, mu_v, mu_l, mu_i)
        (thermo.h:406-424)."""
        c = self.cst
        mu_d = -c.Cpd * c.Tr + c.Rd * c.Tr
        mu_v = -c.Cpd * c.Rv / c.Rd * c.Tr + c.Lvr + c.Lfr
        mu_l = c.Lfr
        mu_i = 0.0
        return mu_d, mu_v, mu_l, mu_i


@dataclasses.dataclass(frozen=True)
class IdealGasEntropy:
    """Dry ideal gas, specific entropy as entropic variable
    (thermo.h:202-340 IdealGas_Entropy); ignores every q argument, as the
    reference does."""
    cst: ThermoConstants = ThermoConstants()
    moist_species_decouple_from_dynamics = True

    def compute_U(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return (c.Cvd * c.Tr * (alpha * c.pr / (c.Rd * c.Tr)) ** (-c.delta_d)
                * _exp(entropic_var / c.Cvd))

    def compute_dUdalpha(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        U = self.compute_U(alpha, entropic_var)
        return -c.Rd / c.Cvd * U / alpha

    def compute_dUdentropic_var(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        return self.compute_U(alpha, entropic_var) / self.cst.Cvd

    def compute_dUdq(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        return 0.0, 0.0, 0.0, 0.0

    def compute_alpha(self, p, T, qd=0, qv=0, ql=0, qi=0):
        return self.cst.Rd * T / p

    def compute_entropic_var_from_p_T(self, p, T, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return c.Cpd * _log(T / c.Tr) - c.Rd * _log(p / c.pr)

    def compute_entropic_var_from_alpha_T(self, alpha, T, qd=0, qv=0, ql=0,
                                          qi=0):
        p = self.cst.Rd * T / alpha
        return self.compute_entropic_var_from_p_T(p, T)

    def solve_p(self, rho, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        alpha = 1.0 / rho
        return c.Rd / c.Cvd * self.compute_U(alpha, entropic_var) / alpha

    def compute_T_from_alpha(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                             qi=0):
        return self.compute_U(alpha, entropic_var) / self.cst.Cvd

    def compute_T_from_p(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        return self.compute_dHdentropic_var(p, entropic_var)

    def compute_dpdentropic_var(self, alpha, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        c = self.cst
        dUds = self.compute_dUdentropic_var(alpha, entropic_var)
        return c.Rd / c.Cvd * dUds / alpha

    def compute_soundspeed(self, alpha, entropic_var, qd=0, qv=0, ql=0, qi=0):
        p = self.solve_p(1.0 / alpha, entropic_var)
        return (self.cst.gamma_d * p * alpha) ** 0.5

    def compute_H(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        c = self.cst
        return (c.Cpd * c.Tr * (p / c.pr) ** c.kappa_d *
                _exp(entropic_var / c.Cpd))

    def compute_dHdentropic_var(self, p, entropic_var, qd=0, qv=0, ql=0,
                                qi=0):
        return self.compute_H(p, entropic_var) / self.cst.Cpd

    def compute_dHdq(self, p, entropic_var, qd=0, qv=0, ql=0, qi=0):
        return 0.0, 0.0, 0.0, 0.0


@dataclasses.dataclass(frozen=True)
class ThermoNone:
    """No-thermodynamics marker of the layer models (SWE/TSWE,
    thermo.h:62-67): constants only."""
    cst: ThermoConstants = ThermoConstants()
    moist_species_decouple_from_dynamics = True


class _UnimplementedThermo:
    """A potential the reference declares with every method body commented
    out (thermo.h:482-660): it can be made, and any compute_* or solve_p
    raises, as compiling the reference with that macro would fail."""
    moist_species_decouple_from_dynamics = False

    def __init__(self, cst: ThermoConstants = None):
        self.cst = cst or ThermoConstants()

    def __getattr__(self, name):
        if name.startswith("compute_") or name == "solve_p":
            raise NotImplementedError(
                f"{type(self).__name__}.{name}: unimplemented in the "
                "reference (thermo.h commented-out stubs)")
        raise AttributeError(name)


class ConstantKappaEntropy(_UnimplementedThermo):
    """(ref: thermo.h:482-541, all methods commented out)."""


class UnapproxPottemp(_UnimplementedThermo):
    """(ref: thermo.h:543-601, all methods commented out)."""


class UnapproxEntropy(_UnimplementedThermo):
    """(ref: thermo.h:603-660, all methods commented out)."""


THERMO_REGISTRY = {
    "none": ThermoNone,
    "idealgaspottemp": IdealGasPottemp,
    "idealgasentropy": IdealGasEntropy,
    "constkappavirpottemp": ConstantKappaVirtualPottemp,
    "constkappaentropy": ConstantKappaEntropy,
    "unapproxpottemp": UnapproxPottemp,
    "unapproxentropy": UnapproxEntropy,
}


def thermo_from_string(name: str, cst: ThermoConstants = None):
    """The PAMC_THERMO compile-time choice (thermo.h:662-673) by name."""
    cls = THERMO_REGISTRY[name.lower()]
    return cls(cst=cst) if cst is not None else cls()

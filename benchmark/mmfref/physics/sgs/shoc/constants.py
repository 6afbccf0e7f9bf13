"""SHOC constants and tunable parameters (copy of
pam_tpu/physics/sgs/shoc/constants.py).

Parity reference: physics/sgs/shoc/fortran/shoc.F90 module header (:20-100)
and the PAM wrapper's host constants (physics/sgs/shoc/SGS.h:60-90).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShocConstants:
    # host constants passed via shoc_init (SGS.h:181-185)
    ggr: float = 9.80616
    rgas: float = 287.042
    rv: float = 461.505
    cp: float = 1004.64
    lcond: float = 2501000.0
    lice: float = 333700.0
    vk: float = 0.4

    # tunable parameters (shoc.F90:44-60)
    thl2tune: float = 1.0
    qw2tune: float = 1.0
    qwthl2tune: float = 1.0
    w2tune: float = 1.0
    length_fac: float = 0.5
    c_diag_3rd_mom: float = 7.0
    lambda_low: float = 0.001
    lambda_high: float = 0.04
    lambda_slope: float = 2.65
    lambda_thresh: float = 0.02
    Ckh: float = 0.1
    Ckm: float = 0.1
    Ckh_s_min: float = 0.1
    Ckm_s_min: float = 0.1
    Ckh_s_max: float = 0.1
    Ckm_s_max: float = 0.1

    # private parameters (shoc.F90:66-100)
    basetemp: float = 300.0
    basepres: float = 100000.0
    troppres: float = 80000.0
    ustar_min: float = 0.01
    pblmaxp: float = 4.0e4
    w3clip: float = 1.2
    maxlen: float = 20000.0
    minlen: float = 20.0
    maxtke: float = 50.0
    mintke: float = 0.0004
    tinyw: float = 1.0e-36
    fac: float = 100.0
    ricr: float = 0.3
    largeneg: float = -99999999.99

    @property
    def eps(self) -> float:
        """zvir = rh2o/rair - 1 (SGS.h:181)."""
        return self.rv / self.rgas - 1.0


CONST = ShocConstants()

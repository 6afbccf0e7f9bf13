"""P3 microphysics constants (copy of pam_tpu/physics/p3/constants.py;
numpy only).

Parity reference: physics/scream_common/micro_p3_utils.F90
(micro_p3_utils_init) with the host values passed by the PAM wrapper
(physics/micro/p3/Microphysics.h:75-88, 168-183).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

QSMALL = 1.0e-14
NSMALL = 1.0e-16
MU_R_CONSTANT = 1.0
LOOKUP_TABLE_1A_DUM1_C = 4.135985029041767  # 1/(0.1*log10(261.7))

# lookup table dimensions (micro_p3_utils.F90:44-50)
ISIZE = 50
DENSIZE = 5
RIMSIZE = 4
RCOLLSIZE = 30
ICE_TABLE_SIZE = 12
COLLECT_TABLE_SIZE = 2
IPARAM = 3  # Khairoutdinov and Kogan 2000 warm-rain scheme

MINCLD = 1.0e-4
INCLOUD_LIMIT = 5.1e-3
PRECIP_LIMIT = 1.0e-2


@dataclasses.dataclass(frozen=True)
class P3Constants:
    # host-model values (Microphysics.h:75-88,168-177)
    cp: float = 1004.64
    rd: float = 287.042
    rv: float = 461.505
    rho_h2o: float = 1000.0
    mwh2o: float = 18.016
    mwdry: float = 28.966
    g: float = 9.80616
    latvap: float = 2501000.0
    latice: float = 333700.0
    cpw: float = 4188.0       # cpliq
    T_zerodegc: float = 273.15

    # p3 parameters (micro_p3_utils_init)
    max_total_ni: float = 500.0e3
    nccnst: float = 200.0e6
    kc: float = 9.44e9
    kr: float = 5.78e3
    ar: float = 841.99667
    br: float = 0.8
    f1r: float = 0.78
    f2r: float = 0.32
    ecr: float = 1.0
    rho_rimeMin: float = 50.0
    rho_rimeMax: float = 900.0
    bimm: float = 2.0
    aimm: float = 0.65
    rin: float = 0.1e-6
    eci: float = 0.5
    eri: float = 1.0
    bcn: float = 2.0
    dbrk: float = 600.0e-6
    nmltratio: float = 1.0
    dropmass: float = 5.2e-7

    @property
    def inv_cp(self):
        return 1.0 / self.cp

    @property
    def ep_2(self):
        return self.mwh2o / self.mwdry

    @property
    def rho_1000mb(self):
        return 100000.0 / (self.rd * self.T_zerodegc)

    @property
    def rho_600mb(self):
        return 60000.0 / (self.rd * 253.15)

    @property
    def T_homogfrz(self):
        return self.T_zerodegc - 40.0

    @property
    def T_icenuc(self):
        return self.T_zerodegc - 15.0

    @property
    def T_rainfrz(self):
        return self.T_zerodegc - 4.0

    @property
    def latent_heat_vapor(self):
        return self.latvap

    @property
    def latent_heat_sublim(self):
        return self.latvap + self.latice

    @property
    def latent_heat_fusion(self):
        return self.latice

    @property
    def inv_rho_h2o(self):
        return 1.0 / self.rho_h2o

    @property
    def inv_dropmass(self):
        return 1.0 / self.dropmass

    @property
    def inv_rho_rimeMax(self):
        return 1.0 / self.rho_rimeMax

    @property
    def mi0(self):
        return 4.0 * math.pi / 3.0 * 900.0 * 1.0e-18

    @property
    def piov6(self):
        return math.pi / 6.0

    @property
    def cons1(self):
        return self.piov6 * self.rho_h2o

    @property
    def cons2(self):
        return 4.0 * math.pi / 3.0 * self.rho_h2o

    @property
    def cons3(self):
        return 1.0 / (self.cons2 * 1.5625e-14)

    @property
    def cons5(self):
        return self.piov6 * self.bimm

    @property
    def cons6(self):
        return self.piov6 ** 2 * self.rho_h2o * self.bimm


CONST = P3Constants()

# droplet mass-spectrum shape parameter table (micro_p3_utils_init dnu;
# only used for iparam=1)
DNU = np.array([0.0, -0.557, -0.43, -0.307, -0.186, -0.067, -0.05, -0.167,
                -0.282, -0.397, -0.512, -0.626, -0.739, -0.853, -0.966,
                -0.966])

"""Physical constants with derived thermodynamic parameters
(port of pam_tpu/core/constants.py; ref dynamics/awfl/Dycore.h:871-891)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    R_d: float = 287.0       # dry-air gas constant        (Dycore.h:871)
    cp_d: float = 1003.0     # dry-air isobaric heat cap.  (Dycore.h:872)
    R_v: float = 461.0       # vapor gas constant          (Dycore.h:873)
    cp_v: float = 1859.0     # vapor isobaric heat cap.    (Dycore.h:874)
    p0: float = 1.0e5        # reference pressure          (Dycore.h:875)
    grav: float = 9.81       # gravity                     (Dycore.h:876)
    latvap: float = 2.501e6  # latent heat of vaporization
    latice: float = 3.337e5  # latent heat of fusion
    cp_l: float = 4188.0     # liquid water heat capacity (saturation_adjustment.h:150)

    @property
    def cv_d(self) -> float:
        return self.cp_d - self.R_d

    @property
    def gamma_d(self) -> float:
        return self.cp_d / self.cv_d

    @property
    def kappa_d(self) -> float:
        return self.R_d / self.cp_d

    @property
    def C0(self) -> float:
        # p = C0 * (rho*theta)^gamma  (Dycore.h:890)
        return (self.R_d * self.p0 ** (-self.kappa_d)) ** self.gamma_d


DEFAULT_CONSTANTS = Constants()

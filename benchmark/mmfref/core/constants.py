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


DEFAULT_CONSTANTS = Constants()

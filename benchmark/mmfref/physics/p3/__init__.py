"""P3 (Predicted Particle Properties) microphysics (port of
pam_tpu/physics/p3; ref physics/micro/p3: the Microphysics.h wrapper and
the fortran/micro_p3.F90 column scheme)."""

from .microphysics import P3Micro, register, init_state, TRACER_NAMES
from .main import p3_main

__all__ = ["P3Micro", "register", "init_state", "TRACER_NAMES", "p3_main"]

"""SHOC SGS turbulence scheme (port of pam_tpu/physics/sgs/shoc; ref
physics/sgs/shoc: the SGS.h wrapper and fortran/shoc.F90)."""

from .sgs import ShocSgs, register, init_state
from .main import shoc_main

__all__ = ["ShocSgs", "register", "init_state", "shoc_main"]

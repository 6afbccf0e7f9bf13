"""Test-case helpers of the SPAM dycore needed by the coupled reference
state (port of pam_tpu/spam/testcases.py:60). The idealized test cases
themselves wait for the SPAM standalone slice (ROADMAP queue A)."""

from __future__ import annotations

import numpy as np


def saturation_vapor_pressure(temp):
    """Magnus formula (extrudedmodel.h:5209-5212); numpy."""
    tc = temp - 273.15
    return 610.94 * np.exp(17.625 * tc / (243.04 + tc))

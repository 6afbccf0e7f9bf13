"""Carry coupler state between numpy (and so ``pam_tpu``) and the port.

This system has no weights: what crosses is the coupler state dict —
prognostic fields, tracers, ``ref_*`` and ``gcm_*`` columns, the vertical
grid and the forcing tendencies. The port builds its own tables
(geometry, reference state, linear-system coefficients) from that state
and the grid, so a port-built driver plus a carried-across state
reproduces the ``pam_tpu`` run.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(state: dict[str, np.ndarray], device,
                     dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every leaf as a tensor of ``dtype`` on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in state.items()}


def host_array(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array on the host,
    in its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_to_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Every leaf as a numpy array on the host, in its own dtype."""
    return {k: host_array(v) for k, v in state.items()}

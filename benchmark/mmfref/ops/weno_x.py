"""Periodic-x WENO edge reconstruction in plain torch: the periodic halo,
then ``weno.weno_edges_list`` over the five stencil shifts."""

from __future__ import annotations

import torch

from ..parallel import comm
from . import weno


def weno_edges_x(field: torch.Tensor, tables, kind: str = "x"):
    """(left, right) WENO edge values of each cell along the periodic
    last axis."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    pad = comm.halo_pad(field, (ord - 1) // 2, axis=-1)
    nx = pad.shape[-1] - (ord - 1)
    sten = [pad[..., s:s + nx] for s in range(ord)]
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)

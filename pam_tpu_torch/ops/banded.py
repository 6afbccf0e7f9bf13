"""Banded linear systems (port of pam_tpu/ops/banded.py; ref AWFL's
solve_banded, Dycore.h:1508-1541).

The bands are scattered into a dense (n, n) matrix per system and solved
with one batched ``torch.linalg.solve``: n is a vertical extent (tens of
levels), so the dense solve is one small batched call.
"""

from __future__ import annotations

import numpy as np
import torch


def banded_to_dense(diags: torch.Tensor) -> torch.Tensor:
    """(nbands, n, ...) band storage -> (..., n, n) dense matrices.

    Band b holds the diagonal at offset (b - h), h = (nbands-1)//2, i.e.
    A[row, row + b - h] = diags[b, row] (the reference's layout:
    diags(h, i) is the main diagonal of row i)."""
    nbands, n = diags.shape[0], diags.shape[1]
    if nbands % 2 != 1:
        raise ValueError("the number of bands must be odd (Dycore.h:1512)")
    h = (nbands - 1) // 2
    dense = diags.new_zeros(diags.shape[2:] + (n, n))
    rows = np.arange(n)
    for b in range(nbands):
        cols = rows + b - h
        valid = (cols >= 0) & (cols < n)
        r, c = (torch.as_tensor(i[valid], device=diags.device)
                for i in (rows, cols))
        dense[..., r, c] = torch.movedim(diags[b][r], 0, -1)
    return dense


def solve_banded(diags: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the banded system per trailing batch dims.

    diags: (nbands, n, ...) bands, reference layout (Dycore.h:1508);
    rhs: (n, ...) right-hand sides. Returns (n, ...) solutions."""
    dense = banded_to_dense(diags)                  # (..., n, n)
    b = torch.movedim(rhs, 0, -1)[..., None]        # (..., n, 1)
    x = torch.linalg.solve(dense, b)[..., 0]
    return torch.movedim(x, -1, 0)

"""DFTs of the semi-implicit spectral solves: ``torch.fft`` with numpy's
conventions (forward unnormalized, inverse 1/n). The ``_sh`` names are
the sharded transforms of the program; on one process they are these."""

from __future__ import annotations

import torch


def fft_sh(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.fft.fft(a, dim=dim)


def ifft_real_sh(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.fft.ifft(a, dim=dim).real


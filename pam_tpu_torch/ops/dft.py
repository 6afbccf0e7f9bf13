"""DFTs along x for the semi-implicit spectral solves (port of the
unsharded part of pam_tpu/ops/dft.py:57-92).

``torch.fft`` with numpy's conventions (forward unnormalized, inverse
1/n), as the reference's pocketfft calls (yakl::RealFFT1D,
extrudedmodel.h:2533-2592). The TPU's matmul DFT on the MXU is not
ported.
"""

from __future__ import annotations

import torch


def fft(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A[k] = sum_j a[j] exp(-2i pi jk/n)."""
    return torch.fft.fft(a, dim=dim)


def ifft_real(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """real(ifft(a)), with the 1/n normalization."""
    return torch.fft.ifft(a, dim=dim).real

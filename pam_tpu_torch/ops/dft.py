"""DFTs for the semi-implicit spectral solves (port of the unsharded part
of pam_tpu/ops/dft.py:57-92 and :193-220).

``torch.fft`` with numpy's conventions (forward unnormalized, inverse
1/n), as the reference's pocketfft calls (yakl::RealFFT1D,
extrudedmodel.h:2533-2592): the full transform of the velocity system
along x, the real transform along x and the complex one along y of the
pressure systems. The TPU's matmul DFT on the MXU is not ported.
"""

from __future__ import annotations

import torch


def fft(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A[k] = sum_j a[j] exp(-2i pi jk/n)."""
    return torch.fft.fft(a, dim=dim)


def ifft(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`fft`, with the 1/n normalization."""
    return torch.fft.ifft(a, dim=dim)


def ifft_real(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """real(ifft(a)), with the 1/n normalization."""
    return torch.fft.ifft(a, dim=dim).real


def rfft(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Real-input DFT, the first n//2+1 bins."""
    return torch.fft.rfft(a, dim=dim)


def irfft(a: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`rfft` back to length n (n odd or even: the slab
    MMF grid has nx = 65)."""
    return torch.fft.irfft(a, n=n, dim=dim)

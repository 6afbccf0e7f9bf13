"""DFTs for the semi-implicit spectral solves (port of
pam_tpu/ops/dft.py:57-220).

Unsharded, ``torch.fft`` with numpy's conventions (forward unnormalized,
inverse 1/n), as the reference's pocketfft calls (yakl::RealFFT1D,
extrudedmodel.h:2533-2592): the full transform of the velocity system
along x, the real transform along x and the complex one along y of the
pressure systems. The TPU's matmul DFT on the MXU is not ported.

Under x sharding (``parallel/comm.py``'s axis context) the ``_sh``
transforms compute as pam_tpu does (the psum-DFT, ops/dft.py:99-190): the
forward transform contracts this rank's x block against its columns of
the DFT matrix and sums the partial spectra over the x ranks with one
``all_reduce``, so every x rank holds the whole spectrum; the inverse
contracts that spectrum against this rank's rows of the inverse matrix
and needs no communication. With one x shard each is the ``torch.fft``
route.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..parallel import comm


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


# ---------------------------------------------------------------------------
# x-sharded transforms (the psum-DFT)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """(cos, sin) with cos[k, j] = cos(2 pi k j / n), sin likewise, in
    float64 numpy."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * (k * j % n) / n
    return np.cos(ang), np.sin(ang)


def _t(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(m), dtype=like.dtype,
                           device=like.device)


def _psum_spectrum(a: torch.Tensor, cos: np.ndarray,
                   sin: np.ndarray) -> torch.Tensor:
    """sum_j a[..., j] (cos[k, j] - i sin[k, j]) with j this rank's x
    block of the columns, summed over the x ranks in one ``all_reduce``
    of the real and imaginary parts stacked: the spectrum, whole on every
    x rank."""
    mloc = comm.local_xslice(_t(np.concatenate([cos, -sin]), a), x_dim=-1)
    both = comm.psum_x(torch.einsum('...j,kj->...k', a, mloc))
    nk = cos.shape[0]
    return torch.complex(both[..., :nk], both[..., nk:])


def _rowslice_contract_x(A: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """out[..., j] = sum_k A[..., k] m[j, k] for this rank's rows j."""
    return torch.einsum('...k,jk->...j', A,
                        comm.local_xslice(_t(m, A), x_dim=0))


def _check_last(a: torch.Tensor, dim: int):
    if dim not in (-1, a.ndim - 1):
        raise ValueError("the sharded DFT runs along the last axis")


def fft_sh(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Full DFT of a real field along a (possibly x-sharded) last axis;
    the spectrum is whole on every x rank."""
    if comm.x_shards() == 1:
        return fft(a, dim=dim)
    _check_last(a, dim)
    cos, sin = _dft_mats(a.shape[-1] * comm.x_shards())
    return _psum_spectrum(a, cos, sin)


def ifft_real_sh(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """real(ifft(a)) back to this rank's x block (no communication)."""
    if comm.x_shards() == 1:
        return ifft_real(a, dim=dim)
    _check_last(a, dim)
    n = a.shape[-1]
    cos, sin = _dft_mats(n)
    return (_rowslice_contract_x(a.real, cos.T) -
            _rowslice_contract_x(a.imag, sin.T)) / n


def rfft_sh(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Real-input DFT, the first n//2+1 bins, along a (possibly
    x-sharded) last axis; whole on every x rank."""
    if comm.x_shards() == 1:
        return rfft(a, dim=dim)
    _check_last(a, dim)
    n = a.shape[-1] * comm.x_shards()
    cos, sin = _dft_mats(n)
    nr = n // 2 + 1
    return _psum_spectrum(a, cos[:nr], sin[:nr])


def irfft_sh(a: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`rfft_sh` back to this rank's x block of the
    length-n axis (no communication)."""
    if comm.x_shards() == 1:
        return irfft(a, n, dim=dim)
    _check_last(a, dim)
    cos, sin = _dft_mats(n)
    nr = n // 2 + 1
    # bins 1 .. ceil(n/2)-1 stand for their conjugates too
    w = np.full(nr, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return (_rowslice_contract_x(a.real, (w[:, None] * cos[:nr]).T) -
            _rowslice_contract_x(a.imag, (w[:, None] * sin[:nr]).T)) / n

"""Single-device subset of pam_tpu/parallel/comm.py.

On one device the reference's halo exchanges (exchange.h:434, the
single-process periodic fast path) are periodic rolls and pads, and the
horizontal reductions are plain reductions. Sharding is not ported yet
(ROADMAP queue A).
"""

from __future__ import annotations

import torch


def proll(a: torch.Tensor, s: int, axis: int = -1) -> torch.Tensor:
    """Periodic shift: result[i] = a[i + s] along ``axis``."""
    return torch.roll(a, -s, dims=axis)


def halo_pad(a: torch.Tensor, h: int, axis: int = -1) -> torch.Tensor:
    """Periodic h-wide halo on each side of ``axis``: [0:h] = the last h
    entries, [-h:] = the first h entries."""
    n = a.shape[axis]
    if h > n:
        raise ValueError(f"halo_pad h={h} exceeds axis extent {n}")
    return torch.cat([a.narrow(axis, n - h, h), a, a.narrow(axis, 0, h)],
                     dim=axis)


def psum_h(x: torch.Tensor, axes) -> torch.Tensor:
    return torch.sum(x, dim=axes)


def pmean_h(x: torch.Tensor, axes) -> torch.Tensor:
    return torch.mean(x, dim=axes)


def pmax_h(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.amax(x, dim=axes) if axes is not None else torch.max(x)


def pmin_h(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.amin(x, dim=axes) if axes is not None else torch.min(x)


def local_xslice(a, x_dim: int = -1):
    """The whole x extent is local on one device: identity."""
    return a

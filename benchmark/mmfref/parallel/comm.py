"""The single-process meaning of the collectives that the copied modules
call: every horizontal axis is whole on this process, so a roll is
``torch.roll``, a halo is the array's own wrap and a reduction over the
shards is the local reduction."""

from __future__ import annotations

import torch


def proll(a: torch.Tensor, s: int, axis: int = -1,
          kind: str = None) -> torch.Tensor:
    """result[i] = a[i + s] along ``axis``, periodic."""
    return torch.roll(a, -s, dims=axis)


def halo_pad(a: torch.Tensor, h: int, axis: int = -1,
             kind: str = None) -> torch.Tensor:
    """An h-wide periodic halo on each side of ``axis``."""
    ax = axis % a.ndim - a.ndim
    n = a.shape[ax]
    if h > n:
        raise ValueError(f"halo_pad h={h} exceeds axis extent {n}")
    return torch.cat([a.narrow(ax, n - h, h), a, a.narrow(ax, 0, h)], dim=ax)


def psum_h(x: torch.Tensor, axes) -> torch.Tensor:
    return torch.sum(x, dim=axes)


def pmin_h(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.amin(x, dim=axes) if axes is not None else torch.min(x)


def local_xslice(a, x_dim: int = -1):
    return a


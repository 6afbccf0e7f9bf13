"""Periodic-x WENO edge reconstruction: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernels ``pam_tpu/ops/weno_x_pallas.py::
edge_recon_x_pallas`` and ``pam_tpu/ops/weno_pallas.py::edge_recon_x``
(the same function) with ``csrc/weno_x.cu``. :func:`weno_edges_x` routes
by device: a CUDA tensor goes to the kernel (or raises), a CPU tensor to
:func:`weno_edges_x_reference`, the torch port of ``halo_pad`` +
``weno.weno_edges_list`` that the CPU tests and the card-side comparison
use.

The kernel has two modes. Along an unsharded axis it wraps each row
itself (``pam_weno_x_*``). Along an axis split over ranks
(``parallel/comm.py``) a row is one rank's block, so ``comm.halo_pad``
fetches the two-cell halos from the neighbours first and the kernel
takes the (rows, nx+4) field as it stands (``pam_weno_x_padded_*``), the
input of the TPU kernel (weno_x_pallas.py:46).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import comm
from . import graph, weno, weno5

ORD = weno5.ORD
TILE = 4608        # values of a block's shared-memory tile (csrc/weno_x.cu)
MAX_ROWS = 16      # most rows a block takes


def weno_edges_padded_reference(pad: torch.Tensor, tables):
    """(left, right) WENO edge values of the cells of a field padded by
    the stencil half-width on each side of its last axis, in plain
    torch (``weno_edges_list``); the padded kernel's plain version."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    nx = pad.shape[-1] - (ord - 1)
    sten = [pad[..., s:s + nx] for s in range(ord)]
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def weno_edges_x_reference(field: torch.Tensor, tables, kind: str = "x"):
    """(left, right) WENO edge values of each cell along the periodic
    last axis (x, or y on a view with y moved last: ``kind``) in plain
    torch: periodic halo (exchanged where that axis is sharded) +
    ``weno_edges_list``."""
    hs = (tables[0].shape[-1] - 1) // 2
    return weno_edges_padded_reference(
        comm.halo_pad(field, hs, axis=-1, kind=kind), tables)


def weno_edges_h_reference(field: torch.Tensor, tables, axis: int):
    """The same function along the periodic ``axis`` in plain torch, as
    pam_tpu's 3-D model writes it (``spam/extruded3d.py:77-90``): the
    five stencil rolls and ``weno_edges_list``."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    hs = (s2c.shape[-1] - 1) // 2
    sten = [comm.proll(field, s - hs, axis=axis)
            for s in range(s2c.shape[-1])]
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def weno_x_work(rows, nx, itemsize, tables, padded=False):
    """(bytes, flops) one call needs: the field read once (with its
    halos in the padded mode), both edge arrays written once; per cell
    the limiter, then per edge the candidates evaluated there and their
    weighted sum (``weno.weno_edges_list``)."""
    ord = tables[0].shape[-1]
    hs = (ord + 1) // 2
    per_edge = hs * (2 * hs - 1) + (2 * ord - 1) + (2 * (hs + 1) - 1)
    nread = nx + (ord - 1 if padded else 0)
    return (rows * (nread + 2 * nx) * itemsize,
            rows * nx * (weno.limiter_flops(tables) + 2 * per_edge))


def tiling(rows: int, nx: int) -> tuple[int, int]:
    """(rows per block, cells per segment) for ``csrc/weno_x.cu``. A block
    copies its rows, each with a 2-cell halo on both sides, into a tile of
    TILE values and walks their cells 32 to a warp in memory order, so the
    last warp of a block is full only where rows * nx is a multiple of 32:
    among 1 .. MAX_ROWS rows that fit, take the count that wastes the
    smallest share of its last warp (the larger count on a tie). A row too
    wide for the tile is cut into segments, one row per block."""
    fit = TILE // (nx + 4)
    if fit < 1:
        return 1, TILE - 4
    best, best_use = 1, 0.0
    for rb in range(1, min(fit, MAX_ROWS, max(rows, 1)) + 1):
        use = rb * nx / (32 * -(-rb * nx // 32))
        if use >= best_use:
            best, best_use = rb, use
    return best, nx


def weno_edges_x_cuda(field: torch.Tensor, tables, rows_per_block=None,
                      padded: bool = False):
    """Launch ``csrc/weno_x.cu`` on a contiguous (rows, nx) float32/float64
    CUDA tensor, or with ``padded`` on a (rows, nx+4) one whose halos are
    in place; returns (left, right), each (rows, nx). ``rows_per_block``
    overrides :func:`tiling`'s choice (for measuring it)."""
    if not field.is_cuda:
        raise ValueError(f"weno_edges_x_cuda needs a CUDA tensor, got "
                         f"{field.device}")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"weno_edges_x_cuda takes float32/float64, got "
                        f"{field.dtype}")
    if field.ndim != 2 or not field.is_contiguous():
        raise ValueError(f"weno_edges_x_cuda takes a contiguous (rows, nx) "
                         f"tensor, got shape {tuple(field.shape)} "
                         f"contiguous={field.is_contiguous()}")
    rows, nx = field.shape
    if padded:
        nx -= ORD - 1
        if nx < 1:
            raise ValueError(f"a padded row of {nx + ORD - 1} values holds "
                             "no cell")
    elif nx < (ORD - 1) // 2:
        raise ValueError(f"nx={nx} is narrower than the stencil half-width")
    if np.asarray(tables[0]).dtype != {torch.float32: np.float32,
                                       torch.float64: np.float64}[field.dtype]:
        raise TypeError("WENO tables and field differ in dtype")
    from .. import _cuda
    lib = _cuda.library()
    packed = weno5.prepared_tables(tables)
    rb, seg = tiling(rows, nx)
    if rows_per_block is not None:
        rb = int(rows_per_block)
    left = field.new_empty((rows, nx))
    right = field.new_empty((rows, nx))
    fn = getattr(lib, "pam_weno_x_" + ("padded_" if padded else "") +
                 ("f32" if field.dtype == torch.float32 else "f64"))
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        rc = fn(field.data_ptr(), left.data_ptr(), right.data_ptr(), rows, nx,
                rb, seg, packed.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"weno_x kernel launch failed: CUDA error {rc}")
    graph.count(weno_edges_x_cuda, "launches")
    if padded:
        graph.count(weno_edges_x_cuda, "launches_padded")
    return left, right


weno_edges_x_cuda.launches = 0          # every launch
weno_edges_x_cuda.launches_padded = 0   # the launches in the padded mode


def weno_edges_x(field: torch.Tensor, tables, kind: str = "x"):
    """(left, right) WENO edge values along the periodic last axis for a
    field of any leading shape; ``kind`` names that axis ("x", or "y" for
    a view with y moved last). A CUDA tensor goes to the kernel: the
    wrapping mode, or the padded mode after ``comm.halo_pad`` where the
    axis is sharded. A CPU tensor goes to the plain version."""
    if field.is_cuda:
        shape = field.shape
        if comm.sharded(kind):
            pad = comm.halo_pad(field, (ORD - 1) // 2, axis=-1, kind=kind)
            left, right = weno_edges_x_cuda(
                pad.reshape(-1, pad.shape[-1]).contiguous(), tables,
                padded=True)
        else:
            left, right = weno_edges_x_cuda(
                field.reshape(-1, shape[-1]).contiguous(), tables)
        return left.reshape(shape), right.reshape(shape)
    if field.device.type != "cpu":
        raise ValueError(f"weno_edges_x: no route for device {field.device}")
    return weno_edges_x_reference(field, tables, kind)

"""Periodic-x WENO edge reconstruction: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernels ``pam_tpu/ops/weno_x_pallas.py::
edge_recon_x_pallas`` and ``pam_tpu/ops/weno_pallas.py::edge_recon_x``
(the same function) with ``csrc/weno_x.cu``. :func:`weno_edges_x` routes
by device: a CUDA tensor goes to the kernel (or raises), a CPU tensor to
:func:`weno_edges_x_reference`, the torch port of ``halo_pad`` +
``weno.weno_edges_list`` that the CPU tests and the card-side comparison
use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import comm
from . import weno, weno5

ORD = weno5.ORD
TILE = 4608        # values of a block's shared-memory tile (csrc/weno_x.cu)
MAX_ROWS = 16      # most rows a block takes


def weno_edges_x_reference(field: torch.Tensor, tables):
    """(left, right) WENO edge values of each cell along periodic x (the
    last axis) in plain torch: periodic halo + ``weno_edges_list``."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    hs = (s2c.shape[-1] - 1) // 2
    nx = field.shape[-1]
    pad = comm.halo_pad(field, hs)
    sten = [pad[..., s:s + nx] for s in range(s2c.shape[-1])]
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def weno_edges_h_reference(field: torch.Tensor, tables, axis: int):
    """The same function along the periodic ``axis`` in plain torch, as
    pam_tpu's 3-D model writes it (``spam/extruded3d.py:77-90``): the
    five stencil rolls and ``weno_edges_list``."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    hs = (s2c.shape[-1] - 1) // 2
    sten = [comm.proll(field, s - hs, axis=axis)
            for s in range(s2c.shape[-1])]
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def weno_x_work(rows, nx, itemsize, tables):
    """(bytes, flops) one call needs: the field read once, both edge
    arrays written once; per cell the limiter, then per edge the
    candidates evaluated there and their weighted sum
    (``weno.weno_edges_list``)."""
    ord = tables[0].shape[-1]
    hs = (ord + 1) // 2
    per_edge = hs * (2 * hs - 1) + (2 * ord - 1) + (2 * (hs + 1) - 1)
    return (3 * rows * nx * itemsize,
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


def weno_edges_x_cuda(field: torch.Tensor, tables, rows_per_block=None):
    """Launch ``csrc/weno_x.cu`` on a contiguous (rows, nx) float32/float64
    CUDA tensor; returns (left, right), each (rows, nx). ``rows_per_block``
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
    if nx < (ORD - 1) // 2:
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
    left = torch.empty_like(field)
    right = torch.empty_like(field)
    fn = lib.pam_weno_x_f32 if field.dtype == torch.float32 \
        else lib.pam_weno_x_f64
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        rc = fn(field.data_ptr(), left.data_ptr(), right.data_ptr(), rows, nx,
                rb, seg, packed.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"weno_x kernel launch failed: CUDA error {rc}")
    weno_edges_x_cuda.launches += 1
    return left, right


weno_edges_x_cuda.launches = 0


def weno_edges_x(field: torch.Tensor, tables):
    """(left, right) WENO edge values along periodic x for a field of any
    leading shape: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if field.is_cuda:
        shape = field.shape
        left, right = weno_edges_x_cuda(
            field.reshape(-1, shape[-1]).contiguous(), tables)
        return left.reshape(shape), right.reshape(shape)
    if field.device.type != "cpu":
        raise ValueError(f"weno_edges_x: no route for device {field.device}")
    return weno_edges_x_reference(field, tables)

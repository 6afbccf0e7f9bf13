"""Vertical WENO edge reconstruction of the SPAM slab: the CUDA kernel and
its plain version.

``spam/tendencies.py::_edge_recon_z`` takes a field mirror-padded along z
(``operators.mirror_iface``) and returns the bottom and top edge values
of its cells 0 .. nlev-1, with the uniform grid's stencil matrices or a
stretched grid's per-level ones. pam_tpu leaves that to XLA, which fuses
``weno.weno_edges_list``; the port's CUDA route is ``csrc/weno_z.cu``, one
launch a call. :func:`weno_edges_z` routes by device: a CUDA tensor goes
to the kernel (or raises), a CPU tensor to :func:`weno_edges_z_reference`,
``weno_edges_list`` on the five stencil views, which the CPU tests and the
card-side comparison use.

The kernel reads per-level matrices packed once per tendencies object
(:func:`pack_level_matrices`): per level, the bridge polynomial's matrix
``weno5.bridge_matrix`` [c][s], then wrl[i][s][c], as
``awfl_flux.LevelMatrices`` packs B3's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import graph, recon_matrices as rm, weno, weno5, weno_x

ORD = weno5.ORD
NMAT = weno5.NMAT          # values per level in packed matrices


def weno_edges_z_reference(field_padded: torch.Tensor, tables, nlev: int,
                           per_level=None):
    """(bottom, top) of cells 0 .. nlev-1 of a field padded by the stencil
    half-width on each side of its z axis (-2), in plain torch.
    ``per_level``: (s2c, wrl) per-level matrices with leading matrix dims
    and trailing (nens, nlev, 1) dims, in place of the uniform tables'."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    sten = [field_padded[..., s:s + nlev, :] for s in range(ord)]
    if per_level is not None:
        s2c, wrl = per_level
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def pack_level_matrices(s2c, wrl, dtype, device) -> torch.Tensor:
    """(members, nlev, NMAT) tensor of per-level matrices for the kernel,
    from numpy (members, nlev, ord, ord) s2c and (members, nlev, hs, hs,
    hs) wrl (``recon_matrices.mirror_recon_matrices``): the bridge merged
    in float64, then rounded to ``dtype``."""
    idl, _ = rm.weno_ideal_weights(ORD)
    return torch.as_tensor(weno5.pack_matrices(s2c, wrl, idl), dtype=dtype,
                           device=device)


def weno_z_work(rows, nlev, nx, itemsize, tables):
    """(bytes, flops) one call needs: the padded field read once, both
    edge arrays written once (the per-level matrices, a few KB a member,
    left out); per cell the operations of the plain version, as
    ``weno_x.weno_x_work`` counts them."""
    flops = weno_x.weno_x_work(rows * nlev, nx, itemsize, tables)[1]
    return rows * (3 * nlev + ORD - 1) * nx * itemsize, flops


def weno_edges_z_cuda(field: torch.Tensor, tables, nlev: int, levels=None):
    """Launch ``csrc/weno_z.cu`` on a (rows, nlev+4, nx) float32/float64
    CUDA tensor whose last two axes are contiguous (rows may be strided);
    ``levels``: None (the uniform tables) or packed per-level matrices
    (members, nlev, NMAT), row r taking member r mod members. Returns
    (bottom, top), each a new (rows, nlev, nx) tensor."""
    if not field.is_cuda:
        raise ValueError(f"weno_edges_z_cuda needs a CUDA tensor, got "
                         f"{field.device}")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"weno_edges_z_cuda takes float32/float64, got "
                        f"{field.dtype}")
    if (field.ndim != 3 or field.shape[1] != nlev + ORD - 1
            or field.stride(2) != 1 or field.stride(1) != field.shape[2]
            or (field.shape[0] > 1
                and field.stride(0) < field.shape[1] * field.shape[2])):
        raise ValueError(f"weno_edges_z_cuda takes a (rows, {nlev + ORD - 1}"
                         f", nx) tensor with contiguous (z, x) planes, got "
                         f"shape {tuple(field.shape)} strides "
                         f"{field.stride()}")
    if np.asarray(tables[0]).dtype != weno._NP_DTYPES[field.dtype]:
        raise TypeError("WENO tables and field differ in dtype")
    rows, _, nx = field.shape
    members = 0
    if levels is not None:
        members = levels.shape[0]
        if (levels.ndim != 3 or levels.shape[1:] != (nlev, NMAT)
                or rows % members or levels.dtype != field.dtype
                or levels.device != field.device
                or not levels.is_contiguous() or levels.data_ptr() % 16):
            raise ValueError(
                f"weno_edges_z_cuda: packed level matrices are "
                f"{tuple(levels.shape)} {levels.dtype} on {levels.device}; "
                f"need a contiguous, 16-byte aligned (members, {nlev}, "
                f"{NMAT}) {field.dtype} tensor on {field.device}, members "
                f"dividing the {rows} rows")
    from .. import _cuda
    lib = _cuda.library()
    packed = weno5.prepared_tables(tables)
    bottom = field.new_empty((rows, nlev, nx))
    top = field.new_empty((rows, nlev, nx))
    fn = (lib.pam_weno_z_f32 if field.dtype == torch.float32
          else lib.pam_weno_z_f64)
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        rc = fn(field.data_ptr(), bottom.data_ptr(), top.data_ptr(), rows,
                field.stride(0) if rows > 1 else (nlev + ORD - 1) * nx,
                nlev, nx,
                None if levels is None else levels.data_ptr(), members,
                packed.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"weno_z kernel launch failed: CUDA error {rc}")
    graph.count(weno_edges_z_cuda, "launches")
    return bottom, top


weno_edges_z_cuda.launches = 0          # every launch


def weno_edges_z(field_padded: torch.Tensor, tables, nlev: int,
                 per_level=None, packed=None):
    """(bottom, top) of cells 0 .. nlev-1 of a z-padded field
    (..., nlev+4, nx). A CUDA tensor goes to the kernel, with ``packed``
    (:func:`pack_level_matrices`) where the grid is stretched; a CPU
    tensor to the plain version, with ``per_level``."""
    if field_padded.is_cuda:
        if per_level is not None and packed is None:
            raise ValueError("weno_edges_z: per-level matrices reach the "
                             "kernel packed; none were given")
        lead, (nz_pad, nx) = field_padded.shape[:-2], field_padded.shape[-2:]
        bottom, top = weno_edges_z_cuda(
            field_padded.reshape(-1, nz_pad, nx), tables, nlev,
            None if per_level is None else packed)
        return (bottom.reshape(lead + (nlev, nx)),
                top.reshape(lead + (nlev, nx)))
    if field_padded.device.type != "cpu":
        raise ValueError(f"weno_edges_z: no route for device "
                         f"{field_padded.device}")
    return weno_edges_z_reference(field_padded, tables, nlev, per_level)

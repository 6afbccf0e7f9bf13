"""The AWFL dycore's FCT tracer limiter: the CUDA kernel and its plain
version.

``dycore/awfl.py::AwflDycore._fct`` scales the face fluxes of every
positive-definite tracer so that no cell gives away more mass than it
holds at the start of the stage (ref: Dycore.h:521-550). pam_tpu writes
it as jnp, which XLA fuses; eager PyTorch and its CUDA graph run the same
arithmetic as ~31 elementwise kernels a tendency. :func:`fct_limit` routes
by :func:`uses_kernel`: a 2-D run's CUDA tensors, with x not sharded, go
to ``csrc/awfl_fct.cu`` through :func:`fct_limit_cuda` (one launch a
tendency, or raise); every other call (CPU tensors, a 3-D run, the
x-sharded step, whose multipliers cross the seam by a ring exchange) to
:func:`fct_limit_reference`, which the card-side comparison also uses.

Arrays are in the dycore's layout ``(nvar, nens, ny, nz, nx)``: a tracer
flux along an axis has one face more than cells along it.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ..parallel import comm
from . import graph

AX_Y, AX_Z, AX_X = 2, 3, 4      # axes of (nvar, nens, ny, nz, nx)
N_ARGS = 28                     # length of the kernel's argument array
ENTRIES = 1024                  # csrc/awfl_fct.cu: a tile's multipliers


def _pad_ones(a, axis):
    """One layer of 1.0 on each side of ``axis``."""
    shape = list(a.shape)
    shape[axis] = 1
    ones = a.new_ones(shape)
    return torch.cat([ones, a, ones], dim=axis)


def fct_limit_reference(fluxes, tracers_start, dt, dz4, pos, dx, dy):
    """Scale the tracer fluxes so that no positive tracer's cell gives
    away more mass than it holds (ref: Dycore.h:525-550), in plain torch.
    ``fluxes``: (axis, spacing, state flux, tracer flux) per direction;
    ``dt`` a float or a 0-d tensor; ``dz4`` (nens, 1, nz, 1); ``pos``
    (ntr, 1, 1, 1, 1) bool; ``dx``, ``dy`` floats. Returns the same list
    with the tracer fluxes limited."""
    vol = dx * dy * dz4
    mass_avail = tracers_start.clamp(min=0.0) * vol

    def outflow(tf, ax, d):
        n = tf.shape[ax] - 1
        return (tf.narrow(ax, 1, n).clamp(min=0.0)
                - tf.narrow(ax, 0, n).clamp(max=0.0)) / d

    flux_out = functools.reduce(
        operator.add, (outflow(tf, ax, d) for ax, d, _, tf in fluxes))
    mass_out = flux_out * dt * vol
    mult = torch.where(
        mass_out > mass_avail,
        mass_avail / torch.where(mass_out == 0, 1.0, mass_out), 1.0)
    mult = torch.where(pos, mult, 1.0)

    def limit(flux, ax):
        # A face flux > 0 leaves the cell on its minus side, < 0 the cell
        # on its plus side; only that cell's multiplier applies (the
        # reference's race-freedom argument, Dycore.h:521-524). Horizontal
        # axes wrap periodically, so the duplicated wrap faces get the
        # same scaling (the uniform interior rule, in place of the
        # reference's min() at the seam, Dycore.h:574-579). The vertical
        # axis pads with 1.
        n = mult.shape[ax]
        padded = (_pad_ones(mult, ax) if ax == AX_Z
                  else comm.halo_pad(mult, 1, axis=ax,
                                     kind="x" if ax == AX_X else "y"))
        ml = padded.narrow(ax, 0, n + 1)
        mr = padded.narrow(ax, 1, n + 1)
        return flux * torch.where(flux > 0, ml,
                                  torch.where(flux < 0, mr, 1.0))

    return [(ax, d, sf, limit(tf, ax)) for ax, d, sf, tf in fluxes]


def uses_kernel(device: torch.device, sim2d: bool) -> bool:
    """Whether :func:`fct_limit` takes the kernel: CUDA tensors of a 2-D
    run with x not sharded over a mesh."""
    return device.type == "cuda" and sim2d and not comm.sharded("x")


def fct_tiles(nz: int, nx: int) -> tuple[int, int]:
    """(rows, columns) of a block's tile for ``csrc/awfl_fct.cu``, whose
    multipliers with the row below and the column to the left, (rows + 1)
    x (columns + 1), are at most ENTRIES: whole rows where two fit, the
    levels spread evenly over the fewest tiles; else one row's
    segments."""
    cols = nx if 2 * (nx + 1) <= ENTRIES else ENTRIES // 2 - 1
    tiles = -(-nz // (ENTRIES // (cols + 1) - 1))
    return -(-nz // tiles), cols


def _check_cuda(flux_x, flux_z, tracers_start, dt, dz4, pos):
    """Refuse, by name, what the kernel does not take: types and shapes
    first, then devices."""
    named = (("flux_x", flux_x), ("flux_z", flux_z),
             ("tracers_start", tracers_start), ("dz4", dz4))
    dtype = tracers_start.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fct_limit_cuda takes float32/float64, got "
                        f"tracers_start {dtype}")
    for name, a in named:
        if a.dtype != dtype:
            raise TypeError(f"fct_limit_cuda: {name} is {a.dtype}, "
                            f"tracers_start {dtype}")
    if tracers_start.ndim != 5 or tracers_start.shape[2] != 1:
        raise ValueError(f"fct_limit_cuda takes a 2-D run's (ntr, nens, 1, "
                         f"nz, nx) tracers_start, got "
                         f"{tuple(tracers_start.shape)}")
    ntr, nens, _, nz, nx = tracers_start.shape
    for name, a, want in (("flux_x", flux_x, (ntr, nens, 1, nz, nx + 1)),
                          ("flux_z", flux_z, (ntr, nens, 1, nz + 1, nx))):
        if tuple(a.shape) != want:
            raise ValueError(f"fct_limit_cuda: {name} is "
                             f"{tuple(a.shape)}, need {want}")
    if (dz4.ndim != 4 or dz4.shape[0] not in (1, nens)
            or tuple(dz4.shape[1:]) != (1, nz, 1)):
        raise ValueError(f"fct_limit_cuda: dz4 is {tuple(dz4.shape)}, need "
                         f"({nens} or 1, 1, {nz}, 1)")
    if (pos.dtype != torch.bool or pos.numel() != ntr
            or not pos.is_contiguous()):
        raise ValueError(f"fct_limit_cuda: pos is {pos.dtype} "
                         f"{tuple(pos.shape)}; need a contiguous bool "
                         f"tensor of {ntr} flags")
    if isinstance(dt, torch.Tensor) and (dt.ndim != 0 or dt.dtype != dtype):
        raise TypeError(f"fct_limit_cuda: dt is a {dt.ndim}-d {dt.dtype} "
                        f"tensor; need a float or a 0-d {dtype} tensor")
    device = tracers_start.device
    for name, a in named + (("pos", pos),) + (
            (("dt", dt),) if isinstance(dt, torch.Tensor) else ()):
        if not a.is_cuda or a.device != device:
            raise ValueError(f"fct_limit_cuda needs CUDA tensors on one "
                             f"device: {name} is on {a.device}, "
                             f"tracers_start on {device}")


def _kernel_args(flux_x, flux_z, tracers_start, dt, dz4, pos, lim_x, lim_z,
                tiles) -> np.ndarray:
    """The N_ARGS int64 values ``csrc/awfl_fct.cu`` reads (see FctArgs):
    pointers, sizes, strides in elements over (tracer, member, z, x),
    dz's over (member, z), the tile."""
    ntr, nens, _, nz, nx = tracers_start.shape
    sel = lambda a: [a.stride(0), a.stride(1), a.stride(3), a.stride(4)]
    args = np.array(
        [flux_x.data_ptr(), flux_z.data_ptr(), tracers_start.data_ptr(),
         dz4.data_ptr(), pos.data_ptr(),
         dt.data_ptr() if isinstance(dt, torch.Tensor) else 0,
         lim_x.data_ptr(), lim_z.data_ptr(), ntr, nens, nz, nx,
         *sel(flux_x), *sel(flux_z), *sel(tracers_start),
         dz4.stride(0) if dz4.shape[0] > 1 else 0, dz4.stride(2), *tiles],
        dtype=np.int64)
    if args.shape != (N_ARGS,):
        raise RuntimeError(f"awfl_fct: {args.size} kernel arguments, not "
                           f"{N_ARGS}")
    return args


def fct_limit_cuda(flux_x, flux_z, tracers_start, dt, dz4, pos, dx, dy):
    """Launch ``csrc/awfl_fct.cu`` on a 2-D run's CUDA tensors (float32 or
    float64, any strides): the x tracer flux (ntr, nens, 1, nz, nx+1), the
    z tracer flux (ntr, nens, 1, nz+1, nx), ``tracers_start`` (ntr, nens,
    1, nz, nx), ``dt`` a float or a 0-d tensor, ``dz4``, ``pos``, ``dx``
    and ``dy`` as :func:`fct_limit_reference` takes them, in tiles of
    :func:`fct_tiles`. Returns the limited (x, z) tracer fluxes, new
    contiguous tensors."""
    _check_cuda(flux_x, flux_z, tracers_start, dt, dz4, pos)
    lim_x = torch.empty_like(flux_x, memory_format=torch.contiguous_format)
    lim_z = torch.empty_like(flux_z, memory_format=torch.contiguous_format)
    args = _kernel_args(flux_x, flux_z, tracers_start, dt, dz4, pos, lim_x,
                       lim_z, fct_tiles(*tracers_start.shape[3:]))
    from .. import _cuda
    lib = _cuda.library()
    fn = lib.pam_awfl_fct_f32 if tracers_start.dtype == torch.float32 \
        else lib.pam_awfl_fct_f64
    with torch.cuda.device(tracers_start.device):
        stream = torch.cuda.current_stream(tracers_start.device).cuda_stream
        rc = fn(args.ctypes.data, dx * dy, dx,
                0.0 if isinstance(dt, torch.Tensor) else float(dt), stream)
    if rc != 0:
        raise RuntimeError(f"awfl_fct kernel launch failed: CUDA error {rc}")
    graph.count(fct_limit_cuda, "launches")
    return lim_x, lim_z


fct_limit_cuda.launches = 0         # every launch


def fct_limit(fluxes, tracers_start, dt, dz4, pos, dx, dy, sim2d: bool):
    """The FCT limiter: arguments and result as :func:`fct_limit_reference`
    (``sim2d``: whether the run is 2-D). Where :func:`uses_kernel` holds,
    the kernel limits the x and z tracer fluxes in one launch; elsewhere
    the plain version."""
    if uses_kernel(tracers_start.device, sim2d):
        (ax, sx, sfx, tfx), (az, sz, sfz, tfz) = fluxes
        tfx, tfz = fct_limit_cuda(tfx, tfz, tracers_start, dt, dz4, pos, dx,
                                  dy)
        return [(ax, sx, sfx, tfx), (az, sz, sfz, tfz)]
    return fct_limit_reference(fluxes, tracers_start, dt, dz4, pos, dx, dy)

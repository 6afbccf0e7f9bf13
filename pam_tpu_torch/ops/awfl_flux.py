"""The AWFL directional flux: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``pam_tpu/ops/awfl_pallas.py::
flux_direction_fused`` (kernel B3, body ``_direction_kernel``) with
``csrc/awfl_flux.cu``. For one direction, at every face: the WENO values
of rho*u_n and of the pressure from both sides, the acoustic
characteristic split at the frozen sound speed, the rigid-lid mask in z,
then for u, v, w, theta and every tracer one upwind-selected WENO value
times the mass flux, with the pressure added to the flux of the normal
momentum (ref: dynamics/awfl/Dycore.h:334-519).

:func:`flux_direction` routes by device: CUDA tensors go to the kernel
(or raise), CPU tensors to :func:`flux_direction_reference`, the torch
port of ``direction(axis)`` of ``pam_tpu/dycore/awfl.py:336-389`` through
``weno.reconstruct_faces_both`` / ``reconstruct_faces_upwind``.

Arrays are in the dycore's layout ``(nvar, nens, ny, nz, nx)``. The
inputs of one direction are padded by ``hs`` cells on each side of that
direction's axis only (``nfaces + ord`` cells for ``nfaces`` faces); they
may be strided views of larger arrays, the kernel reads them in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.mesh import per_member
from . import graph, recon_matrices as rm, weno, weno5

CS = 350.0  # frozen acoustic characteristic speed (ref: Dycore.h:335)
AX_Y, AX_Z, AX_X = 2, 3, 4      # axes of (nvar, nens, ny, nz, nx)
ORD, HS = weno5.ORD, weno5.HS
LEVEL_STRIDE = weno5.NMAT       # values per level in packed matrices
N_ARGS = 28                     # length of the kernel's argument array
MAX_TILE_FACES = 8              # csrc/awfl_flux.cu::MAX_TF
TILE_FACES = 4                  # faces of a tile along y or z, at most
# per direction: index of the normal momentum among (u, v, w), and the
# kernel's direction code
_MOM_Q = {AX_X: 0, AX_Y: 1, AX_Z: 2}


@dataclasses.dataclass(frozen=True)
class LevelMatrices:
    """Per-level reconstruction matrices of a stretched vertical grid, for
    ``members`` = nens members or 1 (one set for every member).

    s2c: (ord, ord, members, 1, nz+2, 1) and wrl: (hs, hs, hs, members, 1,
    nz+2, 1) tensors for the plain version (matrix dims leading, the level
    axis at -2 of the dycore's layout). packed: one (members, nz+2, 52)
    tensor for the kernel, per level the bridge polynomial's matrix
    ``weno5.bridge_matrix`` [c][s], then wrl[i][s][c]."""
    s2c: torch.Tensor = per_member(2)
    wrl: torch.Tensor = per_member(3)
    packed: torch.Tensor = per_member(0)

    @staticmethod
    def build(s2c: np.ndarray, wrl: np.ndarray, dtype,
              device) -> "LevelMatrices":
        """From ``recon_matrices.vertical_recon_matrices`` output of
        shapes (members, nz+2, ord, ord) and (members, nz+2, hs, hs, hs)."""
        to = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
        vs2c = to(np.moveaxis(s2c, (2, 3), (0, 1)))[:, :, :, None, :, None]
        vwrl = to(np.moveaxis(wrl, (2, 3, 4), (0, 1, 2)))[:, :, :, :, None, :,
                                                          None]
        idl, _ = rm.weno_ideal_weights(ORD)
        packed = to(weno5.pack_matrices(s2c, wrl, idl))
        return LevelMatrices(vs2c, vwrl, packed)

    def to(self, dtype) -> "LevelMatrices":
        return LevelMatrices(self.s2c.to(dtype), self.wrl.to(dtype),
                             self.packed.to(dtype))


def _check_direction(prim, trac, pres, axis):
    if axis not in _MOM_Q:
        raise ValueError(f"axis {axis}: the directions are {AX_Y} (y), "
                         f"{AX_Z} (z) and {AX_X} (x)")
    if prim.ndim != 5 or prim.shape[0] != 5:
        raise ValueError(f"prim must be (5, nens, ny, nz, nx), got "
                         f"{tuple(prim.shape)}")
    if trac.ndim != 5 or trac.shape[1:] != prim.shape[1:]:
        raise ValueError(f"trac {tuple(trac.shape)} does not match prim "
                         f"{tuple(prim.shape)}")
    if pres.shape != prim.shape[1:]:
        raise ValueError(f"pres {tuple(pres.shape)} does not match prim "
                         f"{tuple(prim.shape)}")
    if prim.shape[axis] <= ORD:
        raise ValueError(f"axis {axis} holds {prim.shape[axis]} cells; a "
                         f"face needs {ORD + 1}")


def flux_direction_reference(prim, trac, pres, axis, tables, levels=None):
    """The directional flux in plain torch.

    prim: (5, nens, ny, nz, nx) de-densitized state [rho, u, v, w, theta],
    ``axis`` padded by hs cells each side; trac: (ntr, ...) de-densitized
    tracers (ntr may be 0); pres: (...) pressure. ``levels``: the
    :class:`LevelMatrices` of a z direction on a stretched grid. In z the
    acoustic mass flux is zeroed at the first and last face (rigid
    ground and lid, Dycore.h:477-496).
    Returns (state_flux (5, ..faces..), tracer_flux (ntr, ..faces..))."""
    _check_direction(prim, trac, pres, axis)
    rho = prim[0]
    mom_q = _MOM_Q[axis]
    ru_fld = rho * prim[1 + mom_q]
    pl = None if levels is None else (levels.s2c, levels.wrl)
    kw = dict(per_level=pl, per_level_axis=-2)
    # candidates for the acoustic quantities, from both sides
    ruL, ruR = weno.reconstruct_faces_both(ru_fld[None], axis, tables, **kw)
    ppL, ppR = weno.reconstruct_faces_both(pres[None], axis, tables, **kw)
    ruL, ruR, ppL, ppR = ruL[0], ruR[0], ppL[0], ppR[0]
    zmask = axis == AX_Z
    if zmask:
        nfaces = ruL.shape[AX_Z - 1]
        mask = torch.zeros(nfaces, dtype=torch.bool, device=prim.device)
        mask[0] = mask[-1] = True
        mask = mask[None, None, :, None]
        ruL = torch.where(mask, 0.0, ruL)
        ruR = torch.where(mask, 0.0, ruR)
    w1 = 0.5 * (ppR - CS * ruR)
    w2 = 0.5 * (ppL + CS * ruL)
    pp = w1 + w2
    ru = (w2 - w1) / CS
    if zmask:
        ru = torch.where(mask, 0.0, ru)
    upw = ru > 0
    # advective quantities: u, v, w, theta and all tracers, one batched
    # upwind-selected reconstruction
    q = torch.cat([prim[1:], trac], dim=0)
    vals = weno.reconstruct_faces_upwind(q, axis, tables, upw[None], **kw)
    flux_q = ru[None] * vals
    flux_q[mom_q] = flux_q[mom_q] + pp   # flux_q is this function's own
    return torch.cat([ru[None], flux_q[:4]]), flux_q[4:]


def tile_faces(nfaces: int) -> int:
    """Faces of a block's tile along y or z for ``csrc/awfl_flux.cu``. A
    block of tf faces is 32 (tf + 1) threads and evaluates the acoustic
    limiters of tf + 1 cells, so a large tile wastes fewer evaluations
    and a small one leaves the card more blocks to place: at 65x1x50 on
    an H100, tiles of 3 and 4 faces were the fastest of 1-8 in float32
    and float64 (PERF.md). The faces are spread evenly over the fewest
    tiles of at most TILE_FACES."""
    tiles = -(-nfaces // TILE_FACES)
    return -(-nfaces // tiles)


def flux_direction_cuda(prim, trac, pres, axis, tables, levels=None,
                        faces_per_tile=None):
    """Launch ``csrc/awfl_flux.cu`` on CUDA tensors (float32 or float64;
    any strides); arguments and results as :func:`flux_direction_reference`.
    ``levels`` may hold one matrix set or one per member.
    ``faces_per_tile`` overrides :func:`tile_faces` (for measuring it)."""
    _check_direction(prim, trac, pres, axis)
    for name, a in (("prim", prim), ("trac", trac), ("pres", pres)):
        if not a.is_cuda:
            raise ValueError(f"flux_direction_cuda needs CUDA tensors, "
                             f"{name} is on {a.device}")
        if a.dtype != prim.dtype or a.device != prim.device:
            raise TypeError(f"flux_direction_cuda: {name} is {a.dtype} on "
                            f"{a.device}, prim {prim.dtype} on {prim.device}")
    if prim.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"flux_direction_cuda takes float32/float64, got "
                        f"{prim.dtype}")
    if np.asarray(tables[0]).dtype != weno._NP_DTYPES[prim.dtype]:
        raise TypeError("WENO tables and fields differ in dtype")
    mats, member_stride = None, 0
    if levels is not None:
        if axis != AX_Z:
            raise ValueError("per-level matrices belong to the z direction")
        mats = levels.packed
        nlev = prim.shape[AX_Z] - ORD + 1
        if (mats.ndim != 3 or mats.shape[0] not in (1, prim.shape[1])
                or mats.shape[1:] != (nlev, LEVEL_STRIDE)
                or mats.dtype != prim.dtype or mats.device != prim.device
                or not mats.is_contiguous() or mats.data_ptr() % 16):
            raise ValueError(
                f"flux_direction_cuda: packed level matrices are "
                f"{tuple(mats.shape)} {mats.dtype} on {mats.device}; need a "
                f"contiguous, 16-byte aligned (1 or {prim.shape[1]}, {nlev}, "
                f"{LEVEL_STRIDE}) {prim.dtype} tensor on {prim.device}")
        if mats.shape[0] > 1:
            member_stride = nlev * LEVEL_STRIDE
    from .. import _cuda
    lib = _cuda.library()
    ntr = trac.shape[0]
    oshape = list(prim.shape[1:])
    oshape[axis - 1] -= ORD
    tf = tile_faces(oshape[axis - 1]) if faces_per_tile is None \
        else int(faces_per_tile)
    sflux = prim.new_empty([5] + oshape)
    tflux = prim.new_empty([ntr] + oshape)
    args = np.array(
        [prim.data_ptr(), trac.data_ptr(), pres.data_ptr(),
         sflux.data_ptr(), tflux.data_ptr(),
         0 if mats is None else mats.data_ptr(), member_stride,
         ntr, *oshape, _MOM_Q[axis],
         *prim.stride(), *trac.stride(), *pres.stride(), tf],
        dtype=np.int64)
    if args.shape != (N_ARGS,):
        raise RuntimeError(f"awfl_flux: {args.size} kernel arguments, not "
                           f"{N_ARGS}")
    packed = weno5.prepared_tables(tables)
    fn = lib.pam_awfl_flux_f32 if prim.dtype == torch.float32 \
        else lib.pam_awfl_flux_f64
    with torch.cuda.device(prim.device):
        stream = torch.cuda.current_stream(prim.device).cuda_stream
        rc = fn(args.ctypes.data, packed.ctypes.data, CS, stream)
    if rc != 0:
        raise RuntimeError(f"awfl_flux kernel launch failed: CUDA error {rc}")
    graph.count(flux_direction_cuda, "launches")
    return sflux, tflux


flux_direction_cuda.launches = 0


def flux_direction(prim, trac, pres, axis, tables, levels=None):
    """The directional flux: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if prim.is_cuda:
        return flux_direction_cuda(prim, trac, pres, axis, tables, levels)
    if prim.device.type != "cpu":
        raise ValueError(f"flux_direction: no route for device {prim.device}")
    return flux_direction_reference(prim, trac, pres, axis, tables, levels)


def weno_flops(tables) -> int:
    """Floating-point operations of one limited edge value as
    ``weno.weno_coefs_list`` + ``_eval_edge_list`` compute it."""
    ord = tables[0].shape[-1]
    hs = (ord + 1) // 2
    return (weno.limiter_flops(tables)
            + hs * (2 * hs + 1) + (ord - hs)    # weighted sum of candidates
            + 2 * ord - 1)                      # evaluation at the edge


def flux_work(prim_shape, ntr, axis, itemsize, tables, matrix_sets=0):
    """(bytes, flops) one call needs: every input element read once and
    every output element written once (``matrix_sets`` sets of per-level
    matrices among the inputs); 4 two-sided and 4 + ntr upwind WENO
    evaluations per face plus the characteristic split."""
    cells = int(np.prod(prim_shape[1:]))
    faces = cells // prim_shape[axis] * (prim_shape[axis] - ORD)
    nbytes = itemsize * ((5 + ntr + 1) * cells + (5 + ntr) * faces)
    nbytes += (itemsize * matrix_sets * LEVEL_STRIDE
               * (prim_shape[AX_Z] - ORD + 1))
    flops = faces * ((8 + ntr) * weno_flops(tables) + (ORD + 1) + 13
                     + 2 * (4 + ntr))
    return nbytes, flops

"""Sharded CRM and dycore steps over ``torch.distributed`` (port of
pam_tpu/parallel/sharded_step.py).

The reference decomposes its domain over MPI ranks
(dynamics/spam/src/core/{params.h finalize_parallel, exchange.h}). This
is pam_tpu's "mode 3", explicit sharding: one process a rank, each
holding its (ens, y, x) block of the state; every horizontal shift is a
point-to-point halo fetch, every horizontal reduction an ``all_reduce``,
and the SI spectral solves run through the psum-DFT
(``parallel/comm.py``, ``ops/dft.py``). The step code is the unsharded
one, written once against ``comm``; the axis context makes it exchange.

PyTorch has no GSPMD, so pam_tpu's mode 2 has no counterpart: the port
runs mode 1 (unsharded) and mode 3 (this file). pam_tpu leaves the
ensemble axis to GSPMD, which partitions the driver's per-member tables
with it. Here each rank's driver holds its own members: :func:`ens_block`
cuts every per-member table to the rank's block when the step is
wrapped. Tables with the global x extent stay whole and are cut with
``comm.local_xslice`` where they are used.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import comm
from .mesh import ENS_AXIS, X_AXIS, Y_AXIS, Mesh, shard_state

def _cut(v, axis: int, lo: int, n: int, nens: int, where: str):
    """Members lo .. lo+n of a per-member table (a tensor, an array or a
    list of them); a table of one member serves all and stays."""
    if isinstance(v, (list, tuple)):
        return type(v)(_cut(a, axis, lo, n, nens, where) for a in v)
    if v is None:
        return v
    size = v.shape[axis]
    if size == 1:
        return v
    if size != nens:
        raise ValueError(f"{where}: expected {nens} members on axis {axis}, "
                         f"got shape {tuple(v.shape)}")
    if isinstance(v, torch.Tensor):
        return v.narrow(axis, lo, n).contiguous()
    return np.ascontiguousarray(np.take(v, np.arange(lo, lo + n), axis=axis))


def ens_block(obj, lo: int, n: int, nens: int, _memo=None):
    """A copy of a driver, dycore or any of their parts that holds members
    lo .. lo+n of an ``nens``-member ensemble: every per-member table (a
    field declared with ``mesh.per_member``) cut, every ``nens`` field set
    to n; nested objects are walked, and an object shared by several
    owners stays shared."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    out = obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            if not f.init:
                continue
            v = getattr(obj, f.name)
            if "ens_axis" in f.metadata:
                nv = _cut(v, f.metadata["ens_axis"], lo, n, nens,
                          f"{type(obj).__name__}.{f.name}")
            elif f.name == "nens" and isinstance(v, int):
                nv = n
            else:
                nv = ens_block(v, lo, n, nens, memo)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            out = dataclasses.replace(obj, **changes)
    elif isinstance(obj, list) or (isinstance(obj, tuple)
                                   and not hasattr(obj, "_fields")):
        items = [ens_block(v, lo, n, nens, memo) for v in obj]
        if any(a is not b for a, b in zip(items, obj)):
            out = type(obj)(items)
    memo[id(obj)] = out
    return out


def _rank_block(obj, mesh: Mesh, nens: int):
    if nens % mesh.n_ens:
        raise ValueError(f"nens={nens} not divisible by {mesh.n_ens} "
                         "ensemble shards")
    n = nens // mesh.n_ens
    return ens_block(obj, mesh.e * n, n, nens)


def state_specs(state, x_axis: str = X_AXIS, y_axis: str = None):
    """The mesh axis each dim of every state field is split over: 4-D
    (nens, nz, ny, nx) fields (ens, -, y, x), surface fields (nens, ny,
    nx) (ens, y, x), columns over ens only, scalars whole."""
    def spec(v):
        nd = getattr(v, "ndim", 0)
        if nd == 4:
            return (ENS_AXIS, None, y_axis, x_axis)
        if nd == 3:
            return (ENS_AXIS, y_axis, x_axis)
        return (ENS_AXIS,) + (None,) * (nd - 1) if nd else ()
    return {k: spec(v) for k, v in state.items()}


def _axes(mesh: Mesh, x_axis, y_axis):
    """(x sharded, y sharded) for the axis names a step is given."""
    for name in (x_axis, y_axis):
        if name not in (None, X_AXIS, Y_AXIS):
            raise ValueError(f"unknown mesh axis {name!r}")
    if mesh.n_x > 1 and x_axis != X_AXIS:
        raise ValueError(f"the mesh splits x {mesh.n_x} ways; pass "
                         f"x_axis={X_AXIS!r}")
    if mesh.n_y > 1 and y_axis != Y_AXIS:
        raise ValueError(f"the mesh splits y {mesh.n_y} ways; pass "
                         f"y_axis={Y_AXIS!r}")
    return x_axis is not None and mesh.n_x > 1, \
        y_axis is not None and mesh.n_y > 1


def _wrap(fn, mesh: Mesh, x: bool, y: bool):
    """fn inside the axis context; with no horizontal axis split (the
    ensemble only, or one rank) the context would make no collective,
    and fn runs as it is (pam_tpu's ``trivial`` fallback,
    sharded_step.py:58-62)."""
    if not (x or y):
        return fn

    def step(state):
        with comm.axis_ctx(mesh, x=x, y=y):
            return fn(state)
    return step


def sharded_crm_step(drv, mesh: Mesh, x_axis: str = X_AXIS,
                     y_axis: str = None):
    """``drv.crm_phys_step`` on this rank's block. Returns ``(step,
    place)``: ``place(state)`` cuts a global state to this rank's block on
    the mesh's device, and ``step`` advances such a block by one CRM
    physics step, exchanging with the other ranks. Every rank calls
    ``step`` the same number of times."""
    x, y = _axes(mesh, x_axis, y_axis)
    local = _rank_block(drv, mesh, drv.coupler.nens)

    def place(state):
        return shard_state(mesh, state)
    return _wrap(local.crm_phys_step, mesh, x, y), place


def sharded_dycore_step(dycore, mesh: Mesh, dt_phys: float,
                        x_axis: str = X_AXIS, y_axis: str = None):
    """The dycore's ``timestep(state, dt_phys)`` alone on this rank's
    block (a state cut with ``shard_state``)."""
    x, y = _axes(mesh, x_axis, y_axis)
    local = _rank_block(dycore, mesh, dycore.coupler.nens)
    return _wrap(lambda s: local.timestep(s, dt_phys), mesh, x, y)

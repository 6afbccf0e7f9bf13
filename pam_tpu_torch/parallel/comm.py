"""Communication primitives for spatially sharded stencils over
``torch.distributed`` (port of pam_tpu/parallel/comm.py).

The reference's halo exchange (dynamics/spam/src/core/exchange.h:190-631:
pack, host-staged MPI_Isend/Irecv/Waitall, unpack; with a single-process
periodic fast path at exchange.h:434) plays three roles here:

* ``proll`` / ``halo_pad`` -- periodic shifts and halos along a
  horizontal axis. With no axis context, or with that axis unsharded,
  they are ``torch.roll`` and a concatenation (the fast path). Inside
  :func:`axis_ctx` with the axis sharded over the mesh, the wrapped
  columns come from the ring neighbour by one point-to-point send and
  receive each (``isend``/``irecv``).
* ``psum_h`` / ``pmean_h`` / ``pmax_h`` / ``pmin_h`` -- horizontal
  reductions that finish with an ``all_reduce`` over the active x and y
  groups (the reference's MPI_(I)reduce, extrudedmodel.h:4824).
* ``transpose_to_x_local`` -- an ``all_to_all_single`` trading ensemble
  locality for a whole x extent.

The context holds the mesh (``parallel/mesh.py``) and which of its
horizontal axes the running step shards. Unlike pam_tpu's, which is read
while JAX traces, it is read at run time by every call. Each rank runs
the same sequence of calls, so the collectives pair up.

Transport is the mesh's backend: NCCL moves CUDA tensors card to card;
gloo moves host tensors, and a CUDA tensor's message is copied to the
host before the call and back after it (the reference's host-staged
exchange, exchange.h:190-263). The compute stays on the tensor's device.

``Mesh.counts`` counts the collectives of each kind made inside the
context: ``p2p`` one per ring shift (one send and one receive, as one
``ppermute`` of pam_tpu), ``all_reduce``, ``all_gather`` and
``all_to_all`` one per call. ``Mesh.bytes`` adds up their payloads by the
same kinds, numel times itemsize: the tensor a rank sends in each
message, the buffer it reduces, its part of a gather, the tensor it
trades in an all-to-all (the bytes of pam_tpu's tools/comm_volume.py,
which counts each collective's output, but for the gather).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

_tls = threading.local()


@dataclasses.dataclass(frozen=True)
class _AxisCtx:
    mesh: Any = None
    x: bool = False          # x is sharded over the mesh's x rows
    y: bool = False          # y is sharded over the mesh's y columns
    # set inside x_local(): x was transposed to be local, for slicing
    # per-ensemble tables (local_ens_xblock)
    transposed_x: bool = False


def _ctx() -> _AxisCtx:
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else _AxisCtx()


@contextlib.contextmanager
def axis_ctx(mesh=None, x: bool = False, y: bool = False):
    """Run the enclosed code with x (and/or y) sharded over ``mesh``. An
    axis of size 1 makes no collective."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = _AxisCtx(mesh=mesh, x=bool(x), y=bool(y))
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def x_local():
    """Mark x as local inside a transposed solve: rolls along x are local
    rolls, and ``local_ens_xblock`` slices per-ensemble tables to the x
    rank's ensemble block."""
    prev = getattr(_tls, "ctx", None)
    cur = _ctx()
    _tls.ctx = dataclasses.replace(cur, x=False, transposed_x=cur.x)
    try:
        yield
    finally:
        _tls.ctx = prev


def _active(kind: str):
    """The mesh if ``kind`` ("x"/"y") is sharded over more than one rank
    in the current context, else None."""
    ctx = _ctx()
    if ctx.mesh is None or not getattr(ctx, kind):
        return None
    return ctx.mesh if ctx.mesh.size(kind) > 1 else None


def sharded(kind: str) -> bool:
    """Whether the ``kind`` ("x"/"y") axis is split over several ranks."""
    return _active(kind) is not None


def x_shards() -> int:
    """Number of x shards in the active context (1 when inactive)."""
    mesh = _active("x")
    return 1 if mesh is None else mesh.n_x


def _kind_for(ax: int, kind: str):
    if kind is not None:
        return kind
    return {-1: "x", -2: "y"}.get(ax)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _ring_exchange(mesh, kind: str, sends):
    """For each (tensor, d) of ``sends``: send the tensor to the rank d
    steps up the ``kind`` ring and receive the same-shaped tensor from
    the rank d steps down. Returns the received tensors, in order. Every
    rank posts the same list, so NCCL pairs the calls by their order
    and gloo by their tags (with two shards both neighbours are one
    rank)."""
    import torch.distributed as dist
    n = mesh.size(kind)
    pos = mesh.coord(kind)
    ops, bufs, outs = [], [], []
    for tag, (t, d) in enumerate(sends):
        t = t.contiguous()
        src_t = t.cpu() if _staged(mesh, t) else t
        buf = torch.empty_like(src_t)
        dst = mesh.rank_along(kind, (pos + d) % n)
        src = mesh.rank_along(kind, (pos - d) % n)
        ops.append(dist.P2POp(dist.isend, src_t, dst, tag=tag))
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
        bufs.append((buf, t.device))
    if mesh.backend == "nccl":
        reqs = dist.batch_isend_irecv(ops)
    else:
        reqs = [op.op(op.tensor, op.peer, tag=op.tag) for op in ops]
    for r in reqs:
        r.wait()
    for buf, dev in bufs:
        outs.append(buf.to(dev) if buf.device != dev else buf)
    mesh.counts["p2p"] += len(sends)
    mesh.bytes["p2p"] += sum(t.numel() * t.element_size() for t, _ in sends)
    return outs


def _all_reduce(mesh, kind: str, v: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    shape = v.shape
    w = v.reshape(-1).contiguous()
    w = w.cpu() if _staged(mesh, w) else w.clone()
    dist.all_reduce(w, op=op, group=mesh.group(kind))
    mesh.counts["all_reduce"] += 1
    mesh.bytes["all_reduce"] += w.numel() * w.element_size()
    return w.to(v.device).reshape(shape)


# ---------------------------------------------------------------------------
# shifts and halos
# ---------------------------------------------------------------------------

def _sharded_roll(a, s: int, axis: int, mesh, kind: str):
    """result[i] = a[i + s] along a sharded periodic axis: the local shift
    plus the |s| wrapped columns from the ring neighbour (the message the
    reference packs in exchange.h:190-263)."""
    if s == 0:
        return a
    nloc = a.shape[axis]
    if abs(s) > nloc:
        raise ValueError(f"proll shift {s} exceeds the local extent {nloc} "
                         f"along {kind}; use fewer shards or halo_pad")
    if s > 0:
        # the next rank's first s columns go after my last nloc - s
        recv, = _ring_exchange(mesh, kind, [(a.narrow(axis, 0, s), -1)])
        return torch.cat([a.narrow(axis, s, nloc - s), recv], dim=axis)
    recv, = _ring_exchange(mesh, kind,
                           [(a.narrow(axis, nloc + s, -s), 1)])
    return torch.cat([recv, a.narrow(axis, 0, nloc + s)], dim=axis)


def proll(a: torch.Tensor, s: int, axis: int = -1,
          kind: str = None) -> torch.Tensor:
    """Periodic shift: result[i] = a[i + s] along ``axis`` (x by
    default). ``kind`` ("x"/"y") names the physical axis where it is not
    in its default place (-1 = x, -2 = y)."""
    nd = a.ndim
    ax = axis % nd - nd
    kind = _kind_for(ax, kind)
    mesh = _active(kind) if kind else None
    if mesh is None:
        return torch.roll(a, -s, dims=axis)
    return _sharded_roll(a, int(s), ax, mesh, kind)


def proll_y(a: torch.Tensor, s: int) -> torch.Tensor:
    """Periodic shift along the y axis (second to last)."""
    return proll(a, s, axis=-2)


def halo_pad(a: torch.Tensor, h: int, axis: int = -1,
             kind: str = None) -> torch.Tensor:
    """An h-wide periodic halo on each side of ``axis``: [0:h] = the left
    neighbour's last h entries, [-h:] = the right neighbour's first h;
    unsharded, the array's own. One exchange serves a whole stencil stage,
    one message per side. A halo wider than a shard is fetched hop by hop
    from the neighbours' neighbours."""
    nd = a.ndim
    ax = axis % nd - nd
    kind = _kind_for(ax, kind)
    mesh = _active(kind) if kind else None
    nloc = a.shape[ax]
    if mesh is None:
        if h > nloc:
            raise ValueError(f"halo_pad h={h} exceeds axis extent {nloc}")
        return torch.cat([a.narrow(ax, nloc - h, h), a, a.narrow(ax, 0, h)],
                         dim=ax)
    n = mesh.size(kind)
    if h <= nloc:
        from_left, from_right = _ring_exchange(
            mesh, kind, [(a.narrow(ax, nloc - h, h), 1),
                         (a.narrow(ax, 0, h), -1)])
        return torch.cat([from_left, a, from_right], dim=ax)
    # whole shards from the near hops, the remainder from the farthest
    hops = -(-h // nloc)
    if hops >= n:
        raise ValueError(f"halo_pad h={h} needs {hops} shards of {nloc} but "
                         f"{kind} has only {n}")
    w_far = h - (hops - 1) * nloc
    sends = []
    for d in range(1, hops + 1):
        sends.append((a.narrow(ax, nloc - w_far, w_far) if d == hops else a,
                      d))
        sends.append((a.narrow(ax, 0, w_far) if d == hops else a, -d))
    got = _ring_exchange(mesh, kind, sends)
    lparts, rparts = got[0::2], got[1::2]
    return torch.cat(lparts[::-1] + [a] + rparts, dim=ax)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _finish(v: torch.Tensor, op: str) -> torch.Tensor:
    """The collective over whichever horizontal axes are sharded, x then
    y (pam_tpu's order); ``v`` itself where neither is."""
    for kind in ("x", "y"):
        mesh = _active(kind)
        if mesh is not None:
            import torch.distributed as dist
            rop = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                   "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
            v = _all_reduce(mesh, kind, v, rop)
            if op == "mean":
                v = v / mesh.size(kind)
    return v


def psum_h(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the local ``axes``, then over the sharded horizontal
    axes."""
    return _finish(torch.sum(x, dim=axes), "sum")


def pmean_h(x: torch.Tensor, axes) -> torch.Tensor:
    """Mean over the local ``axes``, then the mean of the shards'
    means (every shard holds as many cells)."""
    return _finish(torch.mean(x, dim=axes), "mean")


def pmax_h(x: torch.Tensor, axes=None) -> torch.Tensor:
    v = torch.amax(x, dim=axes) if axes is not None else torch.max(x)
    return _finish(v, "max")


def pmin_h(x: torch.Tensor, axes=None) -> torch.Tensor:
    v = torch.amin(x, dim=axes) if axes is not None else torch.min(x)
    return _finish(v, "min")


# ---------------------------------------------------------------------------
# all_to_all transpose: x-sharded <-> x-local (ensemble split over x)
# ---------------------------------------------------------------------------

def _all_to_all(mesh, chunks):
    """all_to_all_single over the x group of a (n, ...) tensor whose
    chunk j goes to x rank j; returns the (n, ...) chunks received, the
    i-th from x rank i."""
    import torch.distributed as dist
    src = chunks.contiguous()
    dev = src.device
    if _staged(mesh, src):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group("x"))
    mesh.counts["all_to_all"] += 1
    mesh.bytes["all_to_all"] += src.numel() * src.element_size()
    return out.to(dev)


def transpose_to_x_local(a: torch.Tensor, ens_dim: int,
                         x_dim: int) -> torch.Tensor:
    """Re-lay an x-sharded array so that x is whole, splitting the
    ensemble dim over the x ranks instead: x rank p gets the p-th
    contiguous ensemble chunk of every x block, joined along x in
    order."""
    mesh = _active("x")
    if mesh is None:
        return a
    n = mesh.n_x
    ens_dim, x_dim = ens_dim % a.ndim, x_dim % a.ndim
    if a.shape[ens_dim] % n:
        raise ValueError(f"ensemble extent {a.shape[ens_dim]} not divisible "
                         f"by {n} x shards; choose nens so that each rank's "
                         "ensemble block splits over x")
    chunks = torch.stack(torch.chunk(a, n, dim=ens_dim))
    got = _all_to_all(mesh, chunks)
    return torch.cat(list(got), dim=x_dim)


def transpose_from_x_local(a: torch.Tensor, ens_dim: int,
                           x_dim: int) -> torch.Tensor:
    """Inverse of :func:`transpose_to_x_local`."""
    mesh = _active("x")
    if mesh is None:
        return a
    n = mesh.n_x
    ens_dim, x_dim = ens_dim % a.ndim, x_dim % a.ndim
    chunks = torch.stack(torch.chunk(a, n, dim=x_dim))
    got = _all_to_all(mesh, chunks)
    return torch.cat(list(got), dim=ens_dim)


def _local_slice(a, dim: int, kind: str):
    mesh = _active(kind)
    if mesh is None:
        return a
    n, c = mesh.size(kind), mesh.coord(kind)
    if a.shape[dim] % n:
        raise ValueError(f"{kind} extent {a.shape[dim]} not divisible by {n} "
                         f"{kind} shards")
    block = a.shape[dim] // n
    return a.narrow(dim, c * block, block)


def local_xslice(a, x_dim: int = -1):
    """This rank's x block of a table with the global x extent (a no-op
    with x unsharded)."""
    return _local_slice(a, x_dim, "x")


def local_yslice(a, y_dim: int = -2):
    """This rank's y block of a table with the global y extent (a no-op
    with y unsharded)."""
    return _local_slice(a, y_dim, "y")


def local_ens_xblock(table, ens_dim: int = 0):
    """Inside ``x_local()`` (after ``transpose_to_x_local``): this x
    rank's ensemble block of a table with a leading ensemble dim."""
    ctx = _ctx()
    if not ctx.transposed_x or ctx.mesh is None or ctx.mesh.n_x == 1:
        return table
    n = ctx.mesh.n_x
    if table.shape[ens_dim] % n:
        raise ValueError(f"ensemble extent {table.shape[ens_dim]} not "
                         f"divisible by {n} x shards")
    block = table.shape[ens_dim] // n
    return table.narrow(ens_dim, ctx.mesh.x * block, block)


def psum_x(v: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``v`` over the x ranks (the psum of pam_tpu's
    sharded DFT, ops/dft.py:110-120); ``v`` itself with x unsharded."""
    mesh = _active("x")
    if mesh is None:
        return v
    import torch.distributed as dist
    return _all_reduce(mesh, "x", v, dist.ReduceOp.SUM)

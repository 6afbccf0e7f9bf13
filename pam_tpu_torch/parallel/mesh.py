"""The rank mesh over ``torch.distributed`` (port of
pam_tpu/parallel/mesh.py).

The reference decomposes its domain over MPI ranks
(dynamics/spam/src/core/params.h:166-224, exchange.h); pam_tpu lays a
``jax.sharding.Mesh`` over its devices. Here one process is one rank and
holds its block of the state: rank r sits at (e, y, x) =
unravel(r, (n_ens, n_y, n_x)), row-major as pam_tpu lays out its devices
(mesh.py:24-35), so that ensemble blocks are contiguous. The ensemble
axis is pure data parallelism (no communication); x and y are split
into equal blocks and exchange halos (``parallel/comm.py``); z is never
split. Each rank makes the x-row and y-column groups of the mesh in the
same order. A mesh of one rank, or an axis of size 1, makes no
collective at all.

:func:`spawn_ranks` starts the ranks of a mesh as processes of one host,
for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any

import torch

ENS_AXIS = "ens"
X_AXIS = "x"
Y_AXIS = "y"


def per_member(axis: int, **kw):
    """A dataclass field holding one entry per ensemble member along
    ``axis`` (a tensor, an array, or a tuple of them; a table of one
    member serves them all): ``sharded_step.ens_block`` cuts it to a
    rank's members. ``kw`` go to ``dataclasses.field``."""
    return dataclasses.field(metadata={"ens_axis": axis}, **kw)


def _new_counts() -> dict:
    return {"p2p": 0, "all_reduce": 0, "all_gather": 0, "all_to_all": 0}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in an (ens, y, x) mesh of ``world`` ranks."""
    n_ens: int
    n_y: int
    n_x: int
    rank: int
    backend: str              # "nccl", "gloo" or "none" (one rank)
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=_new_counts)

    @property
    def world(self) -> int:
        return self.n_ens * self.n_y * self.n_x

    @property
    def e(self) -> int:
        return self.rank // (self.n_y * self.n_x)

    @property
    def y(self) -> int:
        return self.rank // self.n_x % self.n_y

    @property
    def x(self) -> int:
        return self.rank % self.n_x

    @property
    def shape(self) -> dict:
        return {ENS_AXIS: self.n_ens, Y_AXIS: self.n_y, X_AXIS: self.n_x}

    def size(self, kind: str) -> int:
        return self.shape[kind]

    def coord(self, kind: str) -> int:
        return {ENS_AXIS: self.e, Y_AXIS: self.y, X_AXIS: self.x}[kind]

    def rank_of(self, e: int, y: int, x: int) -> int:
        return (e * self.n_y + y) * self.n_x + x

    def rank_along(self, kind: str, pos: int) -> int:
        """The global rank at ``pos`` along ``kind`` in this rank's row."""
        c = {ENS_AXIS: self.e, Y_AXIS: self.y, X_AXIS: self.x}
        c[kind] = pos
        return self.rank_of(c[ENS_AXIS], c[Y_AXIS], c[X_AXIS])

    def group(self, kind: str):
        """This rank's x-row or y-column process group."""
        return self.groups[kind]

    def reset_counts(self):
        for k in self.counts:
            self.counts[k] = 0


def _backend_for(device: torch.device, world: int, existing: str = None):
    """The backend of ``world`` ranks computing on ``device``: NCCL where
    every rank owns a card, gloo otherwise. ``existing``, the backend of
    a process group the caller started, is checked instead: NCCL ranks
    that would share a card raise."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if existing is None:
        return "nccl" if device.type == "cuda" and cards >= world else "gloo"
    if existing == "nccl" and cards < world:
        raise ValueError(
            f"NCCL needs a card of its own for every rank: {world} ranks "
            f"share {cards} card(s) here. Start the process group with "
            "gloo (host-staged messages) or run one rank per card")
    return existing


def make_mesh(n_ens_shards: int = None, n_x_shards: int = 1,
              n_y_shards: int = 1, *, device="cuda",
              init_method: str = None, rank: int = None,
              world_size: int = None, timeout: float = 120.0) -> Mesh:
    """An (ens, y, x) mesh over this process's rank. Takes the process
    group if one is initialised, else initialises it from
    ``init_method`` / ``rank`` / ``world_size`` (a file:// or tcp://
    address, as ``torch.distributed.init_process_group`` takes them), then
    makes the row and column groups. One rank needs no process group.

    ``device``: where this rank computes; with "cuda" a rank takes card
    rank % cards. The backend is NCCL where every rank owns its own card,
    gloo otherwise; a group the caller started with NCCL on ranks that
    share a card raises."""
    import torch.distributed as dist
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        if world_size is None:
            world_size = (n_ens_shards or 1) * n_x_shards * n_y_shards
        world, rank = int(world_size), int(rank or 0)
    if n_ens_shards is None:
        n_ens_shards = world // (n_x_shards * n_y_shards)
    if n_ens_shards * n_y_shards * n_x_shards != world:
        raise ValueError(f"mesh (ens {n_ens_shards}, y {n_y_shards}, x "
                         f"{n_x_shards}) does not cover {world} ranks")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                               "is false; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world == 1:
        return Mesh(n_ens_shards, n_y_shards, n_x_shards, 0, "none", device)
    if dist.is_initialized():
        chosen = dist.get_backend()
        _backend_for(device, world, chosen)
    else:
        chosen = _backend_for(device, world)
        if init_method is None:
            raise ValueError("make_mesh needs init_method (file:// or tcp://"
                             "localhost:<port>) to start a process group")
        dist.init_process_group(chosen, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
    mesh = Mesh(n_ens_shards, n_y_shards, n_x_shards, rank, chosen, device)
    # every rank makes every group, in one order
    if n_x_shards > 1:
        for e in range(n_ens_shards):
            for y in range(n_y_shards):
                ranks = [mesh.rank_of(e, y, x) for x in range(n_x_shards)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[X_AXIS] = g
    if n_y_shards > 1:
        for e in range(n_ens_shards):
            for x in range(n_x_shards):
                ranks = [mesh.rank_of(e, y, x) for y in range(n_y_shards)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[Y_AXIS] = g
    return mesh


# ---------------------------------------------------------------------------
# state blocks
# ---------------------------------------------------------------------------

def _block(n: int, parts: int, i: int, what: str):
    if n % parts:
        raise ValueError(f"{what} extent {n} not divisible by {parts} shards")
    b = n // parts
    return i * b, b


def shard_state(mesh: Mesh, state: dict) -> dict:
    """This rank's block of a global coupler state (pam_tpu's
    ``state_sharding``, mesh.py:38-53): 4-D fields (nens, nz, ny, nx) are
    split (ens, -, y, x), surface fields (nens, ny, nx) (ens, y, x),
    columns (nens, ...) over ens only; scalars stay whole. The blocks go
    to the mesh's device."""
    out = {}
    for k, v in state.items():
        if v.ndim >= 1:
            o, b = _block(v.shape[0], mesh.n_ens, mesh.e, f"{k}: ensemble")
            v = v.narrow(0, o, b)
        if v.ndim in (3, 4):
            for ax, n, c, name in ((-2, mesh.n_y, mesh.y, "y"),
                                   (-1, mesh.n_x, mesh.x, "x")):
                o, b = _block(v.shape[ax], n, c, f"{k}: {name}")
                v = v.narrow(ax, o, b)
        out[k] = v.to(mesh.device).contiguous()
    return out


def gather_state(mesh: Mesh, local: dict) -> dict:
    """The global state assembled from every rank's block (for tests and
    output), on every rank. One ``all_gather`` a field."""
    if mesh.world == 1:
        return dict(local)
    import torch.distributed as dist
    out = {}
    for k in sorted(local):
        v = local[k].contiguous()
        dev = v.device
        w = v.cpu() if (mesh.backend == "gloo" and v.is_cuda) else v
        parts = [torch.empty_like(w) for _ in range(mesh.world)]
        dist.all_gather(parts, w)
        mesh.counts["all_gather"] += 1
        parts = [p.to(dev) for p in parts]
        if v.ndim == 0:
            out[k] = parts[0]
            continue
        if v.ndim not in (3, 4):
            out[k] = torch.cat([parts[mesh.rank_of(e, 0, 0)]
                                for e in range(mesh.n_ens)], dim=0)
            continue
        rows = [torch.cat([torch.cat([parts[mesh.rank_of(e, y, x)]
                                      for x in range(mesh.n_x)], dim=-1)
                           for y in range(mesh.n_y)], dim=-2)
                for e in range(mesh.n_ens)]
        out[k] = torch.cat(rows, dim=0)
    return out


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, init_method, args, results):
    torch.set_num_threads(1)    # the ranks of one host share its cores
    try:
        results.put(("ok", rank, fn(rank, world, init_method, *args)))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, args: tuple = (), timeout: float = 300.0,
                rendezvous_dir: str = None) -> list:
    """Run ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` fresh
    processes (spawned, one torch thread each) that meet at
    a rendezvous file in a new directory under ``rendezvous_dir`` (the
    system's temporary directory if None); returns their results in rank
    order. ``fn`` must be importable by name. A rank that raises, dies or
    outlives ``timeout`` seconds fails the call, and every rank still
    running is killed: a hang fails one call and never blocks the
    caller."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pam_rdzv_", dir=rendezvous_dir)
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, init, args, results))
             for r in range(nprocs)]
    got: dict[int, Any] = {}
    ok = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(got))}"
                                   f" still running after {timeout} s")
            try:
                kind, r, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {r} of {nprocs} failed:\n{payload}")
            got[r] = payload
        ok = True
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            if ok:
                p.join(30)
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(nprocs)]

"""Measured scaling of the port's sharded CRM step, with the collectives
a step by kind, counted and in bytes: the port's counterpart of
tools/measure_scaling.py and tools/comm_volume.py.

For each configuration of tools/measure_scaling.py:

  slab    SPAM+SI with Kessler at 64x1x50 (the benched physics, nens 8);
  3d      3-D SPAM+SI with Kessler at 16x16x24 over (ens, y, x), y whole
          (the SI step refuses a y split, as pam_tpu's does);
  p3shoc  SPAM+SI with P3+SHOC at 64x1x50 (the production physics);

(2 km spacing, dt 20 s, f64), it runs ``parallel/sharded_step.py::
sharded_crm_step`` on every mesh of 1, 2 and 4 x shards by 1, 2 and 4
ensemble shards that fits in ``--max-ranks`` ranks (4, at most the
host's cores), each rank a process (``parallel/mesh.py::spawn_ranks``,
one spawn for each number of ranks). After one untimed step, ``--steps``
steps (20) are timed; it reports per mesh:

- ms a step of each rank (CUDA events around the timed steps on the
  card, the host's clock on the CPU) and of all ranks together (the
  host's clock from a barrier before the steps to one after them), and
  the strong-scaling efficiency t(1 rank) / (ranks x t(together));
- collectives a step by kind (``Mesh.counts``) and their bytes a step
  (``Mesh.bytes``: the payload a rank sends or reduces), from rank 0.

Ranks take NCCL where each has a card of its own (``make_mesh``'s
choice), otherwise gloo, whose messages go through the host; then the
ranks share a card or the CPU and the times measure correctness, not
scaling (the JSON says so per mesh, as tools/measure_scaling.py says of
its virtual devices). ``--backend gloo`` takes gloo even where every
rank has a card: beside an NCCL run on the same cards it measures what
the host staging costs. PyTorch has no GSPMD, so the port runs pam_tpu's
modes 1 (unsharded) and 3 (explicit), and the JAX tool's GSPMD column has
no counterpart.

The JSON goes to stdout and, with ``--out PATH``, to that file only.

Usage (on a machine with one or more cards; ``--device cpu`` runs the
ranks on the CPU over gloo):

    python -m pam_tpu_torch.measure_scaling [--configs slab,3d,p3shoc]
        [--steps 20] [--out PATH] [--max-ranks 4] [--backend auto|gloo]
        [--nx N] [--nz N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .driver.mmf import setup_supercell_mmf
from .modules import gcm_forcing
from .parallel.mesh import make_mesh, spawn_ranks
from .parallel.sharded_step import sharded_crm_step
from .profile_step import cards, timed_steps

# tools/measure_scaling.py's configurations (build(), :53-67), the slab
# and P3+SHOC at the benched 50 levels
CONFIGS = {
    "slab": dict(nx=64, ny=1, nz=50, nens=8, micro="kessler", sgs="none"),
    "3d": dict(nx=16, ny=16, nz=24, nens=8, micro="kessler", sgs="none"),
    "p3shoc": dict(nx=64, ny=1, nz=50, nens=8, micro="p3", sgs="shoc"),
}
SHARDS = (1, 2, 4)
RANK_TIMEOUT = 900.0      # s, a spawn of ranks running every config
DTYPE = torch.float64
MODES = ("pam_tpu's modes 1 (unsharded, one rank) and 3 (explicit: a "
         "process a rank, halos point to point, horizontal reductions by "
         "all_reduce); PyTorch has no GSPMD, so mode 2, the gspmd_ms "
         "column of tools/measure_scaling.py, has no counterpart")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def config_kwargs(name: str, nx: int = None, nz: int = None) -> dict:
    """setup_supercell_mmf's arguments for a configuration; ``nx`` (also
    ny of the 3-D grid) and ``nz`` replace its own."""
    kw = dict(CONFIGS[name])
    if nx:
        kw["nx"] = nx
        if kw["ny"] > 1:
            kw["ny"] = nx
    kw["nz"] = nz or kw["nz"]
    return dict(kw, xlen=2000.0 * kw["nx"],
                ylen=2000.0 * (kw["ny"] if kw["ny"] > 1 else 32),
                zlen=20000.0, dt_gcm=80.0, dt_crm_phys=20.0, dycore="spam")


def meshes(max_ranks: int = None) -> list:
    """(ensemble shards, x shards) of every mesh of at most ``max_ranks``
    ranks (4, at most the host's cores)."""
    max_ranks = max_ranks or min(4, os.cpu_count() or 1)
    return [(e, x) for x in SHARDS for e in SHARDS if e * x <= max_ranks]


def _rank(rank, world, init, plan):
    """One rank: every configuration of ``plan`` on every mesh of
    ``world`` ranks in it; returns one record a (config, mesh)."""
    import torch.distributed as dist
    device = torch.device(plan["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world > 1 and plan["backend"] == "gloo":
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
    out = []
    for name in plan["configs"]:
        kw = config_kwargs(name, *plan["sizes"])
        drv, state = setup_supercell_mmf(**kw, dtype=DTYPE, device=device)
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv.coupler, state, drv.dt_gcm)
        for n_ens, n_x in plan["meshes"]:
            mesh = make_mesh(n_ens, n_x, device=device, init_method=init,
                             rank=rank, world_size=world)
            step, place = sharded_crm_step(drv, mesh)
            cuda = device.type == "cuda"
            st, _ = timed_steps(step, place(state), 1, cuda)
            if world > 1:
                dist.barrier()
            mesh.reset_counts()
            t0 = time.perf_counter()
            st, rank_ms = timed_steps(step, st, plan["steps"], cuda)
            if world > 1:
                dist.barrier()
            all_ms = (time.perf_counter() - t0) * 1e3 / plan["steps"]
            finite = all(bool(torch.isfinite(v).all()) for v in st.values()
                         if v.is_floating_point())
            out.append(dict(
                config=name, mesh=(n_ens, n_x), backend=mesh.backend,
                device=str(device), rank_ms=rank_ms, all_ms=all_ms,
                finite=finite,
                counts={k: v / plan["steps"] for k, v in mesh.counts.items()},
                bytes={k: v / plan["steps"] for k, v in mesh.bytes.items()}))
            del st
        del drv, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _sharing(backend: str, world: int, device: str, n_cards: int):
    """What the ranks of one mesh share, or None where each has a card
    and NCCL."""
    if backend in ("none", "nccl"):
        return None
    if device == "cpu":
        return ("the ranks share the host's CPU cores over gloo: the times "
                "measure correctness, not scaling")
    if world > n_cards:
        return (f"{world} ranks share {n_cards} card(s), messages staged "
                "through the host over gloo: the times measure correctness, "
                "not scaling")
    return ("a card a rank, messages staged through the host over gloo "
            "(--backend gloo): beside NCCL on the same cards, the cost of "
            "the staging")


def measure(configs=("slab", "3d", "p3shoc"), steps: int = 20,
            mesh_list=None, device="cuda", backend="auto",
            sizes=(None, None)) -> dict:
    """Run the configurations on the meshes (``mesh_list`` of (ensemble
    shards, x shards), ``meshes()`` by default) and return the report as
    a dict; ``sizes`` is config_kwargs's (nx, nz)."""
    device = torch.device(device)
    n_cards = 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_scaling: torch.cuda.is_available() "
                               "is false; pass --device cpu")
        from . import _cuda
        _cuda.build()          # once, before the ranks load the kernels
        n_cards = torch.cuda.device_count()
    if backend not in ("auto", "gloo"):
        raise ValueError(f"backend {backend!r}: auto or gloo")
    for c in configs:
        if c not in CONFIGS:
            raise ValueError(f"unknown config {c!r}; one of {list(CONFIGS)}")
    mesh_list = mesh_list or meshes()
    # the ranks import _rank by name: from this module under its own name,
    # also where it runs as __main__ (python -m)
    from .measure_scaling import _rank as rank_fn
    by_world = {}
    for e, x in mesh_list:
        by_world.setdefault(e * x, []).append((e, x))
    recs = {}
    for world, ms in sorted(by_world.items()):
        plan = dict(configs=list(configs), meshes=ms, steps=steps,
                    device=device.type, backend=backend, sizes=tuple(sizes))
        t0 = time.perf_counter()
        res = spawn_ranks(rank_fn, world, args=(plan,), timeout=RANK_TIMEOUT)
        log(f"{world} rank(s): meshes {ms}, {time.perf_counter() - t0:.1f} s")
        for r, recs_r in enumerate(res):
            for rec in recs_r:
                recs.setdefault((rec["config"], rec["mesh"]), []).append(rec)
    report = {
        "tool": "pam_tpu_torch.measure_scaling",
        "device": device.type, "cards": n_cards,
        "chip": "; ".join(cards()) if device.type == "cuda" else "cpu",
        "torch": torch.__version__, "steps": steps, "dtype": "float64",
        "backend_requested": backend, "modes": MODES,
        "bytes_note": ("bytes a step: numel x itemsize of the payload a "
                       "rank sends in each message, reduces in each "
                       "all_reduce, sends in an all_gather or trades in an "
                       "all_to_all (tools/comm_volume.py's bytes column)"),
        "configs": {}}
    for name in configs:
        rows = []
        base = None
        for e, x in mesh_list:
            per = recs[(name, (e, x))]
            r0 = per[0]
            if not all(p["finite"] for p in per):
                raise RuntimeError(f"{name} on (ens {e}, x {x}): "
                                   "non-finite state")
            all_ms = max(p["all_ms"] for p in per)
            if (e, x) == (1, 1):
                base = all_ms
            row = dict(ens_shards=e, x_shards=x, ranks=e * x,
                       backend=r0["backend"],
                       devices=[p["device"] for p in per],
                       ms_per_step_rank=[p["rank_ms"] for p in per],
                       ms_per_step_all=all_ms,
                       collectives_per_step=r0["counts"],
                       bytes_per_step=r0["bytes"])
            if base is not None:
                row["strong_eff"] = base / (e * x * all_ms)
            note = _sharing(r0["backend"], e * x, device.type, n_cards)
            if note:
                row["caveat"] = note
            rows.append(row)
            log(f"[{name}] ens {e} x {x} ({r0['backend']}): ms/step ranks "
                + ", ".join(f"{p['rank_ms']:.2f}" for p in per)
                + f", together {all_ms:.2f}; collectives/step "
                f"{r0['counts']}, bytes/step {r0['bytes']}")
        kw = config_kwargs(name, *sizes)
        report["configs"][name] = dict(
            grid=f"{kw['nx']}x{kw['ny']}x{kw['nz']}", nens=kw["nens"],
            micro=kw["micro"], sgs=kw["sgs"], meshes=rows)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="slab,3d,p3shoc")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write the JSON here (nothing else is "
                         "written)")
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="largest mesh (default 4, at most the host's "
                         "cores)")
    ap.add_argument("--backend", choices=("auto", "gloo"), default="auto")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nx", type=int, default=None,
                    help="cells along x (and y in 3d) of every config")
    ap.add_argument("--nz", type=int, default=None)
    args = ap.parse_args(argv)
    report = measure(configs=args.configs.split(","), steps=args.steps,
                     mesh_list=meshes(args.max_ranks), device=args.device,
                     backend=args.backend, sizes=(args.nx, args.nz))
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()

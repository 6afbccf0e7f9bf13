"""Benchmark of the port: supercell CRM throughput (gridpoint-steps per
second) on one CUDA card, the port's counterpart of the repository's
``bench.py``.

Builds the MMF configuration of inputs/input_pamc.yaml (65x1x50 cells
per CRM, 128 km x 64 km x 20 km, dt_gcm 900 s, dt_crm_phys 20 s, f32),
applies the GCM forcing tendencies once, and times the compiled CRM step,
as ``bench.py`` times ``jax.jit(drv.crm_phys_step)`` and the compiled
chunk step (bench.py:165, :181): ``MmfDriver._graphed_single``, the step
captured into one CUDA graph whose Kessler, P3 sedimentation and AWFL
loops run on the device (ops/graph.py). By default it runs ``bench.py``'s
six rows, in its order, and prints each row's JSON line on stdout as soon
as the row finishes:

  1. P3+SHOC on SPAM+SI at nens ``PAM_BENCH_NENS`` (128);
  2. P3+SHOC at ``PAM_BENCH_NENS_BIG`` (512);
  3. P3+SHOC at ``PAM_BENCH_NENS_BIG2`` (1024; 0 skips the row);
  4. Kessler at ``PAM_BENCH_NENS_BIG``;
  5. Kessler on the AWFL dycore at nens 128, ``PAM_BENCH_AWFL_STEPS``
     (10) steps a rep;
  6. the line of record, last: Kessler on SPAM+SI at nens 128.

Rows 2-4 run as ``bench.py`` runs them (bench.py:141-179): the driver is
built at ``driver/mmf.py::pick_ens_chunk(65, 1, 50, f32, nens)``, 128
members, the state at the row's ensemble (``state_only``) with its
forcing tendencies computed once by the chunk driver's coupler, and the
state is split once into chunks; a step replays the chunk driver's graph
for every chunk in turn (each chunk with its own Kessler rainsplit count,
so the trajectory is ``bench.py``'s), and the timing waits for the last
chunk. Their config strings end in ``,nens=<n>,ens_chunk=<chunk>``.

Setting any of ``PAM_BENCH_MICRO`` (kessler), ``PAM_BENCH_SGS`` (none)
or ``PAM_BENCH_DYCORE`` (spam) runs that one configuration instead, in
one program of ``PAM_BENCH_NENS`` members (so ``PAM_BENCH_MICRO=p3
PAM_BENCH_SGS=shoc PAM_BENCH_NENS=512`` is row 2 unchunked).
``PAM_BENCH_STEPS`` (60) steps a rep, ``PAM_BENCH_REPS`` (3) reps,
``PAM_BENCH_TRACE_STEPS`` (10) traced steps (0: no trace),
``PAM_BENCH_LINSYS`` (velocity), ``PAM_BENCH_TWOPOINT`` (1: the SI
step's exact two-point discrete gradient),
``PAM_BENCH_ENS_MICROBATCH`` (a chunk: the rows that pick no chunk run
the driver at it, chunked as above) and ``PAM_BENCH_KESSLER_CHUNK``
(``KesslerMicro.ens_chunk`` of the Kessler rows) keep ``bench.py``'s
meanings. There is no compilation cache.

Each row: the first step (``first_step_s``, which includes building the
CUDA kernels at their first use and capturing the graph, as ``bench.py``'s
first step includes compiling; ``capture_s`` is the capture alone: a
warm-up step and the capture), 3 warmup steps, then ``reps`` runs of
``steps`` steps, each timed with CUDA events around the whole run (a
replayed step reads nothing on the host). ``value`` derives from the best
rep; ``device_ms_per_step`` is the device time of a ``torch.profiler``
trace of ``trace_steps`` more steps, summed over the trace's device
events (``profile_step.py::device_totals``; CUPTI reports the kernels a
graph replay launches, the csrc kernels among them, but can leave out
those of a WHILE node's body: where the trace's launches of the csrc
kernels differ from their counters the row's device ms is null and
stderr says so);
``peak_mib`` is ``torch.cuda.max_memory_allocated`` over the row;
``chip`` the card's name and power limit from nvidia-smi; ``capture_s``
null where nothing was captured (a CPU run). A non-finite final state
exits 1. The spread of the reps goes to stderr with the other log lines.

The eager step, which reads the trip counts on the host (Kessler's
rainsplit, P3's sedimentation rounds, AWFL's sub-cycle count) and
launches every kernel from Python, stays reachable through the API
(``drv.crm_phys_step``) and ``profile_step``.

The route runs on the card; ``PAM_BENCH_DEVICE=cpu`` or ``--device cpu``
runs it on the CPU (for tests: the plain versions of the kernels, times
of the host's clock, ``device_ms_per_step`` and ``peak_mib`` null,
``chip`` "cpu"). With no card and no such request it raises.

Usage (on a machine with the card):

    python -m pam_tpu_torch.bench
    PAM_BENCH_MICRO=p3 PAM_BENCH_SGS=shoc python -m pam_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ._cuda import KERNELS
from .driver.mmf import _split_ens, pick_ens_chunk, setup_supercell_mmf
from .modules import gcm_forcing
from .profile_step import cards, device_totals, own_launches, timed_steps

# inputs/input_pamc.yaml's CRM and bench.py's arguments (bench.py:142-148)
GRID = dict(nx=65, ny=1, nz=50, xlen=128000.0, ylen=64000.0, zlen=20000.0,
            dt_gcm=900.0, dt_crm_phys=20.0)
DTYPE = torch.float32
WARMUP = 3
METRIC = "supercell CRM grid-points*steps/s per chip"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _int_or_none(text):
    return int(text) if text else None


@dataclasses.dataclass(frozen=True)
class Settings:
    """The route's knobs, under bench.py's environment names."""
    nens: int = 128
    steps: int = 60
    reps: int = 3
    trace_steps: int = 10
    linsys: str = "velocity"
    two_point: bool = False
    dycore: str = "spam"
    nens_big: int = 512
    nens_big2: int = 1024
    awfl_steps: int = 10
    ens_microbatch: int = None    # the driver's chunk of a row with none
    kessler_chunk: int = None     # KesslerMicro.ens_chunk
    single: tuple = None      # (micro, sgs) of a single-config run
    device: str = "cuda"

    @classmethod
    def from_env(cls, env, device: str = None) -> "Settings":
        single = None
        if any(k in env for k in ("PAM_BENCH_MICRO", "PAM_BENCH_SGS",
                                  "PAM_BENCH_DYCORE")):
            single = (env.get("PAM_BENCH_MICRO", "kessler"),
                      env.get("PAM_BENCH_SGS", "none"))
        return cls(nens=int(env.get("PAM_BENCH_NENS", "128")),
                   steps=int(env.get("PAM_BENCH_STEPS", "60")),
                   reps=max(1, int(env.get("PAM_BENCH_REPS", "3"))),
                   trace_steps=int(env.get("PAM_BENCH_TRACE_STEPS", "10")),
                   linsys=env.get("PAM_BENCH_LINSYS", "velocity"),
                   two_point=env.get("PAM_BENCH_TWOPOINT", "0") == "1",
                   dycore=env.get("PAM_BENCH_DYCORE", "spam"),
                   nens_big=int(env.get("PAM_BENCH_NENS_BIG", "512")),
                   nens_big2=int(env.get("PAM_BENCH_NENS_BIG2", "1024")),
                   awfl_steps=int(env.get("PAM_BENCH_AWFL_STEPS", "10")),
                   ens_microbatch=_int_or_none(
                       env.get("PAM_BENCH_ENS_MICROBATCH")),
                   kessler_chunk=_int_or_none(
                       env.get("PAM_BENCH_KESSLER_CHUNK")),
                   single=single,
                   device=device or env.get("PAM_BENCH_DEVICE", "cuda"))


@dataclasses.dataclass(frozen=True)
class Row:
    micro: str
    sgs: str
    nens: int
    dycore: str
    steps: int
    extra: str = ""           # appended to the config string
    chunk: int = None         # the driver's ensemble, if not nens

    @property
    def config(self) -> str:
        return (f"micro={self.micro},sgs={self.sgs},dycore={self.dycore}"
                + self.extra)


def rows(s: Settings) -> list:
    """The rows a run measures, in bench.py's order; the last is the line
    of record."""
    if s.single is not None:
        return [Row(*s.single, s.nens, s.dycore, s.steps)]

    def chunked(micro, sgs, nens):
        ck = pick_ens_chunk(GRID["nx"], GRID["ny"], GRID["nz"], DTYPE, nens)
        return Row(micro, sgs, nens, "spam", s.steps,
                   f",nens={nens},ens_chunk={ck}", ck)
    big = [chunked("p3", "shoc", s.nens_big)]
    if s.nens_big2:
        big.append(chunked("p3", "shoc", s.nens_big2))
    return ([Row("p3", "shoc", s.nens, "spam", s.steps)] + big +
            [chunked("kessler", "none", s.nens_big),
             Row("kessler", "none", s.nens, "awfl", s.awfl_steps),
             Row("kessler", "none", s.nens, "spam", s.steps)])


def setup_config(micro: str, sgs: str, nens: int, dycore: str = "spam",
                 linsys: str = "velocity", two_point: bool = False,
                 device="cuda", drv_nens: int = None, micro_kwargs=None):
    """bench.py's configuration (bench.py:142-165) built by the port, with
    the GCM forcing tendencies applied once: (driver, state). With
    ``drv_nens`` below nens the driver is built at drv_nens and the state
    (``state_only``) at nens, its tendencies from the chunk driver's
    coupler."""
    kw = dict(GRID, micro=micro, sgs=sgs, dycore=dycore, dtype=DTYPE,
              device=device,
              dycore_kwargs=({"linear_system": linsys,
                              "si_two_point": two_point}
                             if dycore == "spam" else None))
    drv, state = setup_supercell_mmf(
        **kw, nens=drv_nens or nens,
        micro_kwargs=micro_kwargs if micro == "kessler" else None)
    if drv_nens and drv_nens != nens:
        _, state = setup_supercell_mmf(**kw, nens=nens, state_only=True)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    return drv, state


def device_ms_per_step(step, state, nsteps: int):
    """Device ms a step of a torch.profiler trace of ``nsteps`` steps,
    summed over the trace's device events (profile_step.py::
    device_totals); returns (state, ms). The ms is None, and says so on
    stderr, where the trace's launches of the package's kernels differ
    from their counters (CUPTI can leave out kernels that a graph runs in
    a WHILE node's body: a sum without them is not the step's)."""
    counters = {k.key: k.launcher_fn() for k in KERNELS}
    before = {k: int(f.launches) for k, f in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(nsteps):
            state = step(state)
        torch.cuda.synchronize()
    counted = {k: int(f.launches) - before[k] for k, f in counters.items()}
    traced = own_launches(prof)
    if traced != counted:
        log(f"device ms not measured: the trace holds {traced} launches "
            f"of the package's kernels, their counters {counted}")
        return state, None
    return state, device_totals(prof, nsteps)[1]


def run_row(s: Settings, row: Row, chip: str) -> dict:
    """Measure one row; returns its JSON record."""
    cuda = torch.device(s.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv_nens = row.chunk or s.ens_microbatch or row.nens
    drv, state = setup_config(
        row.micro, row.sgs, row.nens, row.dycore, s.linsys, s.two_point,
        s.device, drv_nens,
        {"ens_chunk": s.kessler_chunk} if s.kessler_chunk else None)
    # the compiled step; on the CPU the eager step
    graphed = drv._graphed_single()
    if drv_nens != row.nens:
        # split once; a step runs every chunk through the chunk driver in
        # turn (bench.py:151-176)
        state = list(_split_ens(state, drv.n_chunks(state)))

        def step(chunks):
            return drv.step_chunks(chunks, graphed)
    else:
        step = graphed
    t0 = time.perf_counter()
    state, _ = timed_steps(step, state, 1, cuda)
    first_s = time.perf_counter() - t0
    tag = (f"[{row.micro}+{row.sgs} {row.dycore} nens {row.nens} driver "
           f"{drv_nens}]")
    log(f"{tag} first step: {first_s:.2f} s")
    state, _ = timed_steps(step, state, WARMUP, cuda)
    ms_reps = []
    for _ in range(s.reps):
        state, ms = timed_steps(step, state, row.steps, cuda)
        ms_reps.append(ms)
    graphed.check()
    parts = state if drv_nens != row.nens else (state,)
    bad = sorted({k for part in parts for k, v in part.items()
                  if v.is_floating_point()
                  and not bool(torch.isfinite(v).all())})
    if bad:
        log(f"ERROR: non-finite state after the {row.config} row: {bad}")
        sys.exit(1)
    dev_ms = None
    if cuda and s.trace_steps > 0:
        state, dev_ms = device_ms_per_step(step, state, s.trace_steps)
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
    captures = [g.capture_s for g in graphed.graphs.values()]
    capture_s = sum(captures) if captures else None
    best, med = min(ms_reps), statistics.median(ms_reps)
    log(f"{tag} reps (ms/step) "
        f"{['%.3f' % m for m in ms_reps]} best {best:.3f} median {med:.3f} "
        f"spread {max(ms_reps) - best:.3f} "
        f"({100 * (max(ms_reps) / best - 1):.1f}% of best); device "
        f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms/step; peak "
        f"{peak if peak is None else round(peak, 1)} MiB")
    # the driver and its graph (static inputs and outputs, private pool)
    # go before the next row, whose peak would count them
    del drv, state, step, graphed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gridpoints = GRID["nx"] * GRID["ny"] * GRID["nz"] * row.nens
    return {
        "metric": METRIC,
        "value": gridpoints / best * 1e3,
        "unit": "gridpoint-steps/s",
        "config": row.config,
        "ms_per_step": best,
        "ms_per_step_median": med,
        "reps": s.reps,
        "device_ms_per_step": dev_ms,
        "first_step_s": first_s,
        "peak_mib": peak,
        "chip": chip,
        "capture_s": capture_s,
    }


def run(s: Settings, out=None) -> list:
    """Measure every row of ``s``, printing each record to ``out``
    (stdout) as its row finishes; returns the records."""
    out = out or sys.stdout
    if torch.device(s.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pam_tpu_torch.bench: torch.cuda.is_available() is false; "
                "set PAM_BENCH_DEVICE=cpu (or --device cpu) to run on the "
                "CPU")
        chip = cards()[0]
        log(f"device: {torch.cuda.get_device_name(0)} ({chip}), torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
    else:
        chip = "cpu"
        log(f"device: cpu, {torch.get_num_threads()} threads, torch "
            f"{torch.__version__}")
    records = []
    for row in rows(s):
        rec = run_row(s, row, chip)
        print(json.dumps(rec), file=out, flush=True)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default PAM_BENCH_DEVICE, else "
                         "cuda)")
    args = ap.parse_args(argv)
    run(Settings.from_env(os.environ, args.device))


if __name__ == "__main__":
    main()

"""Where the time of one CRM physics step goes on a CUDA card.

Builds the MMF configuration of inputs/input_pamc.yaml (65x1x50 cells,
128 km x 64 km x 20 km, dt 20 s) with the SPAM+SI dycore or the AWFL
dycore (``--dycore awfl``, PAM-A), with Kessler microphysics or with P3
and SHOC (``--micro p3 --sgs shoc``, the production physics), as
chip_smoke.py does, or with ``--grid3d`` the coupled 3-D grid of
chip_smoke.py's phase 15c (32x32x50 cells, 64 km x 64 km x 20 km: 3-D
SPAM with the pressure-gravity SI system), runs warmup steps, times steps without the profiler
(CUDA events), then traces steps with torch.profiler and prints, per
step:

- the number of device kernels and their summed device time;
- the device busy share of the traced window: the union of the device
  intervals (kernels, copies, sets) over the span from the first to the
  last of them;
- device and host time of each labelled layer (the ``pam:`` spans of
  ``MmfDriver``, ``si_step`` and ``AwflDycore``: ``pam:awfl.tendencies``
  and, inside it, ``pam:awfl.flux_x``, ``flux_z`` and ``fct``); host
  times are inflated by the profiler, device times are not; for AWFL
  also the sub-cycles per step;
- the package's own CUDA kernels (csrc/*.cu): they are launched through
  ctypes, so the profiler does not attribute their device time to the
  span that encloses the launch, and the layer rows above leave it out;
- the kernels that take the most device time.

Usage (on a machine with the card):

    python -m pam_tpu_torch.profile_step [--nens 128] [--dtype f32]
        [--micro kessler|p3] [--sgs none|shoc] [--dycore spam|awfl]
        [--grid3d]
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .driver.mmf import setup_supercell_mmf
from .dycore.awfl import AwflDycore
from .modules import gcm_forcing

FULL = dict(nx=65, ny=1, nz=50, xlen=128000.0, ylen=64000.0, zlen=20000.0,
            dt_gcm=900.0, dt_crm_phys=20.0)
FULL3D = dict(FULL, nx=32, ny=32, xlen=64000.0, ylen=64000.0)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
WARMUP, STEPS, TOP = 3, 5, 12
OWN_KERNELS = ("weno_x_kernel", "p3_part2_kernel", "awfl_flux_kernel")


def cards() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()


def timed_steps(step, state, nsteps: int, cuda: bool = True):
    """``nsteps`` steps; returns (state, ms a step): CUDA events around
    the whole run on the card (one synchronisation, at the end; the steps
    may sync with the host inside), the host's clock on the CPU."""
    if cuda:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        h0 = time.perf_counter()
    for _ in range(nsteps):
        state = step(state)
    if cuda:
        t1.record()
        t1.synchronize()
        return state, t0.elapsed_time(t1) / nsteps
    return state, (time.perf_counter() - h0) * 1e3 / nsteps


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_us(evt):
    """Device time of the kernels a host event (and its children)
    launched."""
    t = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if t is None else t


def device_totals(prof, nsteps):
    """(device launches, device ms) a step of a torch.profiler trace, the
    ``kernels_per_step`` and ``device_ms_per_step`` of :func:`analyse`:
    summed over the trace's raw events without building its per-event
    records (which take seconds for a trace of tens of thousands of
    launches)."""
    n = ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and \
                not e.name().startswith("pam:"):
            n += 1
            ns += e.duration_ns()
    return n / nsteps, ns / nsteps / 1e6


def own_launches(prof) -> dict:
    """Launches of each of the package's kernels (``OWN_KERNELS``) in a
    torch.profiler trace, by name."""
    n = dict.fromkeys(OWN_KERNELS, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            for k in OWN_KERNELS:
                n[k] += k in e.name()
    return n


def analyse(prof, nsteps):
    """Per-step summary of a torch.profiler trace (see the module
    docstring)."""
    kernels, device_ms = device_totals(prof, nsteps)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("pam:")]
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = union_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    layers = collections.defaultdict(lambda: [0.0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("pam:"):
            layers[e.name][0] += device_us(e)
            layers[e.name][1] += e.cpu_time_total
    return {
        "kernels_per_step": kernels,
        "device_ms_per_step": device_ms,
        "traced_window_ms_per_step": span / nsteps / 1e3,
        "busy_share": busy / span,
        "layers": {k: (d / nsteps / 1e3, h / nsteps / 1e3)
                   for k, (d, h) in layers.items()},
        "top": sorted(by_name.items(), key=lambda kv: -kv[1][1]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nens", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--micro", choices=("kessler", "p3"), default="kessler")
    ap.add_argument("--sgs", choices=("none", "shoc"), default="none")
    ap.add_argument("--dycore", choices=("spam", "awfl"), default="spam")
    ap.add_argument("--grid3d", action="store_true",
                    help="the 32x32x50 grid of chip_smoke.py phase 15c")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is false")
    print(cards()[0])

    drv, state = setup_supercell_mmf(nens=args.nens,
                                     dtype=DTYPES[args.dtype],
                                     device="cuda", micro=args.micro,
                                     sgs=args.sgs, dycore=args.dycore,
                                     **(FULL3D if args.grid3d else FULL))
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    for _ in range(WARMUP):
        state = drv.crm_phys_step(state)
    cycles = AwflDycore.timestep.cycles
    state, ms = timed_steps(drv.crm_phys_step, state, STEPS)
    print(f"{args.dycore} {args.micro}+{args.sgs} "
          f"{'32x32x50 ' if args.grid3d else ''}nens {args.nens} "
          f"{args.dtype}, unprofiled {STEPS} steps: "
          f"ms/step (CUDA events) {ms:.3f}")
    if args.dycore == "awfl":
        print(f"AWFL sub-cycles per step: "
              f"{(AwflDycore.timestep.cycles - cycles) / STEPS:.1f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            state = drv.crm_phys_step(state)
        torch.cuda.synchronize()
    r = analyse(prof, STEPS)
    print(f"traced {STEPS} steps: {r['kernels_per_step']:.0f} device "
          f"ops/step, device time {r['device_ms_per_step']:.3f} ms/step in "
          f"a window of {r['traced_window_ms_per_step']:.3f} ms/step, "
          f"busy share {100 * r['busy_share']:.1f}%")
    print("layer: device ms/step, host ms/step (profiled)")
    for name, (d, h) in sorted(r["layers"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:28s} {d:9.3f} {h:9.3f}")
    print("csrc kernels (not in the layer rows): calls/step, ms/step, name")
    for name, (n, us) in r["top"]:
        own = [k for k in OWN_KERNELS if k in name]
        if own:
            print(f"  {n / STEPS:7.1f} {us / STEPS / 1e3:8.3f}  "
                  f"{name[name.index(own[0]):][:60]}")
    print(f"top {TOP} device ops: calls/step, ms/step, name")
    for name, (n, us) in r["top"][:TOP]:
        print(f"  {n / STEPS:7.1f} {us / STEPS / 1e3:8.3f}  "
              f"{name[:100]}")


if __name__ == "__main__":
    main()

"""Smoke run of pam_tpu_torch on one CUDA card (an H100): build the CUDA
kernel, hold it against its plain version, reproduce the golden
trajectory through it, and run the MMF CRM step at the production width
of inputs/input_pamc.yaml (65x1x50 cells, 128 km x 64 km x 20 km).

Usage (from the root of a checkout, on a machine with the card):

    python3 chip_smoke.py

Each phase prints one line. The line before the last is the kernels'
JSON record, the last line {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is then not 0 and no result is printed.
Needs no network and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
WATER = ("water_vapor", "cloud_liquid", "precip_liquid")
FULL = dict(nx=65, ny=1, nz=50, xlen=128000.0, ylen=64000.0, zlen=20000.0,
            dt_gcm=900.0, dt_crm_phys=20.0, dycore="spam", micro="kessler")
# x-WENO calls per CRM step: densities and PV, in compute_rhs and in the
# two quasi-Newton evaluations of one SI step
WENO_CALLS_PER_STEP = 6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def field(rows, nx, dtype, seed):
    """Smooth waves plus jumps, so the limiter's weights move."""
    rng = np.random.default_rng(seed)
    x = np.arange(nx) / nx
    f = np.sin(2 * np.pi * (x[None, :] + rng.random((rows, 1))))
    f += np.where(rng.random((rows, nx)) < 0.15,
                  rng.standard_normal((rows, nx)), 0.0)
    return torch.as_tensor(f, dtype=dtype, device="cuda")


def ptxas_summary(log):
    """Registers and spills per kernel instantiation from nvcc -Xptxas -v."""
    out, name = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = "f64" if "IdE" in ln else "f32" if "IfE" in ln else "?"
        elif "spill" in ln or "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return " | ".join(out)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn on the card, after a warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(weno, weno_x):
    """Kernel vs plain at the main path's shapes, f32 and f64."""
    errs, timing = {}, {}
    for dtype in (torch.float32, torch.float64):
        tb = weno.weno_tables(5, dtype)
        for rows, nx in ((32000, 65), (6272, 65), (37, 16)):
            f = field(rows, nx, dtype, seed=rows)
            got = weno_x.weno_edges_x_cuda(f, tb)
            torch.cuda.synchronize()
            ref = weno_x.weno_edges_x_reference(f, tb)
            for r, g in zip(ref, got):
                abs_err = float((r - g).abs().max())
                rel = abs_err / max(float(r.abs().max()), 1e-300)
                check(rel < TOL[dtype], f"kernel vs plain {dtype} "
                      f"({rows},{nx}): rel err {rel:.3e}")
                key = (str(dtype).split(".")[-1], rows, nx)
                errs[key] = max(errs.get(key, 0.0), abs_err)
            if rows == 32000:
                timing[str(dtype).split(".")[-1]] = (
                    cuda_ms(lambda: weno_x.weno_edges_x_cuda(f, tb), 200),
                    cuda_ms(lambda: weno_x.weno_edges_x_reference(f, tb),
                            20))
    return errs, timing


def run_steps(drv, state, nsteps):
    """nsteps CRM steps; returns (state, per-step ms by CUDA events,
    host-clock ms/step)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(nsteps + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(nsteps):
        state = drv.crm_phys_step(state)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / nsteps
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(nsteps)]
    return state, ms, wall


def healthy(state, tag):
    for k, v in state.items():
        check(bool(torch.isfinite(v).all()), f"{tag}: {k} not finite")
    t = state["temp"]
    check(150.0 <= float(t.min()) and float(t.max()) <= 350.0,
          f"{tag}: temp outside [150, 350] K")
    for k in WATER:
        check(float(state[k].min()) >= 0.0, f"{tag}: {k} negative")
    wmax = float(state["wvel"].abs().max())
    check(0.0 < wmax < 50.0, f"{tag}: |wvel| max {wmax}")
    return wmax


def main():
    # 1. environment: a card and the package, before anything is printed
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    from pam_tpu_torch.ops import weno, weno_x
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build from pam_tpu_torch/csrc alone
    build = _cuda.build()
    _cuda.library()
    print(f"phase 2 build: {build.seconds:.2f} s {build.path.name}; "
          f"{ptxas_summary(build.log)}", flush=True)

    # 3. kernel vs plain on the card
    errs, timing = phase_kernel(weno, weno_x)
    print("phase 3 kernel vs plain: max abs err " +
          ", ".join(f"{d}{(r, n)} {e:.3e}" for (d, r, n), e in errs.items()) +
          "; (32000,65) us/call kernel/plain " +
          ", ".join(f"{d} {k * 1e3:.2f}/{p * 1e3:.2f}"
                    for d, (k, p) in timing.items()), flush=True)

    # 4. golden trajectory on the card, f64, through the kernel
    drv, _ = setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0, dtype=torch.float64,
        device="cuda")
    init = dict(np.load(os.path.join(GOLDEN, "kessler_spam_si_init.npz")))
    state = state_from_numpy(init, "cuda", torch.float64)
    weno_x.weno_edges_x_cuda.launches = 0
    for _ in range(10):
        state = drv.crm_phys_step(state)
    check(weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP,
          "golden run did not go through the kernel")
    golden = np.load(os.path.join(GOLDEN, "kessler_spam_si.npz"))
    gerr = {}
    for k in golden.files:
        a, b = golden[k], state[k].cpu().numpy()
        gerr[k] = float(np.abs(a - b).max()) / max(float(np.abs(a).max()),
                                                   1e-300)
        check(gerr[k] < 1e-9, f"golden {k}: rel err {gerr[k]:.3e}")
    print("phase 4 golden f64 10 steps: max rel err " +
          ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()), flush=True)

    # 5. full width: nens 128 f32 for one GCM step (the main path), then
    #    nens 1024 f32 and nens 128 f64
    main_launches = None
    for nens, dtype, nsteps in ((128, torch.float32, 45),
                                (1024, torch.float32, 5),
                                (128, torch.float64, 5)):
        tag = f"nens {nens} {str(dtype).split('.')[-1]}"
        t0 = time.perf_counter()
        drv, state = setup_supercell_mmf(nens=nens, dtype=dtype,
                                         device="cuda", **FULL)
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv.coupler, state, drv.dt_gcm)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        weno_x.weno_edges_x_cuda.launches = 0
        state, ms, wall = run_steps(drv, state, nsteps)
        launches = weno_x.weno_edges_x_cuda.launches
        check(launches == nsteps * WENO_CALLS_PER_STEP,
              f"{tag}: {launches} kernel launches in {nsteps} steps")
        if main_launches is None:
            main_launches = launches
        wmax = healthy(state, tag)
        steady = ms[1:]
        print(f"phase 5 {tag}: {nsteps} steps, ms/step (CUDA events) "
              f"first {ms[0]:.2f} steady mean {np.mean(steady):.2f} "
              f"median {np.median(steady):.2f}, host {wall:.2f} ms/step, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
              f", setup {setup_s:.1f} s, |w|max {wmax:.3f} m/s, "
              f"launches {launches}", flush=True)
        del drv, state

    k32, p32 = timing["float32"]
    print(json.dumps({"kernels": [{
        "name": "weno_x", "route": "cuda",
        "source": "pam_tpu_torch/csrc/weno_x.cu",
        "replaces": "pam_tpu/ops/weno_x_pallas.py:46",
        "launches": main_launches,
        "max_abs_err": max(errs.values()),
        "ms": k32, "plain_ms": p32}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

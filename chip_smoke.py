"""Smoke run of pam_tpu_torch on one CUDA card (an H100): build the CUDA
kernels, hold each against its plain version, reproduce the golden
trajectories through them, and run the MMF CRM step at the production
width of inputs/input_pamc.yaml (65x1x50 cells, 128 km x 64 km x 20 km),
with Kessler microphysics and with the production P3+SHOC physics.

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
P3_WATER = ("water_vapor", "cloud_water", "cloud_water_num", "rain",
            "rain_num", "ice", "ice_num", "ice_rime", "ice_rime_vol", "tke")
FULL = dict(nx=65, ny=1, nz=50, xlen=128000.0, ylen=64000.0, zlen=20000.0,
            dt_gcm=900.0, dt_crm_phys=20.0, dycore="spam", micro="kessler")
GOLDEN_KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
                 zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0)
# B4 kernel vs plain, per output field, relative to the field's largest
# |value| (see phase_b4)
B4_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# P3+SHOC: every field within 1e-9 of pam_tpu's own run of the 10 golden
# steps op by op (tests/golden/p3_shoc_spam_si_opbyop.npz), and of the
# golden file (one fused XLA program's rounding, which rain evaporation's
# qv - qv_prev cancellation amplifies) at 1e-9, except where that
# op-by-op run lies further from it: there 10x its distance
# (tests/test_torch_mmf.py::P3_GOLDEN_TOL)
P3_GOLDEN_TOL = {"wvel": 1e-7, "cloud_water": 5e-9, "rain": 1.1e-5,
                 "ice": 0.3}
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
            name = ("p3_part2" if "p3_part2" in ln else "weno_x") + "/" + (
                "f64" if "IdE" in ln else "f32" if "IfE" in ln else "?")
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


def b4_beyond(ref, got, tol):
    """{field: (points with |got - ref| > tol * max|ref|, max abs err)}."""
    out = {}
    for k, r in ref.items():
        check(bool(torch.isfinite(got[k]).all()), f"B4: {k} not finite")
        d = (r - got[k]).abs()
        scale = max(float(r.abs().max()), 1e-300)
        out[k] = (int((d > tol * scale).sum()), float(d.max()))
    return out


def phase_b4(p3_part2):
    """B4 kernel vs plain at the main path's shape and a ragged size, f64
    and f32; returns ({(dtype, shape): (max abs err kernel vs plain,
    points beyond the tolerance)}, {dtype: (kernel ms, plain ms)} at
    (50, 65, 128)). f64: every field within 1e-12 of its largest |value|.
    f32: both the kernel and the plain version are held against the plain
    version in f64 on the same (rounded) inputs, at 1e-5; where a limiter
    drains a species to rounding noise, the final q < QSMALL clip goes
    either way in f32 and the number/rime fields differ there, so the
    kernel may have no more such points than 2x the plain version's
    (+10)."""
    errs, timing = {}, {}
    for dtype in (torch.float64, torch.float32):
        for shape in ((50, 65, 128), (1000003,)):
            args64 = p3_part2.sample_inputs(shape, torch.float64, "cuda",
                                            seed=11)
            args = p3_part2.cast_inputs(args64, dtype)
            got = p3_part2.outputs(*p3_part2.p3_part2_cuda(*args))
            torch.cuda.synchronize()
            ref = p3_part2.outputs(*p3_part2.p3_part2_reference(*args))
            vs_plain = b4_beyond(ref, got, B4_TOL[dtype])
            if dtype == torch.float64:
                bad = {k: v for k, v in vs_plain.items() if v[0]}
                check(not bad, f"B4 kernel vs plain f64 {shape}: {bad}")
            else:
                truth = p3_part2.outputs(*p3_part2.p3_part2_reference(
                    *p3_part2.cast_inputs(args, torch.float64)))
                truth = {k: v.to(dtype) for k, v in truth.items()}
                k_bad = b4_beyond(truth, got, B4_TOL[dtype])
                p_bad = b4_beyond(truth, ref, B4_TOL[dtype])
                for k in truth:
                    check(k_bad[k][0] <= 2 * p_bad[k][0] + 10,
                          f"B4 f32 {shape} {k}: kernel {k_bad[k][0]} vs "
                          f"plain {p_bad[k][0]} points off the f64 result")
                print(f"  B4 f32 {shape} points beyond 1e-5 of f64 "
                      "(kernel/plain): " + ", ".join(
                          f"{k} {k_bad[k][0]}/{p_bad[k][0]}" for k in truth
                          if k_bad[k][0] or p_bad[k][0]), flush=True)
            errs[(str(dtype).split(".")[-1], shape)] = (
                max(v[1] for v in vs_plain.values()),
                sum(v[0] for v in vs_plain.values()))
            if shape == (50, 65, 128):
                timing[str(dtype).split(".")[-1]] = (
                    cuda_ms(lambda: p3_part2.p3_part2_cuda(*args), 50),
                    cuda_ms(lambda: p3_part2.p3_part2_reference(*args), 10))
            del args, args64, got, ref
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


def healthy(state, tag, water=WATER):
    for k, v in state.items():
        check(bool(torch.isfinite(v).all()), f"{tag}: {k} not finite")
    t = state["temp"]
    check(150.0 <= float(t.min()) and float(t.max()) <= 350.0,
          f"{tag}: temp outside [150, 350] K")
    for k in water:
        check(float(state[k].min()) >= 0.0, f"{tag}: {k} negative")
    wmax = float(state["wvel"].abs().max())
    check(0.0 < wmax < 50.0, f"{tag}: |wvel| max {wmax}")
    return wmax


def golden_run(setup_supercell_mmf, state_from_numpy, name, nsteps=10,
               **kw):
    """nsteps f64 steps on the card from tests/golden/<name>_init.npz;
    returns the final state."""
    drv, _ = setup_supercell_mmf(**GOLDEN_KW, **kw, dtype=torch.float64,
                                 device="cuda")
    init = dict(np.load(os.path.join(GOLDEN, f"{name}_init.npz")))
    state = state_from_numpy(init, "cuda", torch.float64)
    for _ in range(nsteps):
        state = drv.crm_phys_step(state)
    return state


def golden_errors(state, name, tol):
    """Relative error per field of tests/golden/<name>.npz; raises beyond
    tol (default 1e-9)."""
    golden = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    gerr = {}
    for k in golden.files:
        a, b = golden[k], state[k].cpu().numpy()
        gerr[k] = float(np.abs(a - b).max()) / max(float(np.abs(a).max()),
                                                   1e-300)
        check(gerr[k] < tol.get(k, 1e-9),
              f"golden {name} {k}: rel err {gerr[k]:.3e}")
    return gerr


def full_width(setup_supercell_mmf, gcm_forcing, counters, nens, dtype,
               nsteps, water, **kw):
    """nsteps CRM steps at 65x1x50 on the card with every counter set to
    0 just before; returns (printable summary, counts after the run)."""
    t0 = time.perf_counter()
    drv, state = setup_supercell_mmf(nens=nens, dtype=dtype, device="cuda",
                                     **{**FULL, **kw})
    state = gcm_forcing.compute_gcm_forcing_tendencies(
        drv.coupler, state, drv.dt_gcm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    state, ms, wall = run_steps(drv, state, nsteps)
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    tag = f"nens {nens} {str(dtype).split('.')[-1]}"
    wmax = healthy(state, tag, water)
    steady = ms[1:]
    line = (f"{tag}: {nsteps} steps, ms/step (CUDA events) "
            f"first {ms[0]:.2f} steady mean {np.mean(steady):.2f} "
            f"median {np.median(steady):.2f}, host {wall:.2f} ms/step, "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
            f", setup {setup_s:.1f} s, |w|max {wmax:.3f} m/s, counts "
            + ", ".join(f"{k} {v}" for k, v in counts.items()))
    del drv, state
    return line, counts


def main():
    # 1. environment: a card and the package, before anything is printed
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    from pam_tpu_torch.ops import p3_part2, weno, weno_x
    from pam_tpu_torch.physics.p3 import sedimentation
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    weno_count = (weno_x.weno_edges_x_cuda, "launches")
    b4_count = (p3_part2.p3_part2_cuda, "launches")
    sed_count = (sedimentation.combined_sedimentation, "rounds")

    # 2. build from pam_tpu_torch/csrc alone (every csrc/*.cu in one nvcc)
    build = _cuda.build()
    _cuda.library()
    print(f"phase 2 build: {build.seconds:.2f} s {build.path.name}; "
          f"{ptxas_summary(build.log)}", flush=True)

    # 3. x-WENO kernel vs plain on the card
    errs, timing = phase_kernel(weno, weno_x)
    print("phase 3 kernel vs plain: max abs err " +
          ", ".join(f"{d}{(r, n)} {e:.3e}" for (d, r, n), e in errs.items()) +
          "; (32000,65) us/call kernel/plain " +
          ", ".join(f"{d} {k * 1e3:.2f}/{p * 1e3:.2f}"
                    for d, (k, p) in timing.items()), flush=True)

    # 4. Kessler golden trajectory on the card, f64, through the kernel
    weno_x.weno_edges_x_cuda.launches = 0
    state = golden_run(setup_supercell_mmf, state_from_numpy,
                       "kessler_spam_si")
    check(weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP,
          "golden run did not go through the kernel")
    gerr = golden_errors(state, "kessler_spam_si", {})
    print("phase 4 golden f64 10 steps: max rel err " +
          ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()), flush=True)

    # 5. Kessler at full width: nens 128 f32 for one GCM step, then
    #    nens 1024 f32 and nens 128 f64
    for nens, dtype, nsteps in ((128, torch.float32, 45),
                                (1024, torch.float32, 5),
                                (128, torch.float64, 5)):
        line, counts = full_width(setup_supercell_mmf, gcm_forcing,
                                  {"weno_x": weno_count}, nens, dtype,
                                  nsteps, WATER)
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP,
              f"phase 5: {counts} in {nsteps} steps")
        print(f"phase 5 {line}", flush=True)

    # 6. B4 (P3 part 2) kernel vs plain on the card
    b4_errs, b4_timing = phase_b4(p3_part2)
    print("phase 6 B4 kernel vs plain: max abs err (points beyond "
          "1e-12 f64 / 1e-5 f32 of the field's max) " +
          ", ".join(f"{d}{s} {e:.3e} ({n})"
                    for (d, s), (e, n) in b4_errs.items()) +
          "; (50,65,128) us/call kernel/plain " +
          ", ".join(f"{d} {k * 1e3:.2f}/{p * 1e3:.2f}"
                    for d, (k, p) in b4_timing.items()), flush=True)

    # 7. P3+SHOC golden trajectory on the card, f64, through both kernels
    for obj, attr in (weno_count, b4_count, sed_count):
        setattr(obj, attr, 0)
    state = golden_run(setup_supercell_mmf, state_from_numpy,
                       "p3_shoc_spam_si", micro="p3", sgs="shoc")
    check(p3_part2.p3_part2_cuda.launches == 10
          and weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP,
          f"P3+SHOC golden run: {p3_part2.p3_part2_cuda.launches} B4 and "
          f"{weno_x.weno_edges_x_cuda.launches} x-WENO launches")
    operr = golden_errors(state, "p3_shoc_spam_si_opbyop", {})
    gerr = golden_errors(state, "p3_shoc_spam_si", P3_GOLDEN_TOL)
    print("phase 7 P3+SHOC golden f64 10 steps: max rel err vs pam_tpu op "
          "by op " + ", ".join(f"{k} {e:.2e}" for k, e in operr.items()) +
          "; vs the golden file " +
          ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()) +
          "; sedimentation rounds "
          f"{sedimentation.combined_sedimentation.rounds}", flush=True)

    # 8. P3+SHOC at full width (this slice's main path): nens 128 f32 for
    #    one GCM step, then nens 1024 f32 and nens 128 f64
    main_counts = None
    for nens, dtype, nsteps in ((128, torch.float32, 45),
                                (1024, torch.float32, 5),
                                (128, torch.float64, 5)):
        line, counts = full_width(
            setup_supercell_mmf, gcm_forcing,
            {"weno_x": weno_count, "p3_part2": b4_count,
             "sed_rounds": sed_count}, nens, dtype, nsteps, P3_WATER,
            micro="p3", sgs="shoc")
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP
              and counts["p3_part2"] == nsteps,
              f"phase 8: {counts} in {nsteps} steps")
        if main_counts is None:
            main_counts = counts
        print(f"phase 8 P3+SHOC {line}", flush=True)

    k32, p32 = timing["float32"]
    b32, bp32 = b4_timing["float32"]
    print(json.dumps({"kernels": [
        {"name": "weno_x", "route": "cuda",
         "source": "pam_tpu_torch/csrc/weno_x.cu",
         "replaces": "pam_tpu/ops/weno_x_pallas.py:46",
         "launches": main_counts["weno_x"],
         "max_abs_err": max(errs.values()),
         "ms": k32, "plain_ms": p32},
        {"name": "p3_part2", "route": "cuda",
         "source": "pam_tpu_torch/csrc/p3_part2.cu",
         "replaces": "pam_tpu/physics/p3/main.py:780",
         "launches": main_counts["p3_part2"],
         "max_abs_err": max(e for (d, _), (e, _) in b4_errs.items()
                            if d == "float64"),
         "ms": b32, "plain_ms": bp32}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

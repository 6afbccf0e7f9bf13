"""Smoke run of pam_tpu_torch on one CUDA card (an H100): build the CUDA
kernels, hold each against its plain version, reproduce the golden
trajectories through them, and run the MMF CRM step at the production
width of inputs/input_pamc.yaml (65x1x50 cells, 128 km x 64 km x 20 km):
SPAM+SI with Kessler microphysics and with the production P3+SHOC
physics, and the AWFL dycore with Kessler; then the stretched-grid SPAM
trajectory (phase 12), the four configs/input_mmf_*.yaml through the
run_mmf of driver/standalone.py as the files set them (phase 13), and the
idealized x-z SPAM runs through its run_idealized (phase 14): the three
idealized golden trajectories (14a) and the seven x-z
configs/input_<case>.yaml at their files' grids (14b); and 3-D SPAM
(phase 15): B1 along x and y at the 3-D shapes, the three 3-D goldens
and Tendencies3D against the numpy oracle (15a), the two 3-D
configs/input_<case>.yaml at their files' grids (15b) and the coupled
3-D SPAM+Kessler CRM step at 32x32x50 (15c); and the anelastic and
shallow-water layer models and the GCM bridge (phase 16): B1 at their
shapes, their five goldens and the anelastic compute_rhs against the
numpy oracle (16a), configs/input_{risingbubble_an,doublevortex,
bickleyjet}.yaml at their files' grids (16b) and the GCM round trip
through interface.py's registry at 65x1x50 nens 128 (16c); and the
sharded paths over torch.distributed (phase 17): B1's padded-input mode
against its plain version and beside its wrapping mode (17a), then 4
ranks on this one card over host-staged gloo (tests/
torch_sharding_case.py::chip_phase): the comm primitives on CUDA tensors
(17b), the x-sharded SPAM+SI Kessler, P3+SHOC, AWFL+Kessler and coupled
3-D steps in f64 and Tendencies3D on (y 2, x 2) against the same steps
unsharded on the card (17c), and configs/input_mmf_production.yaml's CRM
step (65x1x50, nens 512, f32) ensemble-sharded, 128 members a rank, with
no collective (17d).

Usage (from the root of a checkout, on a machine with the card):

    python3 chip_smoke.py

Each phase prints one line. The line before the last is the kernels'
JSON record (per kernel: launches on its main path, error against the
plain version, ms per call of the kernel and of the plain version in
float32, and the least time the card could take for the same bytes and
operations; for P3 part 2 the plain version is its table stage and core
together; for the AWFL flux those of the z call, the slower half of its
launches, with the x call's beside them; launches_sharded, one rank's
launches on its sharded path in phase 17: B1 in the padded mode on the
x-sharded SPAM+SI step, B4 on the ensemble-sharded production step, B3
on the x-sharded AWFL step; for B1 also ms_padded and bound_ms_padded,
the padded mode at the main path's shape), the line before it the two WENO
kernels' times beside those of the kernels they replaced, the last line
{"ok": true, "device": {...}}. A kernel's time is device time: its
launches are replayed from a CUDA graph, because launched one by one from
Python these kernels are timed at the host's launch rate; the time of
such eager launches stands beside it. Any failed
check raises, so the exit code is then not 0 and no result is printed.
Needs no network and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
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
# B1 calls per right-hand side: densities and PV along x in the slab
# (spam/tendencies.py::recons), 3 along x and 3 along y in 3-D
# (spam/extruded3d.py::Tendencies3D.recons: densities, qhz, qxy)
B1_PER_RHS = {1: 2, 2: 6}
# AWFL flux calls per sub-cycle in 2-D: 3 SSPRK3 stages, x and z
FLUX_CALLS_PER_CYCLE = 6
# phase 12: configs/input_mmf_pamc.yaml cut as
# tools/make_torch_golden_init.py::PAMC_SMALL cuts it
PAMC_SMALL = dict(crm_nx=16, crm_nz=12, nens=2)
# phase 13: the standalone configs, run as their files say
MMF_CONFIGS = ("kessler", "p3", "pamc", "production")
# phase 14b: the x-z idealized configs and their cuts: None runs the
# file's sim_time, a number that many steps; "acoustic" drops the file's
# dtcrm, which under SSPRK3 is above the acoustic limit (ROADMAP,
# deviations of the reference), for run_idealized's acoustic rule
IDEAL_CONFIGS = (("gravitywave", None, ""), ("largerisingbubble", None, ""),
                 ("supercell", None, ""), ("risingbubble", 300, ""),
                 ("densitycurrent", 300, ""), ("twobubbles", 300, "acoustic"),
                 ("moistrisingbubble", 300, "acoustic"))
# phase 15b: the 3-D configs at their files' grids, as phase 14b's cuts
IDEAL3D_CONFIGS = (("risingbubble3d", None, ""), ("supercell3d", None, ""))
# phase 15c: the coupled 3-D CRM step at the slab's 2 km spacing
FULL3D = dict(nx=32, ny=32, xlen=64000.0, ylen=64000.0)
# phase 15a: B1 at the 3-D path's shapes (nens 16, 32x32x50): the five
# Kessler densities and a PV component (qhz of nz-1 layers), along x and
# along y (on a view with y moved last)
B1_3D_CASES = (("x densities", (5, 16, 50, 32, 32), -1),
               ("x PV", (16, 49, 32, 32), -1),
               ("y densities", (5, 16, 50, 32, 32), -2),
               ("y PV", (16, 49, 32, 32), -2))
# phase 16: B1 calls per right-hand side of the layer models: the
# densities, q0 and f0 stacked into one field, along x and along y
# (spam/layer.py::LayerModel.recons)
B1_PER_RHS_LAYER = 2
# phase 16a: B1 at the new paths' shapes, one member: the AN densities and
# PV of input_risingbubble_an.yaml's 40x30 cells along x; the layer
# models' stacked field (h, q0, f0) of input_doublevortex.yaml's 64x64
# and input_bickleyjet.yaml's 50x50 cells along x and along y
B1_AN_LAYER_CASES = (("AN x densities", (2, 1, 30, 40), -1),
                     ("AN x PV", (1, 29, 40), -1),
                     ("doublevortex x", (3, 1, 64, 64), -1),
                     ("doublevortex y", (3, 1, 64, 64), -2),
                     ("bickleyjet x", (3, 1, 50, 50), -1),
                     ("bickleyjet y", (3, 1, 50, 50), -2))
# phase 16b: the anelastic and layer configs at their files' grids, as
# phase 14b's cuts (bickleyjet's 10,000 steps of 0.02 s cut to 5,000, its
# first 100 s, about half a minute on an H100)
AN_LAYER_CONFIGS = (("risingbubble_an", None), ("doublevortex", None),
                    ("bickleyjet", 5000))
# phase 16c: the GCM round trip through the port's registry at the main
# path's width, f64, 2 GCM steps of 80 s (4 CRM steps each); the fields
# the GCM mirrors (tests/test_gcm_native_roundtrip.py)
ROUND_TRIP_NENS = 128
ROUND_TRIP_DT_GCM = 80.0
ROUND_TRIP_STEPS = 2
ROUND_TRIP_FIELDS = ("temp", "water_vapor", "density_dry", "uvel", "vvel",
                     "wvel", "cloud_liquid", "precip_liquid")
# tests/test_gw_verification.py::test_gravity_wave_si_error_vs_exact: its
# run_level parameters and its bounds on the L2 errors
GW_LEVEL = dict(nx=150, nz=11, dt=20.0, timeend=600.0)
GW_L2_BOUNDS = {"rho": 4e-6, "S": 1e-3, "w": 2e-3, "T": 0.1}
# what the kernels replaced: the kernels that csrc/weno_x.cu and
# csrc/awfl_flux.cu held before they were rebuilt on csrc/weno5.cuh, and
# P3 part 2 before csrc/p3_part2.cu ran its table stage: us per call,
# (f32, f64), by eager launches on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md section 6)
PREVIOUS_US = {"B1": (53.08, 89.71), "B3 x": (112.57, 230.48),
               "B3 z": (120.90, 238.50), "B3 z member dz": (121.56, 243.00),
               # P3 part 2 as two stages, the table stage's dense
               # contractions in PyTorch and then a kernel for the core
               # (kernel_times.py --compare, same card)
               "B4 part 2": (11823.12, 16009.72)}
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate, float32 outside the tensor cores, float64 at half that rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes, flops, dtype):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_ops(fn):
    """Operations of one call of fn, a plain version made of elementwise
    PyTorch operations: one per element that each of them writes (a pow,
    an exp or a select counts as one, so this is the least the function
    needs). Views and reshapes write nothing and count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            held = {a.untyped_storage().data_ptr()
                    for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor)}
            self.ops += sum(o.numel() for o in tree_leaves(out)
                            if isinstance(o, torch.Tensor)
                            and o.untyped_storage().data_ptr() not in held)
            return out

    with Count() as mode:
        fn()
    return mode.ops


def name_of(dtype):
    return str(dtype).split(".")[-1]


def field(rows, nx, dtype, seed):
    """Smooth waves plus jumps, so the limiter's weights move."""
    rng = np.random.default_rng(seed)
    x = np.arange(nx) / nx
    f = np.sin(2 * np.pi * (x[None, :] + rng.random((rows, 1))))
    f += np.where(rng.random((rows, nx)) < 0.15,
                  rng.standard_normal((rows, nx)), 0.0)
    return torch.as_tensor(f, dtype=dtype, device="cuda")


def ptxas_summary(log):
    """Registers and spills per kernel instantiation from nvcc -Xptxas -v
    (a line that reports no spill is left out: the device functions that
    csrc/p3_part2.cu calls print one each)."""
    out, name = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = next((k for k in ("p3_part2", "awfl_flux", "weno_x")
                           if k + "_kernel" in ln), "?")
            tail = ln.split(kernel + "_kernel", 1)[-1]
            name = kernel + "/" + ("f64" if tail.startswith("Id") else
                                   "f32" if tail.startswith("If") else "?")
            if kernel == "awfl_flux":   # <T, per-level matrices, along x>
                name += ("/levels" if tail[2:].startswith("Lb1E") else
                         "/uniform") + ("/x" if "ELb1EE" in tail else "/yz")
        elif "registers" in ln or ("spill" in ln
                                   and " 0 bytes spill stores" not in ln):
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


def graph_ms(fn, reps, per_graph=20):
    """Mean milliseconds of device time per call of fn, a kernel's
    wrapper: per_graph calls are captured into one CUDA graph (the
    wrapper launches on the capturing stream) and the graph is replayed
    until reps calls have run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = max(1, reps // per_graph)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# (rows, nx) of the x-WENO comparison: the main path's, then a last block
# that is not full, nx of 5, 6, 128 and 257, a row wider than the tile
# (cut into segments) and the narrowest row
B1_CASES = ((32000, 65), (6272, 65), (37, 16), (1001, 65), (9, 5), (7, 6),
            (3, 128), (5, 257), (3, 5000), (1, 3))


def phase_kernel(weno, weno_x):
    """Kernel vs plain at the main path's shapes and at B1_CASES, f32 and
    f64; returns ({(dtype, rows, nx): max abs err}, {dtype: (kernel ms by
    graph replay, kernel ms by eager launches, plain ms)} at (32000, 65))."""
    errs, timing = {}, {}
    for dtype in (torch.float32, torch.float64):
        tb = weno.weno_tables(5, dtype)
        for rows, nx in B1_CASES:
            f = field(rows, nx, dtype, seed=rows)
            got = weno_x.weno_edges_x_cuda(f, tb)
            torch.cuda.synchronize()
            ref = weno_x.weno_edges_x_reference(f, tb)
            for r, g in zip(ref, got):
                abs_err = float((r - g).abs().max())
                rel = abs_err / max(float(r.abs().max()), 1e-300)
                check(rel < TOL[dtype], f"kernel vs plain {dtype} "
                      f"({rows},{nx}): rel err {rel:.3e}")
                key = (name_of(dtype), rows, nx)
                errs[key] = max(errs.get(key, 0.0), abs_err)
            if rows == 32000:
                timing[name_of(dtype)] = (
                    graph_ms(lambda: weno_x.weno_edges_x_cuda(f, tb), 400),
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


def phase_b4(p3_part2, p3main):
    """B4 kernel (all of P3 part 2 in one launch) vs its plain version
    (the table stage with its hat-weight contractions, then the pointwise
    core) at the main path's shape and a ragged size, f64 and f32, with
    cloud, rain and ice each at half of the points and at 2% of them;
    returns ({(dtype, shape, present): (max abs err kernel vs plain,
    points beyond the tolerance)}, {(dtype, present): (kernel ms by graph
    replay, kernel ms by eager launches, plain ms)} at (50, 65, 128), the
    operations of one call there with the lookups as gathers, the arrays
    of that shape one f32 call allocates at its peak). f64: every field
    within 1e-12 of its largest |value|. f32: both the kernel and the
    plain version are held against the plain version in f64 on the same
    (rounded) inputs, at 1e-5; where a limiter drains a species to
    rounding noise, the final q < QSMALL clip goes either way in f32 and
    the number/rime fields differ there, so the kernel may have no more
    such points than 2x the plain version's (+10)."""
    errs, timing, ops, peak_arrays = {}, {}, 0, 0.0
    cases = [(dtype, shape, present)
             for dtype in (torch.float64, torch.float32)
             for shape in ((50, 65, 128), (1000003,))
             for present in (0.5, 0.02)]
    for dtype, shape, present in cases:
        args64 = p3_part2.sample_inputs(shape, torch.float64, "cuda",
                                        seed=11, present=present)
        args = p3_part2.cast_inputs(args64, dtype)
        got = p3_part2.outputs(*p3_part2.p3_part2_cuda(*args))
        torch.cuda.synchronize()
        ref = p3_part2.outputs(*p3_part2.p3_part2_reference(*args))
        tag = f"{name_of(dtype)} {shape} present {present}"
        vs_plain = b4_beyond(ref, got, B4_TOL[dtype])
        if dtype == torch.float64:
            bad = {k: v for k, v in vs_plain.items() if v[0]}
            check(not bad, f"B4 kernel vs plain {tag}: {bad}")
        else:
            truth = p3_part2.outputs(*p3_part2.p3_part2_reference(
                *p3_part2.cast_inputs(args, torch.float64)))
            truth = {k: v.to(dtype) for k, v in truth.items()}
            k_bad = b4_beyond(truth, got, B4_TOL[dtype])
            p_bad = b4_beyond(truth, ref, B4_TOL[dtype])
            for k in truth:
                check(k_bad[k][0] <= 2 * p_bad[k][0] + 10,
                      f"B4 {tag} {k}: kernel {k_bad[k][0]} vs "
                      f"plain {p_bad[k][0]} points off the f64 result")
            print(f"  B4 {tag} points beyond 1e-5 of f64 "
                  "(kernel/plain): " + ", ".join(
                      f"{k} {k_bad[k][0]}/{p_bad[k][0]}" for k in truth
                      if k_bad[k][0] or p_bad[k][0]), flush=True)
            del truth
        errs[(name_of(dtype), shape, present)] = (
            max(v[1] for v in vs_plain.values()),
            sum(v[0] for v in vs_plain.values()))
        del got, ref
        if shape == (50, 65, 128):
            timing[(name_of(dtype), present)] = (
                graph_ms(lambda: p3_part2.p3_part2_cuda(*args), 100),
                cuda_ms(lambda: p3_part2.p3_part2_cuda(*args), 50),
                cuda_ms(lambda: p3_part2.p3_part2_reference(*args), 10))
            if dtype == torch.float32 and present == 0.5:
                st = args[-1]
                ops = plain_ops(lambda: p3main._part2_core(
                    *args, p3main._part2_tables(st, gather=True)))
                # the bytes asked of the allocator (it may hand out more:
                # a block takes the unsplittable rest of its segment)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                asked = lambda k: torch.cuda.memory_stats()[
                    f"requested_bytes.all.{k}"]
                before = asked("current")
                out = p3_part2.p3_part2_cuda(*args)
                torch.cuda.synchronize()
                peak_arrays = ((asked("peak") - before)
                               / (args[1].numel() * args[1].element_size()))
                del out
                check(0 < peak_arrays <= 30, "B4: one call allocates "
                      f"{peak_arrays:.1f} arrays of its shape at its peak")
        del args, args64
    return errs, timing, ops, peak_arrays


B3_CASES = (   # (nens, ny, nz, nx, ntr, axis, a dz per member, member step)
    ("x", (128, 1, 50, 65, 3, 4, False, 1)),
    ("z", (128, 1, 50, 65, 3, 3, False, 1)),
    ("x ntr 10", (128, 1, 50, 65, 10, 4, False, 1)),
    ("z ntr 10", (128, 1, 50, 65, 10, 3, False, 1)),
    ("y 3-D", (4, 9, 11, 13, 3, 2, False, 1)),
    ("z ragged", (3, 5, 7, 37, 10, 3, False, 1)),
    ("z member dz", (128, 1, 50, 65, 3, 3, True, 1)),
    # faces that the tile (4 along y and z) or the block's run (255 cells
    # along x) does not divide, no tracers, and every second member of a
    # larger array (a member stride that is not the array's own)
    ("x ragged ntr 0", (3, 2, 5, 129, 0, 4, False, 1)),
    ("z 13 faces ntr 0", (2, 3, 12, 37, 0, 3, False, 1)),
    ("y 3-D 19 faces", (2, 18, 4, 33, 3, 2, False, 1)),
    ("z members ::2", (6, 2, 9, 21, 3, 3, False, 2)),
    ("x members ::2", (6, 1, 9, 70, 10, 4, False, 2)),
    ("z member dz ragged", (5, 3, 9, 37, 3, 3, True, 1)))


def b3_inputs(nens, ny, nz, nx, ntr, axis, dtype, device, seed=0,
              member_dz=False):
    """Seeded inputs of ops/awfl_flux.py::flux_direction for comparing the
    kernel with its plain version: ``(prim, trac, pres, levels)`` for an
    (ny, nz, nx) grid, padded along ``axis``, as strided views of one
    array padded in every direction (what the dycore passes). Smooth
    waves plus noise and jumps, winds of both signs, and in z a stretched
    grid with its per-level matrices (``levels`` is None otherwise): one
    set for every member, or with ``member_dz`` a dz and a set of its own
    for each."""
    from pam_tpu_torch.ops import awfl_flux, recon_matrices as rm
    HS, AX_Y, AX_Z, AX_X = (awfl_flux.HS, awfl_flux.AX_Y, awfl_flux.AX_Z,
                            awfl_flux.AX_X)
    rng = np.random.default_rng(seed)
    full = [nens, ny + 2 * HS, nz + 2 * HS, nx + 2 * HS]
    x = np.arange(full[3]) / nx
    z = np.arange(full[2])[:, None] / nz

    def fld(base, wave, noise):
        f = base + wave * np.sin(2 * np.pi * (x + rng.random((nens, 1, 1, 1)))
                                 ) * np.cos(np.pi * z)
        f = f + noise * rng.standard_normal(full)
        return f + np.where(rng.random(full) < 0.1,
                            2 * noise * rng.standard_normal(full), 0.0)

    fields = [fld(1.0, 0.05, 0.01), fld(2.0, 8.0, 2.0), fld(0.0, 4.0, 1.0),
              fld(0.0, 1.0, 0.5), fld(300.0, 3.0, 0.5)]
    fields += [np.abs(fld(0.0, 1e-3, 3e-4)) for _ in range(ntr)]
    fields.append(fld(0.0, 80.0, 20.0))
    allp = torch.as_tensor(np.stack(fields), dtype=dtype, device=device)
    sl = [slice(None)] * 5
    for a in (AX_Y, AX_Z, AX_X):
        if a != axis:
            sl[a] = slice(HS, -HS)
    view = allp[tuple(sl)]
    levels = None
    if axis == AX_Z:
        members = np.arange(nens if member_dz else 1)[:, None]
        dz = 300.0 * (1.0 + 0.05 * members) * (
            1.0 + 0.35 * np.sin(np.arange(nz) + members))
        levels = awfl_flux.LevelMatrices.build(
            *rm.vertical_recon_matrices(dz, awfl_flux.ORD), dtype, device)
    return view[:5], view[5:5 + ntr], view[-1], levels


def phase_b3(awfl_flux, weno):
    """B3 kernel vs plain on the card, f64 at 1e-12 and f32 at 2e-5 of
    each output's largest |value|: x at (6,400 rows, 65) and z at (8,320
    rows, 50 levels, stretched dz, per-level matrices, mask on) with 3
    and 10 tracers, y at a small 3-D shape, one ragged shape, z with a
    dz and a matrix set of its own for every member, and shapes that the
    kernel's tiles do not divide, without tracers and on every second
    member of a larger array (B3_CASES). The f32
    kernel is also held against the plain version in f64 on the same
    (rounded) inputs at 1e-3: float32 rounding through the limiter, which
    the comparison above must not see and this one must. Returns
    ({(dtype, case): max abs err}, {(dtype, "x" | "z" | "z member dz"):
    (kernel ms by graph replay, kernel ms by eager launches, plain ms,
    bytes, flops)} at full width with 3 tracers, the
    largest relative distance of the f32 kernel from the f64 result)."""
    errs, timing, f32_off = {}, {}, 0.0
    for dtype in (torch.float64, torch.float32):
        tb = weno.weno_tables(5, dtype)
        for case, (nens, ny, nz, nx, ntr, axis, member_dz, step) in B3_CASES:
            prim, trac, pres, levels = b3_inputs(
                nens, ny, nz, nx, ntr, axis, dtype, "cuda", seed=axis + ntr,
                member_dz=member_dz)
            prim, trac, pres = prim[:, ::step], trac[:, ::step], pres[::step]
            got = awfl_flux.flux_direction_cuda(prim, trac, pres, axis, tb,
                                                levels)
            torch.cuda.synchronize()
            ref = awfl_flux.flux_direction_reference(prim, trac, pres, axis,
                                                     tb, levels)
            worst = 0.0
            for r, g in zip(torch.cat(ref), torch.cat(got)):
                check(bool(torch.isfinite(g).all()), f"B3 {case}: not finite")
                abs_err = float((r - g).abs().max())
                rel = abs_err / max(float(r.abs().max()), 1e-300)
                check(rel < TOL[dtype], f"B3 kernel vs plain {dtype} {case}: "
                      f"rel err {rel:.3e}")
                worst = max(worst, abs_err)
            errs[(name_of(dtype), case)] = worst
            if dtype == torch.float32:
                truth = awfl_flux.flux_direction_reference(
                    prim.double(), trac.double(), pres.double(), axis,
                    weno.weno_tables(5, torch.float64),
                    None if levels is None else levels.to(torch.float64))
                for r, g in zip(torch.cat(truth), torch.cat(got)):
                    f32_off = max(f32_off, float((r - g).abs().max())
                                  / max(float(r.abs().max()), 1e-300))
                del truth
            if case in ("x", "z", "z member dz"):
                run = lambda fn: fn(prim, trac, pres, axis, tb, levels)
                timing[(name_of(dtype), case)] = (
                    graph_ms(lambda: run(awfl_flux.flux_direction_cuda), 400),
                    cuda_ms(lambda: run(awfl_flux.flux_direction_cuda), 100),
                    cuda_ms(lambda: run(awfl_flux.flux_direction_reference),
                            5),
                    *awfl_flux.flux_work(prim.shape, ntr, axis,
                                         prim.element_size(), tb,
                                         matrix_sets=0 if levels is None
                                         else levels.packed.shape[0]))
            del prim, trac, pres, got, ref
    check(0.0 < f32_off < 1e-3, f"B3 f32 kernel vs plain f64: {f32_off:.3e}")
    return errs, timing, f32_off


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
    """nsteps f64 steps on the card from tests/golden/<name>_init.npz with
    a driver of GOLDEN_KW updated by kw; returns the final state."""
    drv, _ = setup_supercell_mmf(**{**GOLDEN_KW, **kw}, dtype=torch.float64,
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
    tag = f"nens {nens} {name_of(dtype)}"
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


def records(cfg):
    """Snapshots run_mmf writes for cfg: t=0, then at each GCM step that
    reaches the next multiple of out_freq (its callback's rule)."""
    n, nout, etime = 1, 0, 0.0
    for _ in range(int(np.ceil(cfg["sim_time"] / cfg["dt_gcm"]))):
        etime += cfg["dt_gcm"]
        if etime >= (nout + 1) * cfg["out_freq"]:
            n, nout = n + 1, nout + 1
    return n


def run_config(standalone, mmf, counters, name, tmp):
    """configs/input_mmf_<name>.yaml through run_mmf on the card as the
    file sets it (out_prefix in tmp; the production file writes no output,
    out_freq -1, and here writes at t=0 and at its end), with every
    counter set to 0 just before; checks the state, the launch counts and
    the NetCDF file; returns (printable summary, counts)."""
    from scipy.io import netcdf_file
    cfg = standalone.load_config(os.path.join(ROOT, "configs",
                                              f"input_mmf_{name}.yaml"))
    cfg["out_prefix"] = os.path.join(tmp, name)
    if cfg["out_freq"] < 0:
        cfg["out_freq"] = float(cfg["sim_time"])
    ms = []
    step = mmf.MmfDriver.crm_phys_step

    def timed_step(self, state):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(self, state)
        end.record()
        ms.append((start, end))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    mmf.MmfDriver.crm_phys_step = timed_step
    try:
        t0 = time.perf_counter()
        state = standalone.run_mmf(cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mmf.MmfDriver.crm_phys_step = step
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    ms = [a.elapsed_time(b) for a, b in ms]
    f64 = cfg.get("f64", True)
    dycore = cfg.get("dycore", "awfl")
    p3 = cfg.get("micro") == "p3"
    tag = f"{name} nens {cfg['nens']} {'f64' if f64 else 'f32'} {dycore}"
    nsteps = int(np.ceil(cfg["sim_time"] / cfg["dt_gcm"])) * int(
        round(cfg["dt_gcm"] / cfg["dt_crm_phys"]))
    check(len(ms) == nsteps, f"{tag}: {len(ms)} CRM steps, not {nsteps}")
    wmax = healthy(state, tag, tuple(k for k in (P3_WATER if p3 else WATER)
                                     if k in state))
    want = {"weno_x": WENO_CALLS_PER_STEP * nsteps if dycore == "spam"
            else 0,
            "p3_part2": nsteps if p3 else 0,
            "awfl_flux": FLUX_CALLS_PER_CYCLE * counts["sub_cycles"]}
    check(all(counts[k] == v for k, v in want.items())
          and (dycore == "spam") == (counts["sub_cycles"] == 0),
          f"{tag}: launches {counts}, expected {want}")
    zint = standalone.build_zint(cfg).astype(np.float64 if f64
                                             else np.float32)
    with netcdf_file(cfg["out_prefix"] + ".nc", "r", mmap=False) as f:
        nrec = f.variables["t"].shape[0]
        check(nrec == records(cfg) and f.dimensions["nens"] == cfg["nens"]
              and np.array_equal(f.variables["zint"][:],
                                 np.repeat(zint[:, None], cfg["nens"], 1)),
              f"{tag}: NetCDF file has {nrec} records, nens "
              f"{f.dimensions['nens']}, or another zint")
        size = os.path.getsize(cfg["out_prefix"] + ".nc")
    line = (f"{tag}: {nsteps} CRM steps in {wall:.2f} s, ms/step (CUDA "
            f"events) first {ms[0]:.2f} mean {np.mean(ms[1:]):.2f} median "
            f"{np.median(ms[1:]):.2f}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
            f"|w|max {wmax:.3f} m/s, {nrec} records "
            f"{size / 2**20:.1f} MiB, counts "
            + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if dycore == "awfl":
        line += f", {counts['sub_cycles'] / nsteps:.1f} sub-cycles per step"
    del state
    return line, counts


def b1_per_step(cfg, layer=False):
    """B1 launches of one idealized step: B1_PER_RHS (B1_PER_RHS_LAYER for
    a layer model) in each right-hand side, 3 of SSPRK3 or si_max_iters of
    an SI step (compute_rhs and si_max_iters - 1 quasi-Newton
    evaluations)."""
    if layer:
        return 3 * B1_PER_RHS_LAYER
    per_rhs = B1_PER_RHS[2 if cfg.get("crm_ny", 1) > 1 else 1]
    if cfg.get("tstype", "ssprk3") == "si":
        return per_rhs * cfg.get("si_max_iters", 3)
    return 3 * per_rhs


def run_ideal(standalone, weno_x, cfg, tmp, tag):
    """cfg through run_idealized on the card with the B1 count at 0 just
    before, statistics at t=0 and at the end (stat_freq set to the run's
    length); checks the fields finite, the mass of each member conserved
    to 1e-12 (1e-5 in float32, where the statistics are float32 sums)
    and the B1 count; returns (printable summary, final state)."""
    dt = standalone.idealized_dt(cfg)
    nsteps = int(np.ceil(cfg["sim_time"] / dt))
    cfg = dict(cfg, out_prefix=os.path.join(tmp, tag),
               stat_freq=(nsteps + 0.5) * dt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    weno_x.weno_edges_x_cuda.launches = 0
    t0 = time.perf_counter()
    out = standalone.run_idealized(cfg, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weno_x.weno_edges_x_cuda.launches
    for name, a in zip(("dens", "v", "w"), out):
        check(a.is_cuda, f"{tag}: {name} is not on the card")
        check(bool(torch.isfinite(a).all()), f"{tag}: {name} not finite")
    check(launches == nsteps * b1_per_step(cfg),
          f"{tag}: {launches} B1 launches in {nsteps} steps")
    from scipy.io import netcdf_file
    with netcdf_file(cfg["out_prefix"] + "_stats.nc", "r", mmap=False) as f:
        t = f.variables["t"][:].copy()
        mass = f.variables["densstat"][:, 0, :].copy()
        energy = f.variables["E"][:].copy()
    check(len(t) == 2 and abs(t[-1] - nsteps * dt) < 1e-6 * dt,
          f"{tag}: statistics at t={t}")
    dmass = float(np.abs(mass[-1] - mass[0]).max() / np.abs(mass[0]).max())
    mass_tol = 1e-12 if cfg.get("f64", True) else 1e-5
    check(dmass < mass_tol, f"{tag}: mass changed by {dmass:.3e}")
    drift = float(np.abs(energy[-1] - energy[0]).max()
                  / np.abs(energy[0]).max())
    grid = "x".join(str(cfg[k]) for k in ("crm_nx", "crm_ny", "crm_nz")
                    if cfg.get(k, 1) > 1)
    line = (f"{tag}: {nsteps} steps of {dt:.6g} s, {grid} nens "
            f"{cfg.get('nens', 1)} {cfg.get('tstype', 'ssprk3')} "
            f"{'f64' if cfg.get('f64', True) else 'f32'}, {wall:.2f} s wall, "
            f"{wall * 1e3 / nsteps:.2f} ms/step (setup included), "
            f"B1 {launches}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, mass "
            f"change {dmass:.2e}, energy drift {drift:.2e}, "
            f"|w|max {float(out[2].abs().max()):.4g}")
    return line, out


def phase_14(standalone, weno_x, golden, gw_verification):
    """The idealized x-z SPAM runs through run_idealized on the card: the
    three golden trajectories (14a), the seven x-z configs at their files'
    grids and the gravity wave against its exact solution (14b)."""
    # 14a. the idealized golden trajectories on the card, f64, through B1:
    #      the configs cut to 16x12 nens 2 (risingbubble CE SSPRK3,
    #      gravitywave CE SI, supercell MCE_rho SI with 5 iterations and
    #      diffusion), within 1e-9 of pam_tpu's runs, the exact B1 count
    with tempfile.TemporaryDirectory() as tmp:
        for name in golden.IDEAL_GOLDEN:
            cfg = golden.ideal_small_config(name)
            line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
            gold = np.load(golden.ideal_path(name))
            errs = {}
            for field, a in zip(("dens", "v", "w"), out):
                ref = gold[field]
                errs[field] = float(np.abs(ref - a.cpu().numpy()).max()
                                    / np.abs(ref).max())
                check(errs[field] < 1e-9, f"phase 14a {name} {field}: "
                      f"rel err {errs[field]:.3e}")
            print(f"phase 14a golden {line}; max rel err vs pam_tpu " +
                  ", ".join(f"{k} {e:.2e}" for k, e in errs.items()),
                  flush=True)

    # 14b. the seven x-z configs through run_idealized at their files'
    #      grids, nens and dtype: gravitywave, largerisingbubble and
    #      supercell to their sim_time, the others 300 steps
    with tempfile.TemporaryDirectory() as tmp:
        for name, nsteps, how in IDEAL_CONFIGS:
            cfg = standalone.load_config(os.path.join(
                ROOT, "configs", f"input_{name}.yaml"))
            cut = []
            if how == "acoustic":
                cut.append(f"dtcrm {cfg.pop('dtcrm')} dropped")
            if nsteps is not None:
                cut.append(f"sim_time {cfg['sim_time']} cut to {nsteps} "
                           "steps")
                cfg["sim_time"] = (nsteps - 0.5) * standalone.idealized_dt(
                    cfg)
            line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
            print(f"phase 14b {line}; cut: {', '.join(cut) or 'none'}",
                  flush=True)
            del out
    t0 = time.perf_counter()
    errs, _, _ = gw_verification.run_level(**GW_LEVEL, device="cuda")
    torch.cuda.synchronize()
    for var, bound in GW_L2_BOUNDS.items():
        check(np.isfinite(errs[var]).all() and errs[var][1] < bound,
              f"phase 14b gravity wave {var}: L2 {errs[var][1]:.3e} not "
              f"below {bound}")
    print(f"phase 14b gravitywave vs the exact solution, run_level "
          f"{GW_LEVEL} in {time.perf_counter() - t0:.2f} s: L2 (bound) " +
          ", ".join(f"{v} {errs[v][1]:.3e} ({b})"
                    for v, b in GW_L2_BOUNDS.items()) + "; Linf " +
          ", ".join(f"{v} {errs[v][0]:.3e}" for v in GW_L2_BOUNDS),
          flush=True)


def phase_b1_shapes(weno, weno_x, cases, recon):
    """B1 on a path's shapes (cases: (name, shape, axis)), f32 and f64:
    the route the model takes, recon(field, tables, axis) (along x the
    field itself, along y a view with y moved last), against
    weno_x.weno_edges_h_reference, at TOL; returns {(dtype, case): (kernel
    ms by graph replay, plain ms, bound ms, max abs err)}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        tb = weno.weno_tables(5, dtype)
        for case, shape, axis in cases:
            n = shape[axis]
            rows = int(np.prod(shape)) // n
            f = field(rows, shape[-1], dtype, seed=rows).reshape(shape)
            route = lambda: recon(f, tb, axis)
            got = route()
            torch.cuda.synchronize()
            ref = weno_x.weno_edges_h_reference(f, tb, axis)
            err = 0.0
            for r, g in zip(ref, got):
                abs_err = float((r - g).abs().max())
                check(abs_err / max(float(r.abs().max()), 1e-300)
                      < TOL[dtype], f"B1 {case} {shape} {dtype}: rel err "
                      f"{abs_err:.3e}")
                err = max(err, abs_err)
            out[(name_of(dtype), case)] = (
                graph_ms(route, 200),
                cuda_ms(lambda: weno_x.weno_edges_h_reference(f, tb, axis), 10),
                bound_ms(*weno_x.weno_x_work(rows, n, f.element_size(), tb),
                         dtype)[0], err)
            del f, got, ref
    return out


def b1_summary(b1, cases):
    """phase_b1_shapes' times and errors as one printable line."""
    return ("us/call f32 / f64: kernel by graph replay (y: on the moved "
            "view, one copy included) / plain PyTorch (stencil rolls + "
            "weno_edges_list) (bound); max abs err: " + "; ".join(
                f"{case} {shape} " + " / ".join(
                    f"{out[0] * 1e3:.2f} / {out[1] * 1e3:.2f} "
                    f"({out[2] * 1e3:.2f})"
                    for out in (b1[(d, case)] for d in ("float32",
                                                        "float64")))
                + f", err "
                f"{max(b1[(d, case)][3] for d in ('float32', 'float64')):.2e}"
                for case, shape, _ in cases))


def phase_15(standalone, weno_x, golden, mmf_pieces):
    """3-D SPAM on the card: B1 at the 3-D shapes and the three 3-D
    goldens and the numpy oracle through it (15a), the two 3-D configs at
    their files' grids (15b), the coupled 3-D SPAM+Kessler CRM step at
    32x32x50 (15c). Returns the B1 count of 15c's first run."""
    from pam_tpu_torch.ops import weno
    from pam_tpu_torch.spam import extruded3d
    import spam3d_oracle
    from torch_spam3d_case import oracle_case_3d
    setup_supercell_mmf, state_from_numpy, gcm_forcing, weno_count = \
        mmf_pieces

    # 15a. B1 at the 3-D shapes, both routes, against the plain version
    b1 = phase_b1_shapes(weno, weno_x, B1_3D_CASES, extruded3d._edge_recon_h)
    print("phase 15a B1 at 3-D shapes (nens 16, 32x32x50), " +
          b1_summary(b1, B1_3D_CASES), flush=True)

    #     the three 3-D goldens on the card, f64, through B1: the 3-D
    #     configs cut to 10x8x10 nens 2 and the coupled step at 12x8x12
    #     nens 2, within 1e-9 of pam_tpu, the exact B1 count
    with tempfile.TemporaryDirectory() as tmp:
        for name in golden.IDEAL3D_GOLDEN:
            cfg = golden.ideal_small_config(name)
            line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
            gold = np.load(golden.ideal_path(name))
            errs = {f: float(np.abs(gold[f] - a.cpu().numpy()).max()
                             / np.abs(gold[f]).max())
                    for f, a in zip(("dens", "v", "w"), out)}
            check(max(errs.values()) < 1e-9, f"phase 15a {name}: {errs}")
            print(f"phase 15a golden {line}; max rel err vs pam_tpu " +
                  ", ".join(f"{k} {e:.2e}" for k, e in errs.items()),
                  flush=True)
    drv, _ = setup_supercell_mmf(**golden.SPAM3D_KW, dtype=torch.float64,
                                 device="cuda")
    state = state_from_numpy(dict(np.load(golden.path("mmf_spam3d_small"))),
                             "cuda", torch.float64)
    weno_x.weno_edges_x_cuda.launches = 0
    for _ in range(golden.SPAM3D_NSTEPS):
        state = drv.crm_phys_step(state)
    launches = weno_x.weno_edges_x_cuda.launches
    check(launches == golden.SPAM3D_NSTEPS * 3 * B1_PER_RHS[2],
          f"phase 15a coupled 3-D: {launches} B1 launches")
    gerr = golden_errors(state, "mmf_spam3d_small", {})
    print(f"phase 15a golden coupled 3-D SPAM+Kessler 12x8x12 nens 2 f64 "
          f"{golden.SPAM3D_NSTEPS} steps, B1 {launches}: max rel err vs "
          "pam_tpu " + ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()),
          flush=True)
    del drv, state

    #     Tendencies3D.compute_rhs on the card against the numpy oracle
    tend, (dens, v, w, geop), oracle = oracle_case_3d("cuda")
    dt = 2.0
    got = tend.compute_rhs(*(torch.as_tensor(a, device="cuda")
                             for a in (dens, v, w, geop)), dt)
    want = spam3d_oracle.compute_rhs_3d_oracle(dens, v, w, geop, dt,
                                               **oracle)
    errs = {}
    for name, g, o in zip(("dens", "v", "w"), got, want):
        errs[name] = float(np.abs(g.cpu().numpy() - o).max()
                           / max(1.0, float(np.abs(o).max())))
    check(max(errs.values()) < 1e-10, f"phase 15a oracle: {errs}")
    print("phase 15a Tendencies3D.compute_rhs on the card vs "
          "tests/spam3d_oracle.py (6x4x5, y-varying, FCT on): max err "
          "relative to max(1, |value|) " +
          ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)

    # 15b. the two 3-D configs through run_idealized at their files' grids
    with tempfile.TemporaryDirectory() as tmp:
        for name, nsteps, _ in IDEAL3D_CONFIGS:
            cfg = standalone.load_config(os.path.join(
                ROOT, "configs", f"input_{name}.yaml"))
            cut = []
            if nsteps is not None:
                cut.append(f"sim_time {cfg['sim_time']} cut to {nsteps} "
                           "steps")
                cfg["sim_time"] = (nsteps - 0.5) * standalone.idealized_dt(
                    cfg)
            line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
            print(f"phase 15b {line}; cut: {', '.join(cut) or 'none'}",
                  flush=True)
            del out
    #     the command line of the supercell (30 SI steps, f32)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pam_tpu_torch.driver.standalone",
         "configs/input_supercell3d.yaml"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0 and "Run Time:" in proc.stdout,
          f"phase 15b command line: rc {proc.returncode} "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"phase 15b python -m pam_tpu_torch.driver.standalone "
          f"configs/input_supercell3d.yaml: exit 0 in "
          f"{time.perf_counter() - t0:.2f} s; "
          + " | ".join(proc.stdout.strip().splitlines()[-2:]), flush=True)

    # 15c. the coupled 3-D SPAM+Kessler CRM step at 32x32x50, nens 16
    counts_3d = None
    for dtype in (torch.float32, torch.float64):
        nsteps = 12
        line, counts = full_width(setup_supercell_mmf, gcm_forcing,
                                  {"weno_x": weno_count}, 16, dtype,
                                  nsteps, WATER, **FULL3D)
        check(counts["weno_x"] == nsteps * 3 * B1_PER_RHS[2],
              f"phase 15c: {counts} in {nsteps} steps")
        if counts_3d is None:
            counts_3d = counts["weno_x"]
        print(f"phase 15c coupled 3-D SPAM+Kessler 32x32x50 {line}, "
              f"B1 {counts['weno_x'] / nsteps:.0f} per step", flush=True)
    return counts_3d


def an_constraint(standalone, cfg, out):
    """The anelastic constraint of a run's final winds: max |div(rho_ref
    u)| relative to the largest |v| or |w| (rho_ref and the cell shapes are
    of order 1 here); checks it at round-off, 1e-9."""
    tend = standalone.idealized_setup(cfg, "cuda")[0]
    div = float(tend.psolver.divergence(out[1], out[2]).abs().max())
    rel = div / max(float(out[1].abs().max()), float(out[2].abs().max()))
    check(rel < 1e-9, f"{cfg['init_data']}: anelastic constraint {rel:.3e}")
    return rel


def run_layer(standalone, weno_x, cfg, tag):
    """cfg, a layer-model config, through run_idealized (its run_layer) on
    the card with the B1 count at 0 just before; statistics of
    layer_setup's initial state and of the final one. Checks the fields
    finite, the mass of each density and member and the total PV
    (relative to the sum of |zeta + f|) conserved to 1e-12 (1e-5 in
    float32) and the B1 count; returns (printable summary, final
    (dens, v))."""
    m, _, (d0, v0), (hs, cor), dt, nsteps = standalone.layer_setup(cfg,
                                                                  "cuda")
    st0 = m.statistics(d0, v0, hs, cor)
    pv_scale = (m.q0f0(d0, v0, cor)[3] + cor).abs().sum((-2, -1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    weno_x.weno_edges_x_cuda.launches = 0
    t0 = time.perf_counter()
    out = standalone.run_idealized(cfg, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weno_x.weno_edges_x_cuda.launches
    for name, a in zip(("dens", "v"), out):
        check(a.is_cuda, f"{tag}: {name} is not on the card")
        check(bool(torch.isfinite(a).all()), f"{tag}: {name} not finite")
    check(launches == nsteps * b1_per_step(cfg, layer=True),
          f"{tag}: {launches} B1 launches in {nsteps} steps")
    st1 = m.statistics(*out, hs, cor)
    dmass = float(((st1["mass"] - st0["mass"]).abs()
                   / st0["mass"].abs()).max())
    dpv = float(((st1["pv"] - st0["pv"]).abs() / pv_scale).max())
    drift = float(((st1["E"] - st0["E"]).abs() / st0["E"].abs()).max())
    tol = 1e-12 if cfg.get("f64", True) else 1e-5
    check(dmass < tol and dpv < tol,
          f"{tag}: mass changed by {dmass:.3e}, PV by {dpv:.3e}")
    line = (f"{tag}: {nsteps} steps of {dt:.6g} s, {cfg['crm_nx']}x"
            f"{cfg.get('crm_ny', cfg['crm_nx'])} nens {cfg.get('nens', 1)} "
            f"{m.variant} ssprk3 {'f64' if cfg.get('f64', True) else 'f32'}, "
            f"{wall:.2f} s wall, {wall * 1e3 / nsteps:.2f} ms/step (setup "
            f"included), B1 {launches}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, mass "
            f"change {dmass:.2e}, PV change {dpv:.2e}, energy drift "
            f"{drift:.2e}")
    return line, out


def phase_16(standalone, weno_x, golden, setup_supercell_mmf):
    """The anelastic and layer SPAM models and the GCM bridge on the card:
    B1 at the new shapes, the five goldens and the AN compute_rhs against
    the numpy oracle (16a), the three configs at their files' grids and
    the doublevortex command line (16b), the GCM round trip through the
    port's registry at 65x1x50 nens 128 (16c). Returns the B1 counts of
    16b's risingbubble_an and doublevortex runs and of 16c."""
    from pam_tpu_torch.ops import weno
    from pam_tpu_torch.spam import layer
    import spam_oracle
    from torch_anelastic_case import an_case
    counts = {}

    # 16a. B1 at the anelastic and layer shapes against the plain version
    b1 = phase_b1_shapes(weno, weno_x, B1_AN_LAYER_CASES, layer._edge_recon)
    print("phase 16a B1 at the anelastic and layer shapes (one member), " +
          b1_summary(b1, B1_AN_LAYER_CASES), flush=True)

    #     the five goldens on the card, f64, through B1: the AN and MAN
    #     bubbles cut to 16x12 and the three layer runs cut to 16x16, nens
    #     2, 10 steps each, within 1e-9 of pam_tpu's runs, the exact B1
    #     count, the anelastic constraint at round-off
    with tempfile.TemporaryDirectory() as tmp:
        for name in golden.AN_LAYER:
            cfg = golden.ideal_small_config(name)
            if cfg["init_data"] in standalone.LAYER_CASES:
                line, out = run_layer(standalone, weno_x, cfg, name)
                fields = ("dens", "v")
            else:
                line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
                line += (f", constraint "
                         f"{an_constraint(standalone, cfg, out):.2e}")
                fields = ("dens", "v", "w")
            gold = np.load(golden.ideal_path(name))
            errs = {f: float(np.abs(gold[f] - a.cpu().numpy()).max()
                             / np.abs(gold[f]).max())
                    for f, a in zip(fields, out)}
            check(max(errs.values()) < 1e-9, f"phase 16a {name}: {errs}")
            print(f"phase 16a golden {line}; max rel err vs pam_tpu " +
                  ", ".join(f"{k} {e:.2e}" for k, e in errs.items()),
                  flush=True)

    #     the AN compute_rhs on the card against the numpy oracle
    tend, (dens, v, w, geop), oracle, _ = an_case("cuda")
    got = tend.compute_rhs(*(torch.as_tensor(a, device="cuda")
                             for a in (dens, v, w, geop)), 5.0)
    want = spam_oracle.anelastic_rhs_oracle(dens, v, w, geop, 5.0, **oracle)
    errs = {name: float(np.abs(g.cpu().numpy() - o).max()
                        / max(1.0, float(np.abs(o).max())))
            for name, g, o in zip(("dens", "v", "w"), got, want)}
    check(max(errs.values()) < 1e-10, f"phase 16a oracle: {errs}")
    print("phase 16a AnelasticTendencies.compute_rhs on the card vs "
          "tests/spam_oracle.py::anelastic_rhs_oracle (10x8 nens 2): max "
          "err relative to max(1, |value|) " +
          ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)

    # 16b. the three configs through run_idealized at their files' grids
    with tempfile.TemporaryDirectory() as tmp:
        for name, nsteps in AN_LAYER_CONFIGS:
            cfg = standalone.load_config(os.path.join(
                ROOT, "configs", f"input_{name}.yaml"))
            cut = ""
            if nsteps is not None:
                cut = f"sim_time {cfg['sim_time']} cut to {nsteps} steps"
                cfg["sim_time"] = (nsteps - 0.5) * cfg["dtcrm"]
            if cfg["init_data"] in standalone.LAYER_CASES:
                line, _ = run_layer(standalone, weno_x, cfg, name)
                counts[name] = weno_x.weno_edges_x_cuda.launches
            else:
                line, out = run_ideal(standalone, weno_x, cfg, tmp, name)
                counts[name] = weno_x.weno_edges_x_cuda.launches
                line += (f", constraint "
                         f"{an_constraint(standalone, cfg, out):.2e}")
                del out
            print(f"phase 16b {line}; cut: {cut or 'none'}", flush=True)
    #     the command line of the double vortex (720 SSPRK3 steps, f64)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pam_tpu_torch.driver.standalone",
         "configs/input_doublevortex.yaml"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0 and "Run Time:" in proc.stdout,
          f"phase 16b command line: rc {proc.returncode} "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"phase 16b python -m pam_tpu_torch.driver.standalone "
          f"configs/input_doublevortex.yaml: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.2f} s; "
          + " | ".join(proc.stdout.strip().splitlines()[-2:]), flush=True)

    # 16c. the GCM round trip through the port's registry
    counts["round_trip"] = phase_16c(setup_supercell_mmf, weno_x)
    return counts


def phase_16c(setup_supercell_mmf, weno_x):
    """The GCM round trip of tests/test_gcm_native_roundtrip.py with the
    port's registry and state at 65x1x50, nens 128, f64, SPAM+SI with
    Kessler: each GCM step the CRM state is copied onto the card from the
    registry views of the GCM's arrays (mirrored read-write, with one more
    that the CRM does not touch), advanced by gcm_step and written back
    through the views. Checks the views zero-copy, the GCM's arrays
    untouched until the write-back, validate, the dirty flags on exactly
    the written fields, the B1 count, and the final state bit for bit
    equal to the same steps without the registry. Returns the B1 count."""
    from pam_tpu_torch.interface import HostDataManager
    drv, state = setup_supercell_mmf(
        **{**FULL, "dt_gcm": ROUND_TRIP_DT_GCM}, nens=ROUND_TRIP_NENS,
        dtype=torch.float64, device="cuda")
    init = {k: v.clone() for k, v in state.items()}
    dm = HostDataManager()
    dm.finalize()
    nens, nz, _, nx = state["temp"].shape
    for name, n in (("nens", nens), ("nz", nz), ("nx", nx)):
        dm.register_dimension(name, n)
    host = {name: np.array(state[name].cpu().numpy(), dtype=np.float64)
            for name in ROUND_TRIP_FIELDS}
    host["gcm_surface_flux"] = np.ones((nens, nx))
    for name, a in host.items():
        dm.mirror_array(name, a, desc=name, readonly=False)
    h2d, step_ms, d2h = [], [], []
    crm = int(round(ROUND_TRIP_DT_GCM / drv.dt_crm_phys))
    weno_x.weno_edges_x_cuda.launches = 0
    for _ in range(ROUND_TRIP_STEPS):
        dm.clean_all_entries()
        views = {name: dm.get(name) for name in ROUND_TRIP_FIELDS}
        before = {name: host[name].copy() for name in ROUND_TRIP_FIELDS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for name in ROUND_TRIP_FIELDS:
            check(views[name].ctypes.data == host[name].ctypes.data,
                  f"phase 16c: the view of {name} is not zero-copy")
            state[name] = torch.tensor(views[name], dtype=state[name].dtype,
                                       device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = drv.gcm_step(state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for name in ROUND_TRIP_FIELDS:
            check(np.array_equal(host[name], before[name]),
                  f"phase 16c: the step wrote the GCM's {name}")
            views[name][...] = state[name].cpu().numpy()
        t3 = time.perf_counter()
        h2d.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        d2h.append((t3 - t2) * 1e3)
        for name in ROUND_TRIP_FIELDS:
            check(dm.validate(name) == 0, f"phase 16c: {name} non-finite")
        check(all(dm.entry_dirty(name) for name in ROUND_TRIP_FIELDS)
              and not dm.entry_dirty("gcm_surface_flux"),
              "phase 16c: the dirty flags are not those of the written "
              "fields")
    launches = weno_x.weno_edges_x_cuda.launches
    check(launches == ROUND_TRIP_STEPS * crm * WENO_CALLS_PER_STEP,
          f"phase 16c: {launches} B1 launches")
    wmax = healthy(state, "phase 16c")
    for name in ROUND_TRIP_FIELDS:
        check(np.array_equal(host[name], state[name].cpu().numpy()),
              f"phase 16c: the GCM's {name} is not the final state")
    plain = init
    for _ in range(ROUND_TRIP_STEPS):
        plain = drv.gcm_step(plain)
    differ = [k for k in plain if not torch.equal(plain[k], state[k])]
    check(not differ, f"phase 16c: the round trip differs from the run "
          f"without the registry in {differ}")
    mib = sum(host[name].nbytes for name in ROUND_TRIP_FIELDS) / 2**20
    print(f"phase 16c GCM round trip through the port's registry, 65x1x50 "
          f"nens {nens} f64 SPAM+SI Kessler, {ROUND_TRIP_STEPS} GCM steps "
          f"of {ROUND_TRIP_DT_GCM:g} s ({crm} CRM steps each), "
          f"{len(ROUND_TRIP_FIELDS)} fields of {mib:.1f} MiB in all each "
          f"way: ms per GCM step host-to-device " +
          " ".join(f"{t:.2f}" for t in h2d) + ", gcm_step " +
          " ".join(f"{t:.2f}" for t in step_ms) + ", device-to-host " +
          " ".join(f"{t:.2f}" for t in d2h) + f"; B1 {launches}, views "
          "zero-copy, dirty flags on the written fields only, validate 0, "
          f"bit-equal to the run without the registry, |w|max {wmax:.3f}",
          flush=True)
    dm.finalize()
    return launches


# 17a: B1's padded mode at the unsharded main path's shape and at the
# sharded ones: the slab's densities at nx 64 over 2 x shards (5
# densities, nens 8, 50 levels: 2,000 rows of 32) and the 3-D 32x32x50
# nens 4 over 4 x shards (5 densities, 4 members, 50 levels, 32 y rows:
# 32,000 rows of 8)
B1_PADDED_CASES = ((32000, 65), (2000, 32), (32000, 8))
SHARD_WORLD = 4
SHARD_TOL = 1e-11     # 17c, rtol = atol, as pam_tpu's tests/test_halo.py
# 17d: configs/input_mmf_production.yaml's CRM step. Each rank's members
# are held bit for bit against the same members stepped unsharded by a
# driver of nens/SHARD_WORLD members, and against the unsharded nens 512
# run within PROD_TOL times that run's own drift from a start temperature
# 1 ulp away, max |d| / max |ref| a field (f32: the batch of 128 takes
# other reduction orders than the batch of 512)
PROD_CFG = os.path.join(ROOT, "configs", "input_mmf_production.yaml")
PROD_TOL = 10.0


def phase_17a(weno, weno_x, comm):
    """B1's padded mode against its plain version and beside the wrapping
    mode; returns {(dtype, rows, nx): (padded ms, wrapping ms, padded
    bound ms, bound by, max abs err, plain ms)}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        tb = weno.weno_tables(5, dtype)
        size = torch.tensor([], dtype=dtype).element_size()
        for rows, nx in B1_PADDED_CASES:
            f = field(rows, nx, dtype, seed=rows + nx)
            pad = comm.halo_pad(f, 2).contiguous()
            got = weno_x.weno_edges_x_cuda(pad, tb, padded=True)
            torch.cuda.synchronize()
            ref = weno_x.weno_edges_padded_reference(pad, tb)
            wrap = weno_x.weno_edges_x_cuda(f, tb)
            err = 0.0
            for r, g, w in zip(ref, got, wrap):
                e = float((r - g).abs().max())
                check(e / max(float(r.abs().max()), 1e-300) < TOL[dtype],
                      f"17a padded vs plain {dtype} ({rows},{nx}): {e:.3e}")
                check(torch.equal(g, w), f"17a padded vs wrapping {dtype} "
                      f"({rows},{nx}) differ")
                err = max(err, e)
            bound = bound_ms(*weno_x.weno_x_work(rows, nx, size, tb,
                                                 padded=True), dtype)
            out[(name_of(dtype), rows, nx)] = (
                graph_ms(lambda: weno_x.weno_edges_x_cuda(pad, tb,
                                                          padded=True), 400),
                graph_ms(lambda: weno_x.weno_edges_x_cuda(f, tb), 400),
                bound[0], bound[1], err,
                cuda_ms(lambda: weno_x.weno_edges_padded_reference(pad, tb),
                        10))
    return out


def _worst(ref, got, keys):
    """Largest |got - ref| / max(|ref|, 1) over keys (the rtol = atol
    criterion of pam_tpu's tests)."""
    return max(float(np.abs(got[k] - ref[k]).max()) /
               max(float(np.abs(ref[k]).max()), 1.0) for k in keys)


def phase_17(standalone, weno, weno_x):
    """The sharded paths: 17a B1's padded mode; 17b-d on SHARD_WORLD
    ranks (tests/torch_sharding_case.py::chip_phase): host-staged gloo
    on this one card, NCCL where every rank has a card of its own; 17d
    on PROD_CFG. Returns the kernels' launches on the sharded paths, the
    backend and 17a's record."""
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    from pam_tpu_torch.parallel import comm, mesh as tmesh
    import torch_sharding_case as case
    from torch_spam3d_case import oracle_case_3d
    b1 = phase_17a(weno, weno_x, comm)
    print("phase 17a B1 padded mode, us/call padded / wrapping (padded "
          "bound) / plain, max abs err vs plain: " + ", ".join(
              f"{d}{(r, n)} {p * 1e3:.2f} / {w * 1e3:.2f} ({b * 1e3:.2f} "
              f"by {by}) / {pl * 1e3:.2f} {e:.2e}"
              for (d, r, n), (p, w, b, by, e, pl) in b1.items()),
          flush=True)

    # the unsharded runs on the card, and their start states for the ranks
    refs, unsharded = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, kw, nsteps, _ in case.CHIP_CASES:
            drv, st = case.setup("cuda", torch.float64, **kw)
            paths[name] = os.path.join(tmp, name + ".npz")
            np.savez(paths[name], **case._np(st))
            case._reset()
            refs[name] = []
            for _ in range(nsteps):
                st = drv.crm_phys_step(st)
                refs[name].append(case._np(st))
            torch.cuda.synchronize()
            unsharded[name] = case._read()
            if name == "awfl_kessler":
                # the unsharded run's own drift from a start temperature
                # one unit in the last place away
                st = state_from_numpy(dict(np.load(paths[name])), "cuda",
                                      torch.float64)
                st["temp"] = st["temp"] * (1.0 + 2.0 ** -52)
                ulp_runs = []
                for _ in range(nsteps):
                    st = drv.crm_phys_step(st)
                    ulp_runs.append(case._np(st))
            del drv, st
        tend, x3, _ = oracle_case_3d("cuda", **case.RHS_3D)
        rhs_ref = [r.cpu().numpy() for r in tend.compute_rhs(
            *[torch.as_tensor(a, device="cuda") for a in x3], 0.5)]
        # 17d: the production configuration unsharded, PROD_STEPS steps
        cfg = standalone.load_config(PROD_CFG)
        drv, st = setup_supercell_mmf(**standalone.mmf_setup_kwargs(
            cfg, "cuda"))
        st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st,
                                                        drv.dt_gcm)
        paths["production"] = os.path.join(tmp, "production.npz")
        np.savez(paths["production"], **case._np(st))
        torch.cuda.synchronize()
        ticks = [time.perf_counter()]
        for _ in range(case.PROD_STEPS):
            st = drv.crm_phys_step(st)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
        prod_ms = np.diff(ticks) * 1e3
        paths["production_ref"] = os.path.join(tmp, "production_ref.npz")
        np.savez(paths["production_ref"], **case._np(st))
        paths["production_cfg"] = PROD_CFG
        prod_nens = drv.coupler.nens
        # the unsharded run's own drift from a start temperature one unit
        # in the last place away: the scale of 17d's tolerance
        start = state_from_numpy(dict(np.load(paths["production"])), "cuda",
                                 drv.coupler.dtype)
        st_ulp = dict(start, temp=start["temp"] * (
            1.0 + float(torch.finfo(drv.coupler.dtype).eps)))
        for _ in range(case.PROD_STEPS):
            st_ulp = drv.crm_phys_step(st_ulp)
        ref = np.load(paths["production_ref"])
        prod_drift = {k: float(np.abs(st_ulp[k].cpu().numpy() - ref[k]).max())
                      / max(float(np.abs(ref[k]).max()), 1e-30)
                      for k in ref.files
                      if st_ulp[k].is_floating_point()}
        # each rank's members stepped alone by a driver of that many
        nloc = prod_nens // SHARD_WORLD
        cfg["nens"] = nloc
        drv, _ = setup_supercell_mmf(**standalone.mmf_setup_kwargs(
            cfg, "cuda"))
        for e in range(SHARD_WORLD):
            st = {k: (v[e * nloc:(e + 1) * nloc] if v.ndim else v)
                  for k, v in start.items()}
            for _ in range(case.PROD_STEPS):
                st = drv.crm_phys_step(st)
            paths[f"production_block{e}"] = os.path.join(
                tmp, f"production_block{e}.npz")
            np.savez(paths[f"production_block{e}"], **case._np(st))
        del drv, st, st_ulp, start
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = tmesh.spawn_ranks(case.chip_phase, SHARD_WORLD, timeout=600,
                                args=(paths,))
        spawn_s = time.perf_counter() - t0

    # 17b: the primitives on CUDA tensors
    prims = [r["prims"] for r in res]
    exact = [k for k in prims[0]["err"] if k not in (
        "transpose_round_trip", "fft_sh", "ifft_real_sh", "rfft_sh",
        "irfft_sh")]
    worst = {k: max(p["err"][k] for p in prims) for k in prims[0]["err"]}
    check(all(worst[k] == 0.0 for k in exact),
          f"17b primitives not bit-exact: {worst}")
    check(all(v < 1e-14 for v in worst.values()),
          f"17b transforms off: {worst}")
    backend = res[0]["spam_kessler"]["backend"]
    where = ("one card, host-staged" if backend == "gloo" else
             "a card each")
    print(f"phase 17b comm primitives, {SHARD_WORLD} ranks on {where}, "
          f"backend {backend}: bit-exact " + ", ".join(exact) +
          "; the transforms against torch.fft on the whole axis, max rel "
          "err " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()
                             if k not in exact) +
          f"; collectives {prims[0]['counts']}", flush=True)

    # 17c: the x-sharded steps against the unsharded ones, f64
    out = res[0]["out"]
    parts = []
    for name, kw, nsteps, shape in case.CHIP_CASES:
        keys = [k for k in case.KEYS + (("vvel",) if kw["ny"] > 1 else ())]
        if name == "p3_shoc":
            keys += ["cloud_water", "rain", "ice", "tke"]
        errs = [_worst(r, o, keys) for r, o in zip(refs[name], out[name])]
        if name == "awfl_kessler":
            # AWFL amplifies rounding ~1000x a step (its WENO weights in
            # flat regions follow rounding noise): the first step is held
            # at SHARD_TOL, every step within the unsharded run's drift
            # from a start state one unit in the last place away
            drift = [_worst(r, u, keys) for r, u in zip(refs[name],
                                                          ulp_runs)]
            check(errs[0] < SHARD_TOL and all(
                e <= max(SHARD_TOL, d) for e, d in zip(errs, drift)),
                f"17c AWFL: {errs} against the 1-ulp drift {drift}")
            err = (f"{errs[0]:.1e} after 1 step, {errs[-1]:.1e} after "
                   f"{nsteps} (1-ulp drift " +
                   ", ".join(f"{d:.1e}" for d in drift) + ")")
        else:
            check(max(errs) < SHARD_TOL, f"17c {name}: {errs}")
            err = f"{max(errs):.1e}"
        per_rank = [r[name]["launches"] for r in res]
        counts = res[0][name]["counts"]
        check(counts["all_gather"] == 0 and counts["all_to_all"] == 0,
              f"17c {name}: {counts}")
        parts.append(f"{name} {kw['nx']}x{kw['ny']}x{kw['nz']} nens "
                     f"{kw['nens']} on {shape} {nsteps} steps {err}, "
                     f"collectives a rank {counts}, launches a rank "
                     f"{per_rank[0]} (unsharded {unsharded[name]})")
        check(all(p == per_rank[0] for p in per_rank),
              f"17c {name}: launches differ between ranks {per_rank}")
    k_sp = res[0]["spam_kessler"]["launches"]
    check(k_sp["weno_x_padded"] == k_sp["weno_x"]
          == unsharded["spam_kessler"]["weno_x"] > 0,
          f"17c SPAM: B1 not in the padded mode {k_sp}")
    k_p3 = res[0]["p3_shoc"]["launches"]
    check(k_p3["p3_part2"] == unsharded["p3_shoc"]["p3_part2"] > 0
          and k_p3["weno_x_padded"] > 0, f"17c P3+SHOC: {k_p3}")
    k_aw = res[0]["awfl_kessler"]["launches"]
    check(k_aw["sub_cycles"] == unsharded["awfl_kessler"]["sub_cycles"]
          and k_aw["awfl_flux"] == unsharded["awfl_kessler"]["awfl_flux"] > 0,
          f"17c AWFL: {k_aw} vs {unsharded['awfl_kessler']}")
    k_3d = res[0]["spam3d_kessler"]["launches"]
    check(0 < k_3d["weno_x_padded"] < k_3d["weno_x"],
          f"17c 3-D: x padded, y wrapping: {k_3d}")
    seen = set()
    for r in res:
        y, x = r["rhs3d"]["coords"]
        seen.add((y, x))
        ny, nx = case.RHS_3D["ny"] // 2, case.RHS_3D["nx"] // 2
        for got, want in zip(r["rhs3d"]["rhs"], rhs_ref):
            want = want[..., ny * y:ny * (y + 1), nx * x:nx * (x + 1)]
            e = float(np.abs(got - want).max()) / max(
                float(np.abs(want).max()), 1.0)
            check(e < SHARD_TOL, f"17c compute_rhs (y 2, x 2): {e:.3e}")
        check(r["rhs3d"]["launches"]["weno_x_padded"] ==
              r["rhs3d"]["launches"]["weno_x"] == 6,
              f"17c compute_rhs launches {r['rhs3d']['launches']}")
    check(len(seen) == 4, f"17c compute_rhs blocks {seen}")
    print("phase 17c sharded steps f64 vs unsharded on the card, max "
          "|d| / max(|ref|, 1) over the steps, < 1e-11: " + "; ".join(parts) +
          "; Tendencies3D.compute_rhs 32x32x24 on (y 2, x 2) within 1e-11, "
          "6 padded B1 launches a rank", flush=True)

    # 17d: the production step ensemble-sharded
    prod = [r["production"] for r in res]
    for r in prod:
        check(r["counts"] == {"p2p": 0, "all_reduce": 0, "all_gather": 0,
                              "all_to_all": 0},
              f"17d made collectives: {r['counts']}")
        check(all(f for _, _, f in r["err"].values()), "17d not finite")
    rel = {k: max(p["err"][k][0] / max(p["err"][k][1], 1e-30) for p in prod)
           for k in prod[0]["err"]}
    worst_k = max(rel, key=rel.get)
    check(all(p["block_bit_equal"] for p in prod),
          "17d: a rank's members differ from the same members stepped "
          "alone: " + str([p["block_bit_equal"] for p in prod]))
    check(all(v <= max(PROD_TOL * prod_drift[k], 1e-6)
              for k, v in rel.items()),
          f"17d members off the unsharded run: {rel} (1-ulp drift "
          f"{prod_drift})")
    ms_rank = [float(np.median(p["ms_steps"][1:])) for p in prod]
    print(f"phase 17d production CRM step (configs/input_mmf_production."
          f"yaml: SPAM+SI, P3+SHOC, 65x1x50, f32) nens {prod_nens} on "
          f"{SHARD_WORLD} ranks of {prod[0]['nens_local']} ({backend}), "
          f"{case.PROD_STEPS} steps, collectives 0: max rel err a field "
          + ", ".join(f"{k} {v:.1e} (1-ulp drift {prod_drift[k]:.1e})"
                      for k, v in rel.items()
                      if k in case.KEYS + ("rain", "ice", "tke")) +
          f" (worst {worst_k} {rel[worst_k]:.1e}), within {PROD_TOL:g} "
          f"times the drift; every rank's {nloc} members bit-equal to "
          f"them stepped alone at nens {nloc}; ms a step, median of "
          f"steps 2-{case.PROD_STEPS}: per rank " +
          ", ".join(f"{m:.2f}" for m in ms_rank) +
          f", whole (barrier to barrier, {case.PROD_STEPS} steps) "
          f"{np.mean([p['ms_all'] for p in prod]):.2f}, unsharded nens "
          f"{prod_nens} on the card {np.median(prod_ms[1:]):.2f}; B1 "
          f"{prod[0]['launches']['weno_x']} and B4 "
          f"{prod[0]['launches']['p3_part2']} launches a rank; the ranks' "
          f"call {spawn_s:.1f} s", flush=True)
    return dict(
        weno_x=res[0]["spam_kessler"]["launches"]["weno_x_padded"],
        p3_part2=prod[0]["launches"]["p3_part2"],
        awfl_flux=res[0]["awfl_kessler"]["launches"]["awfl_flux"],
        backend=backend, b1=b1)


def main():
    # 1. environment: a card and the package, before anything is printed
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver import mmf, standalone
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.ops import awfl_flux, p3_part2, weno, weno_x
    from pam_tpu_torch.physics.p3 import main as p3main, sedimentation
    from pam_tpu_torch.utils import gw_verification
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))   # the numpy oracles
    import make_torch_golden_init as golden
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
    b3_count = (awfl_flux.flux_direction_cuda, "launches")
    cycle_count = (AwflDycore.timestep, "cycles")

    # 2. build from pam_tpu_torch/csrc alone (one nvcc per source, side
    #    by side; csrc/weno5.cuh is in both WENO kernels' keys)
    build = _cuda.build()
    _cuda.library()
    print(f"phase 2 build: {build.seconds:.2f} s "
          f"{' '.join(p.name for p in build.paths.values())}; "
          f"{ptxas_summary(build.log)}", flush=True)

    # 3. x-WENO kernel vs plain on the card
    b1_bounds = {name_of(d): bound_ms(
        *weno_x.weno_x_work(32000, 65, size, weno.weno_tables(5, d)), d)
        for d, size in ((torch.float32, 4), (torch.float64, 8))}
    errs, timing = phase_kernel(weno, weno_x)
    print("phase 3 kernel vs plain: max abs err " +
          ", ".join(f"{d}{(r, n)} {e:.3e}" for (d, r, n), e in errs.items()) +
          "; (32000,65) us/call kernel (by eager launches)/plain (bound) " +
          ", ".join(f"{d} {k * 1e3:.2f} ({h * 1e3:.2f})/{p * 1e3:.2f} "
                    f"({b1_bounds[d][0] * 1e3:.2f} by {b1_bounds[d][1]})"
                    for d, (k, h, p) in timing.items()), flush=True)

    # 4. Kessler golden trajectory on the card, f64, through the kernel
    weno_x.weno_edges_x_cuda.launches = 0
    state = golden_run(setup_supercell_mmf, state_from_numpy,
                       "kessler_spam_si", dycore="spam")
    check(weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP,
          "golden run did not go through the kernel")
    gerr = golden_errors(state, "kessler_spam_si", {})
    print("phase 4 golden f64 10 steps: max rel err " +
          ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()), flush=True)

    # 5. Kessler at full width: nens 128 f32 for 10 steps, then
    #    nens 1024 f32 and nens 128 f64
    for nens, dtype, nsteps in ((128, torch.float32, 10),
                                (1024, torch.float32, 5),
                                (128, torch.float64, 5)):
        line, counts = full_width(setup_supercell_mmf, gcm_forcing,
                                  {"weno_x": weno_count}, nens, dtype,
                                  nsteps, WATER)
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP,
              f"phase 5: {counts} in {nsteps} steps")
        print(f"phase 5 {line}", flush=True)

    # 6. B4 (all of P3 part 2) kernel vs plain on the card
    b4_errs, b4_timing, b4_ops, b4_peak = phase_b4(p3_part2, p3main)
    n_b4 = 50 * 65 * 128
    b4_bounds = {name_of(d): bound_ms(
        (p3_part2.N_IN + p3_part2.N_OUT) * n_b4 * size, b4_ops, d)
        for d, size in ((torch.float32, 4), (torch.float64, 8))}
    print("phase 6 B4 kernel vs plain: max abs err (points beyond "
          "1e-12 f64 / 1e-5 f32 of the field's max) " +
          ", ".join(f"{d}{s} present {q} {e:.3e} ({n})"
                    for (d, s, q), (e, n) in b4_errs.items()) +
          "; (50,65,128) us/call kernel (by eager launches)/plain (bound) " +
          ", ".join(f"{d} present {q} {k * 1e3:.2f} ({h * 1e3:.2f})/"
                    f"{p * 1e3:.2f} ({b4_bounds[d][0] * 1e3:.2f} by "
                    f"{b4_bounds[d][1]})"
                    for (d, q), (k, h, p) in b4_timing.items()) +
          f"; {b4_ops / n_b4:.0f} operations per point with the lookups as "
          f"gathers; one call allocates {b4_peak:.1f} arrays of its shape",
          flush=True)

    # 7. P3+SHOC golden trajectory on the card, f64, through both kernels
    for obj, attr in (weno_count, b4_count, sed_count):
        setattr(obj, attr, 0)
    state = golden_run(setup_supercell_mmf, state_from_numpy,
                       "p3_shoc_spam_si", micro="p3", sgs="shoc",
                       dycore="spam")
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

    # 8. P3+SHOC at full width (the main path of B1 and B4): nens 128 f32
    #    for 10 steps, then nens 1024 f32 and nens 128 f64
    main_counts = None
    for nens, dtype, nsteps in ((128, torch.float32, 10),
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

    # 9. B3 (AWFL directional flux) kernel vs plain on the card
    b3_errs, b3_timing, f32_off = phase_b3(awfl_flux, weno)
    print("phase 9 B3 kernel vs plain: max abs err " +
          ", ".join(f"{d} {c} {e:.3e}" for (d, c), e in b3_errs.items()) +
          f"; f32 kernel vs plain in f64, max rel err {f32_off:.3e}"
          "; 65x1x50 nens 128 ntr 3 us/call kernel (by eager launches)/plain "
          "(bound) " +
          ", ".join(f"{d} {c} {k * 1e3:.2f} ({h * 1e3:.2f})/{p * 1e3:.2f} "
                    f"({bound_ms(nb, fl, getattr(torch, d))[0] * 1e3:.2f} by "
                    f"{bound_ms(nb, fl, getattr(torch, d))[1]})"
                    for (d, c), (k, h, p, nb, fl) in b3_timing.items()),
          flush=True)

    # 10. AWFL+Kessler reference trajectory on the card, f64, 5 steps
    #     through the kernel
    for obj, attr in (b3_count, cycle_count):
        setattr(obj, attr, 0)
    state = golden_run(setup_supercell_mmf, state_from_numpy, "awfl_kessler",
                       nsteps=5, dycore="awfl")
    cycles = AwflDycore.timestep.cycles
    check(cycles >= 5 and awfl_flux.flux_direction_cuda.launches
          == cycles * FLUX_CALLS_PER_CYCLE,
          f"AWFL golden run: {awfl_flux.flux_direction_cuda.launches} B3 "
          f"launches in {cycles} sub-cycles")
    operr = golden_errors(state, "awfl_kessler_opbyop", {})
    gerr = golden_errors(state, "awfl_kessler", {})
    print(f"phase 10 AWFL+Kessler f64 5 steps, {cycles} sub-cycles, "
          f"{awfl_flux.flux_direction_cuda.launches} B3 launches: max rel "
          "err vs pam_tpu op by op " +
          ", ".join(f"{k} {e:.2e}" for k, e in operr.items()) +
          "; vs pam_tpu jitted " +
          ", ".join(f"{k} {e:.2e}" for k, e in gerr.items()), flush=True)

    # 11. AWFL+Kessler at full width (the main path of B3): nens 128 f32
    #     for 10 steps, then nens 1024 f32 and nens 128 f64
    awfl_counts = None
    for nens, dtype, nsteps in ((128, torch.float32, 10),
                                (1024, torch.float32, 3),
                                (128, torch.float64, 3)):
        line, counts = full_width(
            setup_supercell_mmf, gcm_forcing,
            {"awfl_flux": b3_count, "sub_cycles": cycle_count}, nens, dtype,
            nsteps, WATER, dycore="awfl")
        check(counts["sub_cycles"] >= nsteps and counts["awfl_flux"]
              == counts["sub_cycles"] * FLUX_CALLS_PER_CYCLE,
              f"phase 11: {counts} in {nsteps} steps")
        if awfl_counts is None:
            awfl_counts = counts
        print(f"phase 11 AWFL+Kessler {line}, per step "
              f"{counts['sub_cycles'] / nsteps:.1f} sub-cycles "
              f"{counts['awfl_flux'] / nsteps:.1f} B3 launches", flush=True)

    # 12. the stretched-grid SPAM trajectory on the card, f64, through B1:
    #     configs/input_mmf_pamc.yaml cut to 16x1x12 nens 2 on its own
    #     build_zint levels (half cells at the bottom and the top), 10
    #     steps against pam_tpu's jitted and op-by-op runs
    cfg = standalone.load_config(os.path.join(ROOT, "configs",
                                              "input_mmf_pamc.yaml"))
    cfg.update(PAMC_SMALL)
    drv, _ = setup_supercell_mmf(**standalone.mmf_setup_kwargs(cfg, "cuda"))
    check(drv.dycore.tend.vert_per_level() is not None,
          "phase 12: the pamc levels read as uniform")
    state = state_from_numpy(dict(np.load(os.path.join(
        GOLDEN, "mmf_pamc_small_init.npz"))), "cuda", torch.float64)
    weno_x.weno_edges_x_cuda.launches = 0
    for _ in range(10):
        state = drv.crm_phys_step(state)
    check(weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP,
          f"phase 12: {weno_x.weno_edges_x_cuda.launches} x-WENO launches")
    gerr = golden_errors(state, "mmf_pamc_small", {})
    operr = golden_errors(state, "mmf_pamc_small_opbyop", {})
    print(f"phase 12 stretched SPAM f64 10 steps, "
          f"{weno_x.weno_edges_x_cuda.launches} x-WENO launches: max rel err "
          "vs pam_tpu jitted " + ", ".join(f"{k} {e:.2e}"
                                            for k, e in gerr.items()) +
          "; vs op by op " + ", ".join(f"{k} {e:.2e}"
                                       for k, e in operr.items()),
          flush=True)
    del drv, state

    # 13. the four standalone configs through run_mmf at 65x1x50, each as
    #     its file sets it (nens, dtype, dycore, physics, 2 GCM steps of
    #     45 CRM steps), each with the counters at 0 just before it
    with tempfile.TemporaryDirectory() as tmp:
        for name in MMF_CONFIGS:
            line, _ = run_config(
                standalone, mmf,
                {"weno_x": weno_count, "p3_part2": b4_count,
                 "awfl_flux": b3_count, "sub_cycles": cycle_count}, name, tmp)
            print(f"phase 13 run_mmf {line}", flush=True)

    phase_14(standalone, weno_x, golden, gw_verification)
    launches_3d = phase_15(standalone, weno_x, golden,
                           (setup_supercell_mmf, state_from_numpy,
                            gcm_forcing, weno_count))
    launches_16 = phase_16(standalone, weno_x, golden, setup_supercell_mmf)
    sharded = phase_17(standalone, weno, weno_x)
    pad32 = sharded["b1"][("float32", 32000, 65)]

    # the kernels' record: float32 times at the main path's shapes (B4
    # with cloud, rain and ice each at half of the points); no single
    # PyTorch call computes any of the three functions
    k32, _, p32 = timing["float32"]
    b32, _, bp32 = b4_timing[("float32", 0.5)]
    b1_bound = b1_bounds["float32"]
    b4_bound = b4_bounds["float32"]
    # B3: the z call, the slower half of the main path's launches, under
    # the contract's keys, and the x call beside it
    z32, _, zp32, z_bytes, z_flops = b3_timing[("float32", "z")]
    x32, _, xp32, x_bytes, x_flops = b3_timing[("float32", "x")]
    b3_bound = bound_ms(z_bytes, z_flops, torch.float32)
    # the two WENO kernels beside the kernels they replaced
    new_us = {"B1": [timing[d] for d in ("float32", "float64")]}
    for c in ("x", "z", "z member dz"):
        new_us[f"B3 {c}"] = [b3_timing[(d, c)] for d in ("float32",
                                                         "float64")]
    new_us["B4 part 2"] = [b4_timing[(d, 0.5)] for d in ("float32",
                                                         "float64")]
    print("us per call f32 / f64, now by graph replay (by eager launches) "
          "<- the previous kernel by eager launches: " + "; ".join(
              f"{name} " + " / ".join(f"{t[0] * 1e3:.2f} ({t[1] * 1e3:.2f})"
                                      for t in new_us[name])
              + f" <- {old[0]:.2f} / {old[1]:.2f}"
              for name, old in PREVIOUS_US.items()), flush=True)
    print(json.dumps({"kernels": [
        {"name": "weno_x", "route": "cuda",
         "source": "pam_tpu_torch/csrc/weno_x.cu",
         "replaces": "pam_tpu/ops/weno_x_pallas.py:46",
         "launches": main_counts["weno_x"],
         "max_abs_err": max(errs.values()),
         "ms": k32, "plain_ms": p32, "bound_ms": b1_bound[0],
         "bound_by": b1_bound[1], "library_ms": None,
         "launches_3d": launches_3d,
         "launches_anelastic": launches_16["risingbubble_an"],
         "launches_layer": launches_16["doublevortex"],
         "launches_gcm_round_trip": launches_16["round_trip"],
         "launches_sharded": sharded["weno_x"], "ms_padded": pad32[0],
         "bound_ms_padded": pad32[2]},
        {"name": "p3_part2", "route": "cuda",
         "source": "pam_tpu_torch/csrc/p3_part2.cu",
         "replaces": "pam_tpu/physics/p3/main.py:780",
         "launches": main_counts["p3_part2"],
         "max_abs_err": max(e for (d, _, _), (e, _) in b4_errs.items()
                            if d == "float64"),
         "ms": b32, "plain_ms": bp32, "bound_ms": b4_bound[0],
         "bound_by": b4_bound[1], "library_ms": None,
         "launches_sharded": sharded["p3_part2"]},
        {"name": "awfl_flux", "route": "cuda",
         "source": "pam_tpu_torch/csrc/awfl_flux.cu",
         "replaces": "pam_tpu/ops/awfl_pallas.py:148",
         "launches": awfl_counts["awfl_flux"],
         "max_abs_err": max(e for (d, _), e in b3_errs.items()
                            if d == "float64"),
         "ms": z32, "plain_ms": zp32, "bound_ms": b3_bound[0],
         "bound_by": b3_bound[1], "library_ms": None,
         "ms_x": x32, "plain_ms_x": xp32,
         "bound_ms_x": bound_ms(x_bytes, x_flops, torch.float32)[0],
         "launches_sharded": sharded["awfl_flux"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

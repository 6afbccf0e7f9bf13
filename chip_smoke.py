"""Smoke run of pam_tpu_torch on one CUDA card (an H100): build the CUDA
kernels, hold each against its plain version, reproduce the golden
trajectories through them, and run the MMF CRM step at the production
width of inputs/input_pamc.yaml (65x1x50 cells, 128 km x 64 km x 20 km):
SPAM+SI with Kessler microphysics and with the production P3+SHOC
physics, and the AWFL dycore with Kessler (its FCT limiter's kernel
first, phase 9b: against its plain version on the card and on the CPU,
timed by graph replay beside its bound from bytes); then the
stretched-grid SPAM trajectory (phase 12), the four
configs/input_mmf_*.yaml through the run_mmf of driver/standalone.py as
the files set them (phase 13: the
production config's ens_chunk "auto" runs its 512 members as 4 chunks of
128), and the
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
no collective (17d); and the benchmark route and the scaling tool
(phase 18): python -m pam_tpu_torch.bench's single-config line of record
at nens 128 (18a) and its default rows, bench.py's six (rows 2-4 in
chunks of 128, as bench.py runs them), with short runs (18b), each line
held to the route's contract, and python -m
pam_tpu_torch.measure_scaling's slab configuration on 1 and 2 x shards,
its collectives a step equal to 17c's and its bytes a step nonzero for
every kind it counts (18c); and the tridiagonal solves' two routes and
the port's own start state (phase 19): each call site's solve at the main
path's shapes on PCR and on Thomas (19a), the Kessler and P3+SHOC
trajectories on the default route, PCR on the card, against pam_tpu's
PCR runs (19b), the line of record and the P3+SHOC row on both routes
(19c), JAX's draw and the golden start states built on the card (19d);
and ensemble micro-batching (phase 20): driver/mmf.py's chunked routes
in f64 at 65x1x50 nens 8 as 4 chunks of 2, bit for bit against each other
and the chunks stepped alone, P3+SHOC against the whole-ensemble step,
Kessler's chunks with their own rainsplit counts (20a), peak memory and
ms a step of the production config (P3+SHOC f32) through run_mmf at nens
4096 in one program and in chunks of 1024, and at 8192 in chunks (20b),
the benchmark route's rows 2-4 whole beside 18b's chunked records and the
production config without its ens_chunk (20c); and the compiled CRM step
(phase 21): MmfDriver._graphed_single, the step captured into one CUDA
graph whose Kessler, P3 sedimentation and AWFL loops run as CUDA WHILE
nodes, against the eager step bit for bit for the three stacks at
65x1x50 in f32 and f64 with the same trip counts, on a rainy Kessler
state and through the PCR goldens (21a), its replays with no
synchronising call and its host launches beside the eager step's (21b),
both routes of the benchmark rows and of the production config (21c),
and its refusals (21d). run, run_mmf, crm_phys_step_hostchunked and the
benchmark route replay the compiled step, so phases 13, 18 and 20 run it
(their lines say "compiled"); crm_phys_step stays the eager step, which
phases 4-12, 15-17 and 19 run.
The golden phases (4, 7, 12, 13, 14a, 15a, 16a) pin the Thomas
recurrence, the route their files were written with; the other phases
take the default route.

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
on the x-sharded AWFL step (where F1 launches none, checked in 17c);
launches_bench, its launches in the
benchmark route's default rows in phase 18b; launches_pcr, B1's and B4's
in phase 19b's trajectories; launches_chunked, B1's and B4's in the
first chunked step of each of phase 20a's two cases; for B1 also
ms_padded and
bound_ms_padded, the padded mode at the main path's shape; for Z1, the
z-WENO kernel of the SPAM slab, those of the production density call on
the configs' levels, every call of phase 3b under calls, its launches in
phase 13's production run, 6 a step a chunk, and launches_eager phase
8's), the line
before it the two WENO
kernels' times beside those of the kernels they replaced, the last line
{"ok": true, "device": {...}}. A kernel's time is device time: its
launches are replayed from a CUDA graph, because launched one by one from
Python these kernels are timed at the host's launch rate; the time of
such eager launches stands beside it. Any failed
check raises, so the exit code is then not 0 and no result is printed.
Needs no network and imports nothing of JAX.
"""

import contextlib
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
# FCT launches per sub-cycle in 2-D: one a stage's tendency
FCT_PER_CYCLE = 3
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


def thomas_route():
    """Every tridiagonal solve of the block on the Thomas recurrence, the
    route the golden files were written with (ops/tridiag.py takes PCR on
    the card by default; phase 19b holds that route against pam_tpu's PCR
    runs)."""
    from pam_tpu_torch.ops import tridiag
    from torch_jax_refs import tridiag_mode
    return tridiag_mode(tridiag, "thomas")


def bound_ms(nbytes, flops, dtype):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fct_work(ntr, nens, nz, nx, itemsize):
    """Bytes one call of csrc/awfl_fct.cu needs: both tracer fluxes and
    the start values read once, both limited fluxes written once (dz and
    the flags, a few KB, left out)."""
    cells = ntr * nens * nz * nx
    faces = ntr * nens * (nz * (nx + 1) + (nz + 1) * nx)
    return itemsize * (cells + 2 * faces)


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
    from pam_tpu_torch._cuda import KERNELS
    out, name = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            k = next((k for k in KERNELS if k.trace_name in ln), None)
            tail = ln.split(k.trace_name, 1)[-1] if k else ""
            name = (k.key if k else "?") + "/" + (
                "f64" if tail.startswith("Id") else
                "f32" if tail.startswith("If") else "?")
            if k and k.key == "awfl_flux":  # <T, per-level matrices, along x>
                name += ("/levels" if tail[2:].startswith("Lb1E") else
                         "/uniform") + ("/x" if "ELb1EE" in tail else "/yz")
            elif k and k.key == "weno_z":   # <T, per-level matrices>
                name += ("/levels" if tail[2:].startswith("Lb1E") else
                         "/uniform")
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
# Z1 (csrc/weno_z.cu) at the benchmark cells' calls, nens 128 on the
# configs' 50 build_zint levels: (case, leading shape, levels, dtype); the
# densities (ndens, 128, 50 + 4, 65) and the PV (128, 49 + 4, 65), whose
# rows are strided as the model slices them; production's twelve
# densities in float32, Kessler's five in float64
Z1_CASES = (("production densities", (12, 128), 50, torch.float32),
            ("production PV", (128,), 49, torch.float32),
            ("Kessler densities", (5, 128), 50, torch.float64),
            ("Kessler PV", (128,), 49, torch.float64))
Z1_NX = 65
Z1_DTYPE = {case: dtype for case, _, _, dtype in Z1_CASES}
# Z1 calls per SPAM+SI step: densities and PV in each of the three
# symplectic evaluations (spam/tendencies.py::recons)
Z1_CALLS_PER_STEP = 6


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


def phase_z1(weno, weno_z, build_zint):
    """Z1 through the route the model takes (spam/tendencies.py::
    _edge_recon_z) at Z1_CASES, on the uniform tables and on the per-level
    matrices of the configs' levels (packed as the tendencies pack them),
    against weno_z.weno_edges_z_reference at TOL, one launch a call;
    returns {(case, grid): (kernel ms by graph replay, kernel ms by eager
    launches, plain ms, (bound ms, bound by), max abs err, shape)}."""
    from pam_tpu_torch.spam import tendencies as ttend
    from pam_tpu_torch.spam.geometry import ExtrudedGeometry
    zint = build_zint({"crm_nz": 50, "zlen": 20000.0})
    out = {}
    for case, lead, nlev, dtype in Z1_CASES:
        geom = ExtrudedGeometry.build(Z1_NX, zint, 128000.0, 128, dtype,
                                      "cuda")
        tend = ttend.SpamTendencies(geom=geom, varset=None, thermo=None)
        levels = (tend.per_level_d, tend.packed_d) if nlev == 50 else (
            tend.per_level_q, tend.packed_q)
        check(levels[1] is not None, f"Z1 {case}: no packed matrices on "
              "the configs' levels")
        rows = int(np.prod(lead))
        cut = 1 if nlev == 49 else 0      # the PV's rows strided
        f = field(rows * (nlev + 4 + cut), Z1_NX, dtype, seed=rows + nlev)
        f = f.reshape(lead + (nlev + 4 + cut, Z1_NX))[..., cut:, :]
        tb = weno.weno_tables(5, dtype)
        for grid, (pl, packed) in (("uniform", (None, None)),
                                   ("per-level", levels)):
            route = lambda: ttend._edge_recon_z(f, tb, nlev, per_level=pl,
                                                packed=packed)
            before = weno_z.weno_edges_z_cuda.launches
            got = route()
            torch.cuda.synchronize()
            check(weno_z.weno_edges_z_cuda.launches == before + 1,
                  f"Z1 {case} {grid}: the route did not launch the kernel "
                  "once")
            ref = weno_z.weno_edges_z_reference(f, tb, nlev, pl)
            err = 0.0
            for r, g in zip(ref, got):
                abs_err = float((r - g).abs().max())
                rel = abs_err / max(float(r.abs().max()), 1e-300)
                check(rel < TOL[dtype], f"Z1 {case} {grid} {name_of(dtype)}"
                      f": rel err {rel:.3e}")
                err = max(err, abs_err)
            out[(case, grid)] = (
                graph_ms(route, 400), cuda_ms(route, 200),
                cuda_ms(lambda: weno_z.weno_edges_z_reference(
                    f, tb, nlev, pl), 10),
                bound_ms(*weno_z.weno_z_work(rows, nlev, Z1_NX,
                                             f.element_size(), tb), dtype),
                err, (rows, nlev + 4, Z1_NX))
            del got, ref
        del f, tend, geom
    return out


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


# FCT (csrc/awfl_fct.cu) at (case, ntr, nens, nz, nx): the cell's call
# (Kessler's three tracers, pama_kessler.nens128), a plane larger than a
# block's shared memory, and P3's ten tracers; tracer 1 is not
# positive-definite in each
FCT_CASES = (("cell", 3, 128, 50, 65), ("large plane", 2, 4, 200, 256),
             ("p3 tracers", 10, 128, 50, 65))
FCT_DX = 2000.0                   # dx = dy of the cells' grid
FCT_ULPS = 4    # kernel vs the plain version on the card, of each face


def fct_inputs(ntr, nens, ny, nz, nx, dtype, device, seed=0,
               member_dz=True):
    """Seeded inputs of ops/awfl_fct.py: tracer fluxes of both signs per
    direction (x, then y in 3-D, then z), start values that run short in
    about half of the cells (a fifth of them empty, one negative),
    stretched levels (a dz per member, or with ``member_dz`` false one
    for all), tracer 1 not positive-definite. Returns (fluxes,
    tracers_start, dz4, pos), ``fluxes`` as fct_limit_reference takes
    them (state fluxes None), on a grid of spacing FCT_DX."""
    from pam_tpu_torch.ops import awfl_fct
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    cells = (ntr, nens, ny, nz, nx)
    members = np.arange(nens if member_dz else 1)[:, None]
    dz4 = t(300.0 * (1.0 + 0.35 * np.sin(np.arange(nz) + members))
            )[:, None, :, None]
    fluxes = []
    for ax, d in ((awfl_fct.AX_X, FCT_DX), (awfl_fct.AX_Y, FCT_DX),
                  (awfl_fct.AX_Z, dz4)):
        if ax == awfl_fct.AX_Y and ny == 1:
            continue
        shape = list(cells)
        shape[ax] += 1
        fluxes.append((ax, d, None, t(1e-3 * rng.standard_normal(shape))))
    start = 3e-5 * np.abs(rng.standard_normal(cells))
    start *= rng.random(cells) > 0.2
    start[..., 0, 0] = -1e-6
    pos = torch.tensor([i != 1 for i in range(ntr)], device=device)
    return fluxes, t(start), dz4, pos[:, None, None, None, None]


def fct_firing_share(fluxes, tracers_start, dt, dz4, pos):
    """Share of the positive tracers' cells whose outflow over dt exceeds
    what they hold: where the limiter fires."""
    vol = FCT_DX * FCT_DX * dz4
    out = sum((tf.narrow(ax, 1, tf.shape[ax] - 1).clamp(min=0.0)
               - tf.narrow(ax, 0, tf.shape[ax] - 1).clamp(max=0.0)) / d
              for ax, d, _, tf in fluxes)
    fires = out * dt * vol > tracers_start.clamp(min=0.0) * vol
    return float(fires[pos.reshape(-1)].double().mean())


def fct_ulps(ref, got, dtype):
    """Largest |got - ref| in units of eps(dtype) times |ref|, over the
    faces (a face where ref is 0 counts only if got is not)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    diff = (got - ref).abs()
    scale = torch.finfo(dtype).eps * ref.abs()
    ulps = torch.where(diff == 0, 0.0, diff / scale)
    return float(ulps.max())


def phase_fct(awfl_fct):
    """The FCT kernel through fct_limit_cuda at FCT_CASES, f64 and f32, dt
    a 0-d tensor as in the compiled step: one launch a call, within
    FCT_ULPS of the plain version on the card, and the faces that differ
    from the plain version on the CPU (whose roundings the kernel
    follows) counted; the limiter firing on a tenth of the cells or more.
    Returns {(dtype, case): (kernel ms by graph replay, kernel ms by eager
    launches, the plain version's ms by graph replay (what the compiled
    step ran before), (bound ms, "bytes"), ulps from the card's plain
    version, faces differing from the CPU's, firing share)}."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        for case, ntr, nens, nz, nx in FCT_CASES:
            fluxes, start, dz4, pos = fct_inputs(ntr, nens, 1, nz, nx, dtype,
                                                 "cuda", seed=nz + ntr)
            dt = torch.tensor(7.3, dtype=dtype, device="cuda")
            share = fct_firing_share(fluxes, start, dt, dz4, pos)
            check(share > 0.1, f"FCT {case}: the limiter fires on {share}")
            fx, fz = fluxes[0][3], fluxes[1][3]
            kernel = lambda: awfl_fct.fct_limit_cuda(fx, fz, start, dt, dz4,
                                                     pos, FCT_DX, FCT_DX)
            plain = lambda: awfl_fct.fct_limit_reference(
                fluxes, start, dt, dz4, pos, FCT_DX, FCT_DX)
            before = awfl_fct.fct_limit_cuda.launches
            got = kernel()
            torch.cuda.synchronize()
            check(awfl_fct.fct_limit_cuda.launches == before + 1,
                  f"FCT {case}: not one launch")
            ref = [r[3] for r in plain()]
            cpu = awfl_fct.fct_limit_reference(
                [(ax, d.cpu() if isinstance(d, torch.Tensor) else d, None,
                  tf.cpu()) for ax, d, _, tf in fluxes], start.cpu(),
                dt.cpu(), dz4.cpu(), pos.cpu(), FCT_DX, FCT_DX)
            ulps = max(fct_ulps(r, g, dtype) for r, g in zip(ref, got))
            check(ulps <= FCT_ULPS, f"FCT {case} {name_of(dtype)}: {ulps} "
                  "ulp from the plain version")
            differ = sum(int((g.cpu() != c[3]).sum())
                         for g, c in zip(got, cpu))
            nbytes = fct_work(ntr, nens, nz, nx, fx.element_size())
            out[(name_of(dtype), case)] = (
                graph_ms(kernel, 400), cuda_ms(kernel, 100),
                graph_ms(plain, 40, per_graph=4), bound_ms(nbytes, 0, dtype),
                ulps, differ, share)
            del fluxes, start, dz4, got, ref, cpu
    return out


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
    counts = read_counts(counters)
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


def read_counts(counters):
    """Each counter as an int: the compiled step adds its replays' launch
    and trip counts as device tensors, read here."""
    return {k: int(getattr(obj, attr)) for k, (obj, attr) in counters.items()}


@contextlib.contextmanager
def timed_chunk_steps():
    """The compiled chunk step that MmfDriver.run replays
    (ops/graph.py::GraphedFunction.__call__, the eager step under
    eager_route) timed with CUDA events while the block runs: yields the
    list of (start, end) events, one pair a driver step (a chunk's step
    where the state is chunked); the first includes the capture."""
    from pam_tpu_torch.ops import graph
    ms = []
    step = graph.GraphedFunction.__call__

    def timed_step(self, state):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(self, state)
        end.record()
        ms.append((start, end))
        return out
    graph.GraphedFunction.__call__ = timed_step
    try:
        yield ms
    finally:
        graph.GraphedFunction.__call__ = step


@contextlib.contextmanager
def eager_route():
    """The compiled step's calls made by the eager step while the block
    runs, so run and run_mmf launch every kernel from Python (the route
    before the compiled step, kept for phase 21c's comparison)."""
    from pam_tpu_torch.ops import graph
    call = graph.GraphedFunction.__call__
    graph.GraphedFunction.__call__ = lambda self, state: self.fn(state)
    try:
        yield
    finally:
        graph.GraphedFunction.__call__ = call


def crm_step_ms(ms, n_chunks):
    """ms of each CRM step from timed_chunk_steps' events: a step is its
    chunks, stepped one after another."""
    return [ms[i][0].elapsed_time(ms[i + n_chunks - 1][1])
            for i in range(0, len(ms), n_chunks)]


def run_config(standalone, mmf, counters, name, tmp, eager=False,
               **changes):
    """configs/input_mmf_<name>.yaml through run_mmf on the card as the
    file sets it, updated by ``changes`` (out_prefix in tmp; the
    production file writes no output, out_freq -1, and here writes at t=0
    and at its end), on the compiled route (on the eager one with
    ``eager``), with every counter set to 0 just before; checks the
    state, the launch counts (once a chunk where the file sets an
    ens_chunk) and the NetCDF file, which holds the full ensemble; returns
    (printable summary, counts, {"mean", "median": ms a CRM step, "peak":
    MiB, "wall": s})."""
    from scipy.io import netcdf_file
    cfg = standalone.load_config(os.path.join(ROOT, "configs",
                                              f"input_mmf_{name}.yaml"))
    cfg.update(changes)
    cfg["out_prefix"] = os.path.join(tmp, name)
    if cfg["out_freq"] < 0:
        cfg["out_freq"] = float(cfg["sim_time"])
    chunk = standalone.check_ens_chunk(
        cfg, standalone.mmf_setup_kwargs(cfg, "cuda")) or cfg["nens"]
    n_chunks = cfg["nens"] // chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    with (eager_route() if eager else contextlib.nullcontext()), \
            timed_chunk_steps() as ms:
        t0 = time.perf_counter()
        state = standalone.run_mmf(cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts(counters)
    f64 = cfg.get("f64", True)
    dycore = cfg.get("dycore", "awfl")
    p3 = cfg.get("micro") == "p3"
    tag = (f"{name} nens {cfg['nens']}"
           + (f" as {n_chunks} chunks of {chunk}" if n_chunks > 1 else "")
           + f" {'f64' if f64 else 'f32'} {dycore}"
           + (" eager" if eager else " compiled"))
    nsteps = int(np.ceil(cfg["sim_time"] / cfg["dt_gcm"])) * int(
        round(cfg["dt_gcm"] / cfg["dt_crm_phys"]))
    check(len(ms) == nsteps * n_chunks,
          f"{tag}: {len(ms)} chunk steps, not {nsteps} x {n_chunks}")
    ms = crm_step_ms(ms, n_chunks)
    wmax = healthy(state, tag, tuple(k for k in (P3_WATER if p3 else WATER)
                                     if k in state))
    spam = dycore == "spam"
    want = {"weno_x": WENO_CALLS_PER_STEP * nsteps * n_chunks if spam else 0,
            "weno_z": Z1_CALLS_PER_STEP * nsteps * n_chunks if spam else 0,
            "p3_part2": nsteps * n_chunks if p3 else 0,
            "awfl_flux": FLUX_CALLS_PER_CYCLE * counts["sub_cycles"],
            "awfl_fct": FCT_PER_CYCLE * counts["sub_cycles"]}
    check(all(counts[k] == v for k, v in want.items())
          and spam == (counts["sub_cycles"] == 0),
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
    return line, counts, dict(mean=float(np.mean(ms[1:])),
                              median=float(np.median(ms[1:])),
                              peak=torch.cuda.max_memory_allocated() / 2**20,
                              wall=wall)


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
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
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
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
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
    with thomas_route():
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
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
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
    # F1 on the card unsharded, the plain limiter on the x-sharded step
    check(k_aw["sub_cycles"] == unsharded["awfl_kessler"]["sub_cycles"]
          and k_aw["awfl_flux"] == unsharded["awfl_kessler"]["awfl_flux"] > 0
          and unsharded["awfl_kessler"]["awfl_fct"]
          == FCT_PER_CYCLE * k_aw["sub_cycles"] and k_aw["awfl_fct"] == 0,
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
        backend=backend, b1=b1,
        counts_17c=(res[0]["spam_kessler"]["counts"], case.CHIP_CASES[0][2]))


# phase 18: the benchmark route (pam_tpu_torch/bench.py) and the scaling
# tool (pam_tpu_torch/measure_scaling.py) as a user runs them. 18a the
# route's single-config line of record at nens 128; 18b its default rows
# (bench.py's six) with short runs; 18c the tool's slab configuration
# (SPAM+SI Kessler, 64x1x50, nens 8, f64) on 1 and on 2 x shards
BENCH_SINGLE = dict(single=("kessler", "none"), nens=128, steps=10, reps=1,
                    trace_steps=2)
BENCH_ROWS = dict(steps=1, reps=1, trace_steps=1, awfl_steps=1)
BENCH_KEYS = {"metric", "value", "unit", "config", "ms_per_step",
              "ms_per_step_median", "reps", "device_ms_per_step",
              "first_step_s", "peak_mib", "chip", "capture_s"}
SCALING_MESHES = ((1, 1), (1, 2))
SCALING_STEPS = 2


def bench_lines(bench, settings, smi_line):
    """The route's rows for ``settings``: what it printed, parsed and
    checked against its contract, and the route's seconds."""
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    recs = bench.run(settings, out=buf)
    secs = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    check(lines == recs and len(recs) == len(bench.rows(settings)),
          f"phase 18: printed {len(lines)} lines for {len(recs)} rows")
    for r, row in zip(recs, bench.rows(settings)):
        check(set(r) == BENCH_KEYS, f"phase 18: keys {sorted(r)}")
        check(r["chip"] == smi_line, f"phase 18: chip {r['chip']!r} is not "
              f"nvidia-smi's {smi_line!r}")
        # device ms may be null only on the AWFL row, whose graph runs the
        # sub-cycles in a WHILE body that CUPTI's trace can leave out (the
        # route then says so rather than summing a part of the step)
        dev = r["device_ms_per_step"]
        check(r["config"] == row.config and r["unit"] == "gridpoint-steps/s"
              and r["value"] > 0 and r["ms_per_step"] > 0
              and r["reps"] == settings.reps and r["peak_mib"] > 0
              and (dev > 0 if dev is not None else row.dycore == "awfl")
              and r["first_step_s"] > 0, f"phase 18: {r}")
    check(recs[-1]["config"] == "micro=kessler,sgs=none,dycore=spam",
          f"phase 18: the last line is {recs[-1]['config']}")
    return recs, secs


def dev_ms(rec) -> str:
    """A bench record's device ms a step, or why it has none."""
    d = rec["device_ms_per_step"]
    return "not measured (the trace left out kernels)" if d is None \
        else f"{d:.3f}"


def phase_18(smi_line, counters, counts_17c):
    """18a-b the benchmark route, each with every kernel's count at 0
    just before and read just after; 18c the scaling tool, its counts a
    step held to 17c's (``counts_17c``: 17c's SPAM+SI Kessler counts and
    its steps). Returns 18b's launches by kernel and, for each of its
    chunked rows, (the row, its record, its launches by kernel)."""
    from pam_tpu_torch import bench, measure_scaling

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return read_counts(counters)

    s = bench.Settings(**BENCH_SINGLE)
    zero()
    (rec,), secs = bench_lines(bench, s, smi_line)
    got = read()
    steps = 1 + bench.WARMUP + s.steps + s.trace_steps
    check(got["weno_x"] == steps * WENO_CALLS_PER_STEP,
          f"phase 18a: {got} in {steps} steps")
    print(f"phase 18a python -m pam_tpu_torch.bench, PAM_BENCH_MICRO="
          f"kessler NENS 128 STEPS {s.steps} REPS {s.reps}: "
          + json.dumps(rec) + f"; B1 {got['weno_x']} launches in {steps} "
          f"steps; {secs:.1f} s", flush=True)

    s = bench.Settings(**BENCH_ROWS)
    zero()
    by_row = []
    real_row = bench.run_row

    def counted_row(settings, row, chip):
        before = read()
        rec = real_row(settings, row, chip)
        by_row.append((row, rec, {k: v - before[k]
                                  for k, v in read().items()}))
        return rec
    bench.run_row = counted_row
    try:
        recs, secs = bench_lines(bench, s, smi_line)
    finally:
        bench.run_row = real_row
    rows_18b = read()
    rows = bench.rows(s)
    # chunk steps of each row: rows 2-4 step their chunks one by one
    per_row = [(1 + bench.WARMUP + r.steps + s.trace_steps)
               * (r.nens // (r.chunk or r.nens)) for r in rows]
    spam = sum(n for n, r in zip(per_row, rows) if r.dycore == "spam")
    p3 = sum(n for n, r in zip(per_row, rows) if r.micro == "p3")
    check(rows_18b["weno_x"] == spam * WENO_CALLS_PER_STEP
          and rows_18b["p3_part2"] == p3 and rows_18b["sub_cycles"] > 0
          and rows_18b["awfl_flux"] ==
          rows_18b["sub_cycles"] * FLUX_CALLS_PER_CYCLE
          and rows_18b["awfl_fct"] == rows_18b["sub_cycles"] * FCT_PER_CYCLE,
          f"phase 18b: {rows_18b} ({spam} SPAM chunk steps, {p3} P3 "
          "chunk steps)")
    print("phase 18b python -m pam_tpu_torch.bench, the default rows on "
          "the compiled route (first step: the capture's) at "
          f"STEPS {s.steps} REPS {s.reps} TRACE_STEPS {s.trace_steps} "
          f"AWFL_STEPS {s.awfl_steps}: " + "; ".join(
              f"{r['config']} {r['ms_per_step']:.3f} ms/step (device "
              f"{dev_ms(r)}, peak {r['peak_mib']:.1f} MiB, "
              f"first step {r['first_step_s']:.2f} s)" for r in recs) +
          f"; launches {rows_18b}; {secs:.1f} s", flush=True)

    t0 = time.perf_counter()
    rep = measure_scaling.measure(configs=("slab",), steps=SCALING_STEPS,
                                  mesh_list=SCALING_MESHES, device="cuda")
    secs = time.perf_counter() - t0
    meshes = rep["configs"]["slab"]["meshes"]
    counts, nsteps = counts_17c
    want = {k: v / nsteps for k, v in counts.items()}
    check(meshes[0]["collectives_per_step"] == dict.fromkeys(want, 0.0),
          f"phase 18c one rank: {meshes[0]['collectives_per_step']}")
    x2 = meshes[1]
    check(x2["collectives_per_step"] == want,
          f"phase 18c x 2: {x2['collectives_per_step']}, 17c: {want}")
    check(all((x2["bytes_per_step"][k] > 0) == (n > 0)
              for k, n in x2["collectives_per_step"].items()),
          f"phase 18c bytes {x2['bytes_per_step']}")
    print(f"phase 18c python -m pam_tpu_torch.measure_scaling --configs "
          f"slab --steps {SCALING_STEPS}, meshes (ens, x) "
          f"{list(SCALING_MESHES)}: " + "; ".join(
              f"({m['ens_shards']}, {m['x_shards']}) {m['backend']} ms/step "
              "ranks " + ", ".join(f"{t:.2f}" for t in m["ms_per_step_rank"])
              + f" together {m['ms_per_step_all']:.2f}, collectives/step "
              f"{m['collectives_per_step']} (17c's), bytes/step "
              f"{m['bytes_per_step']}" for m in meshes) + f"; {secs:.1f} s",
          flush=True)
    return rows_18b, [r for r in by_row if r[0].chunk], recs


# phase 19: the tridiagonal solves (pam_tpu_torch/ops/tridiag.py) and the
# port's own start state. PAM_TRIDIAG's default takes parallel cyclic
# reduction (PCR) on the card and the Thomas recurrence on the CPU, as
# pam_tpu takes PCR on an accelerator; the golden phases above pin Thomas.
# 19a each call site's solve at the main path's shapes, captured from one
# step of its path: PCR against Thomas on the card and against PCR on the
# CPU, us and launches a solve on both routes; 19b the SPAM+SI Kessler and
# P3+SHOC trajectories on the default route against pam_tpu's PCR runs
# (tests/torch_jax_refs.py); 19c the line of record and the P3+SHOC row
# of the benchmark route on both routes, in turns; 19d the draw and the
# start states of setup_supercell_mmf against tests/golden
#
# 19a: (PCR vs Thomas on the card, card vs CPU) per dtype, relative to the
# largest |value| of the solution
SOLVE_TOL = {torch.float64: (1e-10, 1e-12), torch.float32: (1e-4, 1e-5)}
# 19c: a row's reps, route by route (thomas, pcr, pcr, thomas, ...), and
# its steps a rep and traced steps on each route
ROUTE_ORDER = ("thomas", "pcr", "pcr", "thomas", "thomas", "pcr")
ROUTE_STEPS = 12
ROUTE_TRACE_STEPS = 2
# 19b-d: the golden configurations, f64 on the card
START_STATES = {"kessler_spam_si": {},
                "p3_shoc_spam_si": dict(micro="p3", sgs="shoc")}


def first_calls(owner, name, run, ncalls=1):
    """(owner.name, the arguments of its first ``ncalls`` calls while
    run() runs, tensors cloned)."""
    fn = getattr(owner, name)
    calls = []
    clone = lambda a: (a.clone() if isinstance(a, torch.Tensor) else
                       [t.clone() for t in a] if isinstance(a, list) else a)

    def record(*args):
        if len(calls) < ncalls:
            calls.append(tuple(clone(a) for a in args))
        return fn(*args)
    setattr(owner, name, record)
    try:
        run()
    finally:
        setattr(owner, name, fn)
    check(len(calls) == ncalls, f"phase 19a: {name} called {len(calls)} "
          f"times, not {ncalls}")
    return fn, calls


def solve_sites(setup_supercell_mmf, gcm_forcing, standalone, dtype):
    """{call site: (function, its arguments)}: the first solve of each call
    site in one step of its path at the main path's width, on the card."""
    from pam_tpu_torch.physics.sgs.shoc import main as shoc
    from pam_tpu_torch.spam import anelastic, si

    def step(**kw):
        drv, state = setup_supercell_mmf(dtype=dtype, device="cuda",
                                         **{**FULL, **kw})
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv.coupler, state, drv.dt_gcm)
        return lambda: drv.crm_phys_step(state)

    sites = {}
    fn, calls = first_calls(si.CompressibleVelocityLinearSystem, "_tridiag",
                            step(nens=128))
    sites["velocity"] = (fn, calls[0])
    fn, calls = first_calls(si, "_tridiag_real", step(
        nens=128, dycore_kwargs={"linear_system": "pressure"}))
    sites["pressure, slab"] = (fn, calls[0])
    fn, calls = first_calls(si, "_tridiag_real", step(nens=16, **FULL3D), 2)
    sites["pressure-gravity 3-D, A"] = (fn, calls[0])
    sites["pressure-gravity 3-D"] = (fn, calls[1])
    cfg = standalone.load_config(os.path.join(
        ROOT, "configs", "input_risingbubble_an.yaml"))
    cfg["f64"] = dtype == torch.float64
    _, an_step, x, *_ = standalone.idealized_setup(cfg, "cuda")
    fn, calls = first_calls(anelastic.AnelasticPressureSolver, "_tridiag",
                            lambda: an_step(*x))
    sites["anelastic"] = (fn, calls[0])
    fn, calls = first_calls(shoc, "_solve_shared",
                            step(nens=128, micro="p3", sgs="shoc"), 2)
    sites["SHOC u, v"] = (fn, calls[0])
    sites["SHOC scalars, tracers"] = (fn, calls[1])
    return sites


def on_device(args, device):
    """A solve's arguments on ``device``; a solver object (the velocity
    and anelastic systems) becomes its three coefficient stacks."""
    import types
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = a.to(device)
        elif isinstance(a, list):
            a = [t.to(device) for t in a]
        elif hasattr(a, "tri_l"):
            a = types.SimpleNamespace(**{k: getattr(a, k).to(device) for k
                                         in ("tri_l", "tri_d", "tri_u")})
        out.append(a)
    return out


def leaves(x):
    """The tensors of a solve's result or argument, a list or not."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def max_rel(ref, got):
    return max(float((r.cpu() - g.cpu()).abs().max())
               / max(float(r.abs().max()), 1e-300)
               for r, g in zip(leaves(ref), leaves(got)))


def launches_per_call(fn, calls=2):
    """Device operations (kernels, copies, fills) a call of fn launches,
    from a torch.profiler trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               and not e.name.startswith("pam:")
               for e in prof.events()) / calls


def phase_19a(setup_supercell_mmf, gcm_forcing, standalone, route):
    """Each call site at the main path's shapes, f32 and f64: returns
    {(dtype, site): {route: (eager us, graph us, launches), "err": (PCR vs
    Thomas, card vs CPU)}}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        sites = solve_sites(setup_supercell_mmf, gcm_forcing, standalone,
                            dtype)
        for site, (fn, args) in sites.items():
            call = lambda: fn(*args)
            with route("thomas"):
                x_thomas = call()
            with route("pcr"):
                x_pcr = call()
                x_cpu = fn(*on_device(args, "cpu"))
            errs = (max_rel(x_thomas, x_pcr), max_rel(x_cpu, x_pcr))
            tol = SOLVE_TOL[dtype]
            check(errs[0] < tol[0] and errs[1] < tol[1],
                  f"phase 19a {site} {name_of(dtype)}: PCR vs Thomas "
                  f"{errs[0]:.3e}, card vs CPU {errs[1]:.3e}")
            rhs = max((t for a in args for t in leaves(a)
                       if isinstance(t, torch.Tensor)), key=torch.numel)
            rec = {"err": errs, "shape": tuple(rhs.shape),
                   "dtype": name_of(rhs.dtype)}
            for mode in ("thomas", "pcr"):
                with route(mode):
                    rec[mode] = (cuda_ms(call, 10) * 1e3,
                                 graph_ms(call, 40) * 1e3,
                                 launches_per_call(call))
            out[(name_of(dtype), site)] = rec
        del sites
        torch.cuda.empty_cache()
    return out


def phase_19b(setup_supercell_mmf, state_from_numpy, counters):
    """The Kessler and P3+SHOC golden trajectories, f64, on the default
    route, every count at 0 just before: every solve on PCR, B1 and B4 as
    the path launches them, every field within 1e-9 of pam_tpu's PCR run.
    Returns {name: (max rel err by field, counts)}."""
    from pam_tpu_torch.ops import tridiag
    from pam_tpu_torch.physics.sgs.shoc import main as shoc
    from pam_tpu_torch.spam import si
    from torch_jax_refs import PCR_TRAJECTORIES
    check(tridiag._TRIDIAG_MODE == "auto", "phase 19b: PAM_TRIDIAG is "
          f"{tridiag._TRIDIAG_MODE!r}, not the default")
    out = {}
    for name, nsteps, _, stem in PCR_TRAJECTORIES:
        taken = {"pcr": 0, "thomas": 0}
        wrapped = [(si, "pcr", "pcr"), (si, "thomas", "thomas"),
                   (tridiag, "pcr", "pcr"),
                   (shoc, "_thomas_batched", "thomas")]
        saved = [getattr(m, n) for m, n, _ in wrapped]

        def counted(fn, kind):
            def run(*a):
                taken[kind] += 1
                return fn(*a)
            return run
        for (m, n, kind), fn in zip(wrapped, saved):
            setattr(m, n, counted(fn, kind))
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        try:
            state = golden_run(setup_supercell_mmf, state_from_numpy, name,
                               nsteps, dycore="spam",
                               **START_STATES[name])
        finally:
            for (m, n, _), fn in zip(wrapped, saved):
                setattr(m, n, fn)
        counts = read_counts(counters)
        p3 = "micro" in START_STATES[name]
        # 3 SI solves a step, and SHOC's two
        check(taken == {"pcr": nsteps * (5 if p3 else 3), "thomas": 0}
              and counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP
              and counts["p3_part2"] == (nsteps if p3 else 0),
              f"phase 19b {name}: solves {taken}, launches {counts}")
        out[name] = (golden_errors(state, stem, {}), dict(counts, **taken))
    return out


def phase_19c(counters, route):
    """The benchmark route's Kessler (the line of record) and P3+SHOC rows
    at nens 128 f32, its compiled step (a graph a route, each captured by
    one untimed step), on both routes in turns (ROUTE_ORDER, ROUTE_STEPS
    steps a rep), then a trace of ROUTE_TRACE_STEPS steps on each; every
    count at 0 just before a row, read just after. Returns {row: ({route:
    (best ms, median ms, device ms, launches) a step}, counts, steps)}."""
    from torch.profiler import ProfilerActivity, profile
    from pam_tpu_torch import bench
    from pam_tpu_torch.profile_step import device_totals, timed_steps
    out = {}
    for micro, sgs in (("kessler", "none"), ("p3", "shoc")):
        drv, state = bench.setup_config(micro, sgs, 128)
        step = drv._graphed_single()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        state, _ = timed_steps(step, state, 1 + bench.WARMUP)
        with route("thomas"):
            state = step(state)
        ms = {"thomas": [], "pcr": []}
        for mode in ROUTE_ORDER:
            with route(mode):
                state, m = timed_steps(step, state, ROUTE_STEPS)
            ms[mode].append(m)
        rec = {}
        for mode in ("thomas", "pcr"):
            with route(mode), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUTE_TRACE_STEPS):
                    state = step(state)
                torch.cuda.synchronize()
            launches, dev_ms = device_totals(prof, ROUTE_TRACE_STEPS)
            rec[mode] = (min(ms[mode]), float(np.median(ms[mode])), dev_ms,
                         launches)
        healthy(state, f"phase 19c {micro}",
                P3_WATER if micro == "p3" else WATER)
        counts = read_counts(counters)
        nsteps = (2 + bench.WARMUP + len(ROUTE_ORDER) * ROUTE_STEPS
                  + 2 * ROUTE_TRACE_STEPS)
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP
              and counts["p3_part2"] == (nsteps if micro == "p3" else 0),
              f"phase 19c {micro}: {counts} in {nsteps} steps")
        out[f"{micro}+{sgs}"] = (rec, counts, nsteps)
        del drv, state
        torch.cuda.empty_cache()
    return out


def phase_19d(setup_supercell_mmf, gcm_forcing):
    """The port's own draw on this machine against JAX's
    (tests/golden/perturb_uniform.npz), bit for bit once on the card; the
    start states of setup_supercell_mmf on the card against
    tests/golden/<name>_init.npz: the temperature within 1e-14 of its
    scale, every other field too, a forcing tendency within 1e-14 of its
    column's scale over dt_gcm. Returns {name: max rel err of temp}."""
    from pam_tpu_torch.modules import perturb
    import torch_jax_refs as refs
    draws = np.load(refs.UNIFORM_PATH)
    for d in ("float32", "float64"):
        for seed in refs.UNIFORM_SEEDS:
            want = draws[refs.uniform_key(d, seed)]
            got = torch.as_tensor(perturb.uniform(
                seed, refs.UNIFORM_SHAPE, getattr(torch, d)), device="cuda")
            check(np.array_equal(got.cpu().numpy().view(f"u{want.itemsize}"),
                                 want.view(f"u{want.itemsize}")),
                  f"phase 19d: the draw of seed {seed} in {d} is not JAX's")
    out = {}
    for name, kw in START_STATES.items():
        drv, state = setup_supercell_mmf(**{**GOLDEN_KW, **kw},
                                         dycore="spam", dtype=torch.float64,
                                         device="cuda")
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv.coupler, state, drv.dt_gcm)
        ref = np.load(os.path.join(GOLDEN, f"{name}_init.npz"))
        check(sorted(state) == sorted(ref.files), f"phase 19d {name}: keys")
        for k in ref.files:
            err, scale = refs.start_state_error(k, state[k].cpu().numpy(),
                                                ref, drv.dt_gcm)
            check(err <= 1e-14 * scale, f"phase 19d {name} {k}: {err:.3e} "
                  f"of {scale:.3e}")
            if k == "temp":
                out[name] = err / scale
    return out


def phase_19(setup_supercell_mmf, state_from_numpy, gcm_forcing, standalone,
             counters):
    """19a-d; returns 19b's launches by kernel."""
    from pam_tpu_torch.ops import tridiag
    from torch_jax_refs import tridiag_mode
    route = lambda mode: tridiag_mode(tridiag, mode)
    t0 = time.perf_counter()
    solves = phase_19a(setup_supercell_mmf, gcm_forcing, standalone, route)
    secs = [time.perf_counter() - t0]
    print("phase 19a one solve at the main path's shapes, PCR (the default "
          "on the card) / Thomas: us a solve by eager launches (by graph "
          "replay), launches a solve; max rel err PCR vs Thomas, PCR on the "
          "card vs the CPU: " + "; ".join(
              f"{d} {site} {rec['shape']} {rec['dtype']} " + " / ".join(
                  f"{rec[m][0]:.1f} ({rec[m][1]:.1f}) us {rec[m][2]:.0f}"
                  for m in ("pcr", "thomas"))
              + f", err {rec['err'][0]:.1e} {rec['err'][1]:.1e}"
              for (d, site), rec in solves.items()) + f"; {secs[0]:.1f} s",
          flush=True)
    runs = phase_19b(setup_supercell_mmf, state_from_numpy, counters)
    secs.append(time.perf_counter() - t0 - sum(secs))
    for name, (errs, counts) in runs.items():
        print(f"phase 19b {name} f64 on the default route, every solve PCR "
              f"({counts['pcr']} solves, {counts['thomas']} Thomas), B1 "
              f"{counts['weno_x']}, B4 {counts['p3_part2']}: max rel err vs "
              "pam_tpu's PCR run " + ", ".join(f"{k} {e:.2e}"
                                                for k, e in errs.items())
              + f"; 19b {secs[1]:.1f} s", flush=True)
    rows = phase_19c(counters, route)
    secs.append(time.perf_counter() - t0 - sum(secs))
    for row, (rec, counts, nsteps) in rows.items():
        print(f"phase 19c bench row {row} nens 128 f32, compiled, "
              f"{len(ROUTE_ORDER)} "
              f"reps of {ROUTE_STEPS} steps in turns "
              f"{'/'.join(ROUTE_ORDER)}, ms a step best / median, device ms "
              f"a step, launches a step ({ROUTE_TRACE_STEPS} traced): " +
              "; ".join(f"{m} {r[0]:.2f} / {r[1]:.2f}, device {r[2]:.3f}, "
                        f"{r[3]:.0f} launches" for m, r in rec.items()) +
              f"; counts in {nsteps} steps {counts}; 19c {secs[2]:.1f} s",
              flush=True)
    temp = phase_19d(setup_supercell_mmf, gcm_forcing)
    print("phase 19d the draw of tests/golden/perturb_uniform.npz bit for "
          "bit; setup_supercell_mmf on the card builds tests/golden/"
          "<name>_init.npz, every field within 1e-14: temp max rel err " +
          ", ".join(f"{k} {v:.1e}" for k, v in temp.items()) +
          f"; phase 19 {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: sum(c[k] for _, c in runs.values())
            for k in ("weno_x", "p3_part2")}


# phase 20: ensemble micro-batching (driver/mmf.py: a driver built at a
# chunk steps any multiple of it in chunks, as pam_tpu's does; run_mmf's
# ens_chunk; the benchmark route's chunked rows 2-4). 20a agreement on
# the card in f64 at 65x1x50, nens 8 as 4 chunks of 2: every chunked
# route bit for bit against the others and against each chunk stepped
# alone; P3+SHOC against the whole-ensemble step; Kessler, whose chunks
# take their own rainsplit counts, against it where the counts agree and
# apart where they differ. 20b peak memory and ms a step of the
# production config through run_mmf, one program against chunks of 1024.
# 20c the benchmark route's rows 2-4 whole (PAM_BENCH_NENS's route) at
# 18b's settings, beside 18b's chunked records; the production config
# without its ens_chunk (phase 13 runs it chunked)
#
# 20a: nens, chunk, dt_gcm of run's one GCM step (4 CRM steps), and the
# rain (kg/kg of dry density) in levels 25-44 of x columns 30-35 of each
# chunk's members, so that the chunks take rainsplit counts 1, 1, 2, 2
MB_NENS, MB_CHUNK, MB_DT_GCM = 8, 2, 80.0
MB_RAIN = (1e-4, 3e-3, 1e-2, 3e-2)
MB_TOL = 1e-9
# 20b: (nens, ens_chunk or None for one program) of
# configs/input_mmf_production.yaml, each one GCM step of MB_MEM_STEPS CRM
# steps, the first a warmup; one program of 8192 would need about 85 GB
# (10.4 MiB a member, PR 11's peaks), so it is not run
MB_MEM_CASES = ((4096, None), (4096, 1024), (8192, 1024))
MB_MEM_STEPS = 4

# phase 21: the compiled CRM step (MmfDriver._graphed_single: the step
# captured into one CUDA graph, ops/graph.py, its Kessler, P3
# sedimentation and AWFL loops decided on the device by CUDA WHILE nodes,
# csrc/graph_while.cu). 21a the three stacks at 65x1x50, nens 128 f32 and
# nens 8 f64, GRAPH_STEPS compiled steps against as many eager steps from
# setup_supercell_mmf's start state, bit for bit, with the same trip counts
# a step; a rainy Kessler state (rainsplit > 1); the PCR goldens through
# the compiled step. 21b the replays of 21a's nens 128 runs under
# set_sync_debug_mode("error"), the host launches of a compiled step and
# an eager step's synchronising calls (sync debug "warn") and device
# launches. 21c the benchmark route's rows on the eager route beside 18b's
# compiled records, and the production config through run_mmf on the
# eager route beside phase 13's compiled run. 21d the refusals: a host
# read in capture, a second shape, an earlier result after the next call,
# AWFL's range check on the device.
GRAPH_STACKS = (("Kessler", dict(micro="kessler")),
                ("P3+SHOC", dict(micro="p3", sgs="shoc")),
                ("AWFL+Kessler", dict(dycore="awfl", micro="kessler")))
GRAPH_CASES = ((128, torch.float32), (8, torch.float64))
GRAPH_STEPS = 10
# the rainy Kessler state: kg/kg of dry density in levels 25-44 of x
# columns 30-35 of every member (phase 20a's heaviest chunk)
GRAPH_RAIN = 3e-2
# 21c: the production config's eager run cut to one GCM step of 4 CRM
# steps (its file's 900 s GCM step is 45), the first a warmup, as 20b's
GRAPH_EAGER_GCM_S = 80.0
# the runtime calls that a host makes to launch work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                 "cuLaunchKernel", "cuLaunchKernelEx")


def trips():
    """(Kessler's last rainsplit, AWFL sub-cycles, P3 sedimentation
    rounds) since zero_trips, as ints."""
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.physics import kessler
    from pam_tpu_torch.physics.p3 import sedimentation
    return (int(kessler.kessler_column.rainsplit),
            int(AwflDycore.timestep.cycles),
            int(sedimentation.combined_sedimentation.rounds))


def zero_trips():
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.physics import kessler
    from pam_tpu_torch.physics.p3 import sedimentation
    kessler.kessler_column.rainsplit = 0
    AwflDycore.timestep.cycles = 0
    sedimentation.combined_sedimentation.rounds = 0


def both_routes(drv, state, nsteps, tag):
    """nsteps eager and nsteps compiled steps from ``state``, in turns;
    fails on any difference, per field with the step it first appeared
    in, its size and the trip counts of that step on both routes.
    Returns (eager trip counts a step, the compiled step, the compiled
    state, its capture s)."""
    step = drv._graphed_single()
    eager = compiled = state
    counts, first = [], {}
    for i in range(nsteps):
        zero_trips()
        eager = drv._crm_phys_step_single(eager)
        want = trips()
        zero_trips()
        compiled = step(compiled)
        got = trips()
        counts.append(want)
        for k in eager:
            if k not in first and not torch.equal(eager[k], compiled[k]):
                first[k] = (i + 1, float((eager[k].double()
                                          - compiled[k].double()).abs()
                                         .max()), want, got)
        check(got == want, f"{tag}: step {i + 1} trip counts (rainsplit, "
              f"sub-cycles, rounds) eager {want}, compiled {got}")
    step.check()
    check(not first, f"{tag}: the compiled step differs from the eager " +
          "; ".join(f"{k} from step {n} by {d:.3e} (trip counts eager {w}, "
                    f"compiled {g})" for k, (n, d, w, g) in first.items()))
    capture = sum(g.capture_s for g in step.graphs.values())
    return counts, step, compiled, capture


def launch_profile(fn, state, nsteps):
    """(state, device launches a step, host launch calls a step, {kernel:
    its launches in the trace}) of a torch.profiler trace of nsteps steps
    of fn, counted on the trace's raw events (the device launches as
    profile_step.py::device_totals counts them, the kernels by their
    trace names in ``_cuda.KERNELS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pam_tpu_torch.profile_step import device_totals, own_launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(nsteps):
            state = fn(state)
        torch.cuda.synchronize()
    host = sum(e.device_type() != DeviceType.CUDA and e.name() in HOST_LAUNCHES
               for e in prof.profiler.kineto_results.events())
    return (state, device_totals(prof, nsteps)[0], host / nsteps,
            own_launches(prof))


def memory_split(drv, state):
    """MiB allocated on the card above what was allocated before, from
    ``state``: the state itself, the peak of an eager step, the peak of
    the compiled step's first call (its warm-up step, the capture and a
    replay), what stays allocated after that call (the graph's static
    inputs and outputs and the returned state), the peak of a replay, and
    the growth of the reserved memory over the first call (the graph's
    private pool, the warm-up stream's cache)."""
    mib = 2 ** 20
    gc_cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = {"state": state_mib(state)}
    torch.cuda.reset_peak_memory_stats()
    drv._crm_phys_step_single(state)
    torch.cuda.synchronize()
    out["eager"] = (torch.cuda.max_memory_allocated() - base) / mib
    gc_cuda()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    step = drv._graphed_single()
    new = step(state)
    torch.cuda.synchronize()
    out["first"] = (torch.cuda.max_memory_allocated() - base) / mib
    out["held"] = (torch.cuda.memory_allocated() - base) / mib
    torch.cuda.reset_peak_memory_stats()
    new = step(new)
    torch.cuda.synchronize()
    out["replay"] = (torch.cuda.max_memory_allocated() - base) / mib
    out["reserved"] = (torch.cuda.memory_reserved() - reserved) / mib
    del new
    return out


def eager_syncs(fn, state):
    """(state, the synchronising calls that set_sync_debug_mode("warn")
    flags in one step of fn)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state = fn(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return state, sum("ynchroniz" in str(w.message) for w in seen)


def phase_21a(mmf, gcm_forcing, state_from_numpy, counters):
    """21a and 21b: prints a line a case."""
    from pam_tpu_torch.ops import tridiag
    from torch_jax_refs import PCR_TRAJECTORIES
    rainy = None
    for name, kw in GRAPH_STACKS:
        for nens, dtype in GRAPH_CASES:
            tag = f"phase 21a {name} nens {nens} {name_of(dtype)}"
            drv, st = mmf.setup_supercell_mmf(
                nens=nens, dtype=dtype, device="cuda",
                **{**FULL, "micro": "kessler", **kw})
            st = gcm_forcing.compute_gcm_forcing_tendencies(
                drv.coupler, st, drv.dt_gcm)
            if rainy is None:
                rainy = drv, dict(st)
            # what the graph adds to the peak (its capture below)
            mem = memory_split(drv, st) if nens == 128 else None
            counts, step, state, cap = both_routes(drv, st, GRAPH_STEPS, tag)
            healthy(state, tag, P3_WATER if "sgs" in kw else WATER)
            line = (f"{tag}: {GRAPH_STEPS} compiled steps equal "
                    f"{GRAPH_STEPS} eager steps bit for bit; trip counts a "
                    "step (rainsplit, AWFL sub-cycles, sedimentation "
                    f"rounds) {counts[0]} .. {counts[-1]} on both; capture "
                    f"{cap:.2f} s")
            if nens == 128:
                # 21b: the replays make no synchronising call
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(GRAPH_STEPS):
                        state = step(state)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                step.check()
                # the kernels' counts over two replays, which Graphed
                # adds from its capture, against the kernels the card ran:
                # B1 and B4, outside the loops, in the trace of the
                # replays; B3, in AWFL's WHILE body, which that trace can
                # leave out, in the trace of two eager steps from the same
                # state (the same trips: 21a holds both routes bit for bit)
                for obj, attr in counters.values():
                    setattr(obj, attr, 0)
                start = state
                state, _, host, traced = launch_profile(step, start, 2)
                counted = read_counts(counters)
                for obj, attr in counters.values():
                    setattr(obj, attr, 0)
                _, dev, _, eager = launch_profile(drv._crm_phys_step_single,
                                                  start, 2)
                counted_eager = read_counts(counters)
                del start
                check(sum(eager.values()) > 0 and counted == counted_eager
                      and all(counted[k] == n for k, n in eager.items())
                      and all(counted[k] == traced[k]
                              for k in ("weno_x", "p3_part2")),
                      f"{tag}: kernel launches of 2 steps counted compiled "
                      f"{counted}, eager {counted_eager}; in the trace of "
                      f"the replays {traced}, of the eager steps {eager}")
                state, syncs = eager_syncs(drv._crm_phys_step_single, state)
                check(1 <= host < 100 and dev > 1000,
                      f"{tag}: {host} host launch calls a compiled step, "
                      f"{dev} device launches an eager step")
                line += (f"; 21b {GRAPH_STEPS} replays under "
                         "set_sync_debug_mode('error'): 0 synchronising "
                         f"calls a step, {host:.0f} host launch calls a "
                         f"compiled step (replay and copies) against {dev:.0f}"
                         f" device launches and {syncs} synchronising calls "
                         "(sync debug 'warn') an eager step; kernel "
                         "launches of 2 steps, compiled counted = eager "
                         "counted = eager traced: " + ", ".join(
                             f"{k} {n}" for k, n in eager.items())
                         + "; in the trace of the replays: " + ", ".join(
                             f"{k} {n}" for k, n in traced.items())
                         + "; MiB above the start: the state "
                         f"{mem['state']:.1f}, an eager step's peak "
                         f"{mem['eager']:.1f}, the first compiled call's "
                         f"(warm-up, capture, replay) {mem['first']:.1f}, "
                         f"held after it {mem['held']:.1f}, a replay's peak "
                         f"{mem['replay']:.1f}, reserved +"
                         f"{mem['reserved']:.1f}")
            print(line, flush=True)
            del drv, st, step, state
            gc_cuda()
    # a rainy Kessler state (the first case's driver and start state): the
    # sub-cycle loop runs more than one trip
    drv, st = rainy
    pr = torch.zeros_like(st["precip_liquid"])
    pr[:, 25:45, :, 30:36] = GRAPH_RAIN * st["density_dry"][:, 25:45, :,
                                                            30:36]
    st["precip_liquid"] = pr
    tag = "phase 21a rainy Kessler nens 128 f32"
    counts, _, state, _ = both_routes(drv, st, GRAPH_STEPS, tag)
    splits = [c[0] for c in counts]
    check(max(splits) > 1, f"{tag}: rainsplit {splits}")
    healthy(state, tag)
    print(f"{tag}: {GRAPH_STEPS} compiled steps equal the eager steps bit "
          f"for bit; rainsplit a step {splits} on both", flush=True)
    del drv, st, state, rainy
    # the PCR goldens through the compiled step, as phase 19b the eager
    check(tridiag._TRIDIAG_MODE == "auto", "phase 21a: PAM_TRIDIAG is "
          f"{tridiag._TRIDIAG_MODE!r}, not the default")
    errs = {}
    for name, nsteps, _, stem in PCR_TRAJECTORIES:
        drv, _ = mmf.setup_supercell_mmf(**{**GOLDEN_KW, **START_STATES[name]},
                                         dycore="spam", dtype=torch.float64,
                                         device="cuda")
        state = state_from_numpy(dict(np.load(os.path.join(
            GOLDEN, f"{name}_init.npz"))), "cuda", torch.float64)
        step = drv._graphed_single()
        for _ in range(nsteps):
            state = step(state)
        step.check()
        errs[stem] = max(golden_errors(state, stem, {}).values())
    print("phase 21a the PCR goldens through the compiled step, f64, 16x1x12 "
          "nens 2: max rel err " + ", ".join(f"{k} {e:.2e}"
                                             for k, e in errs.items()),
          flush=True)
    gc_cuda()


def phase_21c(standalone, mmf, counters, smi_line, bench_recs, production):
    """21c: the benchmark rows on the eager route at 18b's settings beside
    18b's compiled records; the production config through run_mmf on the
    eager route (one GCM step) beside phase 13's compiled run."""
    import io
    from pam_tpu_torch import bench
    gc_cuda()
    with eager_route():
        eager = bench.run(bench.Settings(**BENCH_ROWS), out=io.StringIO())
    for g, e in zip(bench_recs, eager):
        # a record of the eager route captured no graph
        check(g["config"] == e["config"] and e["capture_s"] is None
              and g["capture_s"] > 0, f"phase 21c: {g} / {e}")
        print(f"phase 21c bench row {g['config']} at 18b's settings, "
              "compiled (18b) / eager: ms a step "
              f"{g['ms_per_step']:.2f} / {e['ms_per_step']:.2f}, device ms "
              f"{dev_ms(g)} / {dev_ms(e)}"
              f", peak {g['peak_mib']:.1f} / {e['peak_mib']:.1f} MiB, first "
              f"step {g['first_step_s']:.2f} / {e['first_step_s']:.2f} s, "
              f"capture {g['capture_s']:.2f} s; {smi_line}", flush=True)
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
        line, _, stats = run_config(standalone, mmf, counters, "production",
                                    tmp, eager=True,
                                    dt_gcm=GRAPH_EAGER_GCM_S,
                                    sim_time=GRAPH_EAGER_GCM_S)
    print("phase 21c configs/input_mmf_production.yaml through run_mmf on "
          "the Thomas route as phase 13, compiled (phase 13, 2 GCM steps of "
          "45 CRM steps) / eager (1 GCM step of "
          f"{GRAPH_EAGER_GCM_S:g} s): mean ms a step "
          f"{production[1]['mean']:.2f} / "
          f"{stats['mean']:.2f}, median {production[1]['median']:.2f} / "
          f"{stats['median']:.2f}, peak {production[1]['peak']:.1f} / "
          f"{stats['peak']:.1f} MiB ({line}); {smi_line}", flush=True)
    gc_cuda()


def phase_21d(mmf, gcm_forcing):
    """21d: the compiled step's refusals, SPAM+SI Kessler and AWFL+Kessler
    at 16x1x12 nens 2, f64."""
    from pam_tpu_torch.ops import graph
    kw = dict(GOLDEN_KW, dtype=torch.float64, device="cuda")
    drv, st = mmf.setup_supercell_mmf(**kw, dycore="spam")
    st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st,
                                                    drv.dt_gcm)

    def reads(state):
        out = drv._crm_phys_step_single(state)
        float(out["temp"].max())
        return out
    named = None
    try:
        graph.GraphedFunction(reads)(st)
    except graph.CaptureError as e:
        named = str(e)
    check(named is not None and "Tensor.__float__" in named
          and "chip_smoke.py" in named,
          f"phase 21d: a host read in capture gave {named!r}")
    step = drv._graphed_single()
    first = step(st)
    kept = {k: v.clone() for k, v in first.items()}
    second = step(first)
    check(mb_same(first, kept) and not mb_same(first, second),
          "phase 21d: the next call changed an earlier result")
    half = {k: v[:1].clone() for k, v in st.items()}
    got = step(half)
    check(len(step.graphs) == 2
          and mb_same(got, drv._crm_phys_step_single(half))
          and mb_same(second, drv._crm_phys_step_single(
              drv._crm_phys_step_single(st))),
          f"phase 21d: {len(step.graphs)} graphs for two shapes")
    adrv, ast = mmf.setup_supercell_mmf(**kw, dycore="awfl")
    ast = gcm_forcing.compute_gcm_forcing_tendencies(adrv.coupler, ast,
                                                     adrv.dt_gcm)
    bad = dict(ast, temp=ast["temp"] * float("nan"))
    astep = adrv._graphed_single()
    astep(ast)       # captured on a sound state, then replayed on NaNs
    msgs = []
    for route in ("eager", "compiled"):
        try:
            if route == "eager":
                adrv._crm_phys_step_single(bad)
            else:
                astep(bad)
                astep.check()
        except FloatingPointError as e:
            msgs.append(str(e))
    check(len(msgs) == 2 and msgs[0] == msgs[1],
          f"phase 21d: AWFL's range check {msgs}")
    print(f"phase 21d refusals: a host read in capture raises ({named[:160]}"
          "...); a second shape captures a second graph; an earlier result "
          "survives the next call; AWFL's range check read after the "
          f"replay raises as the eager step does ({msgs[1]})", flush=True)


def phase_21(mmf, gcm_forcing, state_from_numpy, standalone, counters,
             smi_line, bench_recs, production):
    t0 = time.perf_counter()
    phase_21a(mmf, gcm_forcing, state_from_numpy, counters)
    secs = [time.perf_counter() - t0]
    phase_21c(standalone, mmf, counters, smi_line, bench_recs, production)
    secs.append(time.perf_counter() - t0 - secs[0])
    phase_21d(mmf, gcm_forcing)
    print(f"phase 21 {time.perf_counter() - t0:.1f} s (21a-b {secs[0]:.1f}, "
          f"21c {secs[1]:.1f})", flush=True)


def mb_err(k, ref, got, dt_gcm):
    """Max |got - ref| over the field's largest |value|; a forcing
    tendency over its source's scale over dt_gcm (the temperature, the
    wind, else the dry density): most are differences of equal columns."""
    src = {"gcm_forcing_tend_temp": "temp", "gcm_forcing_tend_uvel": "uvel",
           "gcm_forcing_tend_vvel": "uvel"}.get(k, "density_dry")
    scale = float(ref[k].abs().max())
    if k.startswith("gcm_forcing_tend_"):
        scale = max(scale, float(ref[src].abs().max()) / dt_gcm)
    return float((ref[k] - got[k]).abs().max()) / max(scale, 1e-300)


def mb_same(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def phase_20a(mmf, gcm_forcing, counters):
    """The chunked routes in f64: returns {case: summary}."""
    import dataclasses
    from pam_tpu_torch.physics import kessler
    n = MB_NENS // MB_CHUNK
    out = {}
    for name, micro, sgs in (("Kessler", "kessler", "none"),
                             ("P3+SHOC", "p3", "shoc")):
        kw = dict(FULL, micro=micro, sgs=sgs, dt_gcm=MB_DT_GCM,
                  dtype=torch.float64, device="cuda")
        whole, st = mmf.setup_supercell_mmf(nens=MB_NENS, **kw)
        st = gcm_forcing.compute_gcm_forcing_tendencies(whole.coupler, st,
                                                        whole.dt_gcm)
        if micro == "kessler":
            pr = torch.zeros_like(st["precip_liquid"])
            for i, q in enumerate(MB_RAIN):
                m = slice(i * MB_CHUNK, (i + 1) * MB_CHUNK)
                pr[m, 25:45, :, 30:36] = q * st["density_dry"][m, 25:45, :,
                                                               30:36]
            st["precip_liquid"] = pr
        drv, _ = mmf.setup_supercell_mmf(nens=MB_CHUNK, **kw)
        torch.cuda.synchronize()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        auto = drv.crm_phys_step(st)
        counts = read_counts(counters)
        check(counts["weno_x"] == WENO_CALLS_PER_STEP * n
              and counts["p3_part2"] == (n if micro == "p3" else 0),
              f"phase 20a {name}: one chunked step launched {counts}")
        routes = {"crm_phys_step_microbatched":
                  drv.crm_phys_step_microbatched(st, n),
                  "crm_phys_step_hostchunked":
                  drv.crm_phys_step_hostchunked(st)}
        chunks = mmf._split_ens(st, n)
        alone, rainsplit = [], []
        for c in chunks:
            alone.append(drv.crm_phys_step(c))
            rainsplit.append(int(kessler.kessler_column.rainsplit))
        alone = mmf._join_ens(alone)
        check(mb_same(auto, alone) and all(mb_same(r, alone)
                                           for r in routes.values()),
              f"phase 20a {name}: a chunked step is not the chunks alone "
              "bit for bit")
        run_host = drv.run(st, MB_DT_GCM)
        run_unrolled = dataclasses.replace(drv, mb_mode="unrolled").run(
            st, MB_DT_GCM)
        run_alone = mmf._join_ens([drv.run(c, MB_DT_GCM) for c in chunks])
        check(mb_same(run_host, run_alone)
              and mb_same(run_unrolled, run_alone),
              f"phase 20a {name}: run's modes are not the chunks run alone "
              "bit for bit")
        ref = whole.crm_phys_step(st)
        whole_split = int(kessler.kessler_column.rainsplit)
        healthy(ref, f"phase 20a {name}", WATER if micro == "kessler"
                else P3_WATER)
        per_chunk = []
        for i in range(n):
            m = slice(i * MB_CHUNK, (i + 1) * MB_CHUNK)
            part = {k: v[m] for k, v in ref.items()}
            got = {k: v[m] for k, v in auto.items()}
            per_chunk.append(max(mb_err(k, part, got, MB_DT_GCM)
                                 for k in ref))
        if micro == "kessler":
            check(len(set(rainsplit)) > 1 and whole_split == max(rainsplit),
                  f"phase 20a: rainsplit counts {rainsplit}, whole "
                  f"{whole_split}")
            for i, (r, e) in enumerate(zip(rainsplit, per_chunk)):
                m = slice(i * MB_CHUNK, (i + 1) * MB_CHUNK)
                rain = mb_err("precip_liquid",
                              {"precip_liquid": ref["precip_liquid"][m]},
                              {"precip_liquid": auto["precip_liquid"][m]},
                              MB_DT_GCM)
                check((r == whole_split and e < MB_TOL)
                      or (r != whole_split and rain > 1e-10),
                      f"phase 20a Kessler chunk {i}: rainsplit {r} (whole "
                      f"{whole_split}), max err {e:.3e}, rain {rain:.3e}")
        else:
            check(max(per_chunk) < MB_TOL,
                  f"phase 20a P3+SHOC chunked vs whole: {per_chunk}")
        out[name] = dict(counts=counts, rainsplit=rainsplit,
                         whole_split=whole_split, per_chunk=per_chunk)
        del whole, drv, st, auto, routes, chunks, alone, ref
        del run_host, run_unrolled, run_alone
        gc_cuda()
    return out


def gc_cuda():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def state_mib(state):
    """MiB of the storages that a state holds, each counted once (a field
    may be a view of a larger buffer)."""
    held = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
            for v in state.values()}
    return sum(held.values()) / 2**20


def phase_20b(standalone, mmf, counters):
    """configs/input_mmf_production.yaml through run_mmf at MB_MEM_CASES
    (nens and ens_chunk changed, dt_gcm MB_MEM_STEPS CRM steps, one GCM
    step, no output), every counter at 0 just before: {(nens, chunk):
    (peak MiB, the final state's MiB, ms a CRM step, B1 and B4 launches
    a CRM step, s)}."""
    base = standalone.load_config(os.path.join(
        ROOT, "configs", "input_mmf_production.yaml"))
    out = {}
    for nens, chunk in MB_MEM_CASES:
        gc_cuda()
        cfg = dict(base, nens=nens, ens_chunk=chunk, out_freq=-1.0,
                   dt_gcm=MB_MEM_STEPS * base["dt_crm_phys"])
        cfg["sim_time"] = cfg["dt_gcm"]
        n = nens // (chunk or nens)
        tag = f"phase 20b nens {nens} chunk {chunk}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        t0 = time.perf_counter()
        with timed_chunk_steps() as ev:
            st = standalone.run_mmf(cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        check(len(ev) == MB_MEM_STEPS * n,
              f"{tag}: {len(ev)} chunk steps, not {MB_MEM_STEPS} x {n}")
        ms = crm_step_ms(ev, n)
        counts = {k: v / MB_MEM_STEPS
                  for k, v in read_counts(counters).items()}
        check(counts["weno_x"] == WENO_CALLS_PER_STEP * n
              and counts["p3_part2"] == n, f"{tag}: {counts} a step")
        check(int(st["temp"].shape[0]) == nens, f"{tag}: nens of the state")
        healthy(st, tag, P3_WATER)
        out[(nens, chunk)] = (peak, state_mib(st), float(np.mean(ms[1:])),
                              counts, secs)
        del st
    gc_cuda()
    return out


def phase_20c(counters, smi_line, chunked_rows):
    """The benchmark route's rows 2-4 whole, at 18b's settings, beside
    18b's records of them chunked (``chunked_rows``: phase_18's): {config:
    {way: (record, B1 and B4 launches a step)}}."""
    import dataclasses
    from pam_tpu_torch import bench
    s = bench.Settings(**BENCH_ROWS)
    out = {}
    for row, rec, launched in chunked_rows:
        steps = 1 + bench.WARMUP + s.reps * row.steps + s.trace_steps
        whole = dataclasses.replace(row, chunk=None,
                                    extra=f",nens={row.nens}")
        gc_cuda()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        got = bench.run_row(s, whole, smi_line)
        ways = {"chunked": (rec, launched),
                "whole": (got, read_counts(counters))}
        for way, (r, c) in ways.items():
            n = row.nens // (row.chunk if way == "chunked" else row.nens)
            c = {k: v / steps for k, v in c.items()}
            check(c["weno_x"] == WENO_CALLS_PER_STEP * n
                  and c["p3_part2"] == (n if row.micro == "p3" else 0)
                  and r["device_ms_per_step"] > 0 and r["peak_mib"] > 0,
                  f"phase 20c {r['config']} {way}: {c} a step, {r}")
            ways[way] = (r, c)
        out[row.config] = ways
    gc_cuda()
    return out


def phase_20(mmf, gcm_forcing, standalone, counters, chip, production,
             chunked_rows):
    """20a-c; ``production``: phase 13's chunked run of the production
    config (its summary and stats); ``chunked_rows``: 18b's chunked rows.
    Returns 20a's launches."""
    t0 = time.perf_counter()
    agree = phase_20a(mmf, gcm_forcing, counters)
    secs = [time.perf_counter() - t0]
    for name, r in agree.items():
        print(f"phase 20a {name} f64 65x1x50 nens {MB_NENS} as "
              f"{MB_NENS // MB_CHUNK} chunks of {MB_CHUNK}: the automatic "
              "route, crm_phys_step_microbatched, crm_phys_step_hostchunked "
              "and the chunks stepped alone bit for bit, run's host and "
              "unrolled modes and the chunks run alone bit for bit (1 GCM "
              f"step of {MB_DT_GCM:g} s); one chunked step B1 "
              f"{r['counts']['weno_x']} B4 {r['counts']['p3_part2']}; "
              + (f"rainsplit by chunk {r['rainsplit']}, whole "
                 f"{r['whole_split']}; " if name == "Kessler" else "")
              + "max rel err vs the whole-ensemble step by chunk "
              + ", ".join(f"{e:.2e}" for e in r["per_chunk"])
              + f"; {chip}", flush=True)
    mem = phase_20b(standalone, mmf, counters)
    secs.append(time.perf_counter() - t0 - sum(secs))
    print("phase 20b configs/input_mmf_production.yaml (P3+SHOC SPAM+SI "
          "65x1x50 f32) through run_mmf on the default route, 1 GCM step of "
          f"{MB_MEM_STEPS} CRM steps, the first a warmup (CUDA events), peak "
          "from setup to the returned state: " + "; ".join(
              f"nens {nens} " + (f"as {nens // c} chunks of {c}" if c
                                 else "in one program")
              + f": peak {p:.1f} MiB (final state {sm:.1f} MiB), {ms:.2f} "
              f"ms a step, B1 {cn['weno_x']:g} B4 {cn['p3_part2']:g} a step "
              f"({t:.1f} s)"
              for (nens, c), (p, sm, ms, cn, t) in mem.items())
          + f"; {chip}; 20b {secs[1]:.1f} s", flush=True)
    rows = phase_20c(counters, chip, chunked_rows)
    for config, rec in rows.items():
        print(f"phase 20c bench row {config} at 18b's settings "
              f"({json.dumps(BENCH_ROWS)}), chunked (18b) / whole: "
              + "; ".join(
                  f"{way} {g['ms_per_step']:.2f} ms a step (median "
                  f"{g['ms_per_step_median']:.2f}), device "
                  f"{g['device_ms_per_step']:.3f}, peak {g['peak_mib']:.1f} "
                  f"MiB, first step {g['first_step_s']:.2f} s, B1 "
                  f"{c['weno_x']:g} B4 {c['p3_part2']:g} a step"
                  for way, (g, c) in rec.items())
              + f"; {chip}", flush=True)
    secs.append(time.perf_counter() - t0 - sum(secs))
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
        line, _, stats = run_config(standalone, mmf, counters, "production",
                                    tmp, ens_chunk=None)
    secs.append(time.perf_counter() - t0 - sum(secs))
    print(f"phase 20c configs/input_mmf_production.yaml, 2 GCM steps, both "
          "on the Thomas route as phase 13 (not the card's default, PCR): "
          f"with its ens_chunk (phase 13) {production[1]['mean']:.2f} ms a "
          f"step mean, {production[1]['median']:.2f} median, peak "
          f"{production[1]['peak']:.1f} MiB, {production[1]['wall']:.2f} s; "
          f"without: {stats['mean']:.2f} mean, {stats['median']:.2f} median"
          f", peak {stats['peak']:.1f} MiB, {stats['wall']:.2f} s ({line}); "
          f"{chip}; phase 20 {time.perf_counter() - t0:.1f} s (20a "
          f"{secs[0]:.1f}, 20b {secs[1]:.1f}, 20c rows {secs[2]:.1f}, "
          f"production {secs[3]:.1f})", flush=True)
    return {k: sum(r["counts"][k] for r in agree.values())
            for k in ("weno_x", "p3_part2")}


def main():
    # 1. environment: a card and the package, before anything is printed
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver import mmf, standalone
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    from pam_tpu_torch.profile_step import cards
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.ops import (awfl_fct, awfl_flux, p3_part2, weno,
                                   weno_x, weno_z)
    from pam_tpu_torch.physics.p3 import main as p3main, sedimentation
    from pam_tpu_torch.utils import gw_verification
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))   # the numpy oracles
    import make_torch_golden_init as golden
    chip = cards()[0]      # name and power limit, as nvidia-smi gives them
    print(chip)
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    # every kernel's launch counter, by its key in _cuda.KERNELS, and the
    # loops' trip counters
    kernels = {k.key: (k.launcher_fn(), "launches") for k in _cuda.KERNELS}
    sed_count = (sedimentation.combined_sedimentation, "rounds")
    cycle_count = (AwflDycore.timestep, "cycles")
    with_cycles = {**kernels, "sub_cycles": cycle_count}

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

    # 3b. Z1 (z-WENO kernel) vs plain on the card, through the model's route
    z1 = phase_z1(weno, weno_z, standalone.build_zint)
    print("phase 3b Z1 vs plain through _edge_recon_z at the cells' calls "
          "(nens 128, the configs' levels): us/call kernel by graph replay "
          "(by eager launches) / plain (bound, by), max abs err: " + "; ".join(
              f"{case} {shape} {name_of(Z1_DTYPE[case])} {grid} "
              f"{k * 1e3:.2f} ({h * 1e3:.2f}) / {p * 1e3:.2f} "
              f"({b[0] * 1e3:.2f}, {b[1]}), {e:.3e}"
              for (case, grid), (k, h, p, b, e, shape) in z1.items()),
          flush=True)

    # 4. Kessler golden trajectory on the card, f64, through the kernel
    weno_x.weno_edges_x_cuda.launches = 0
    with thomas_route():
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
                                  kernels, nens, dtype, nsteps, WATER)
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP
              and counts["weno_z"] == nsteps * Z1_CALLS_PER_STEP,
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
    for obj, attr in (kernels["weno_x"], kernels["p3_part2"], sed_count):
        setattr(obj, attr, 0)
    with thomas_route():
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
            {**kernels, "sed_rounds": sed_count}, nens, dtype, nsteps,
            P3_WATER, micro="p3", sgs="shoc")
        check(counts["weno_x"] == nsteps * WENO_CALLS_PER_STEP
              and counts["weno_z"] == nsteps * Z1_CALLS_PER_STEP
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

    # 9b. the FCT limiter's kernel vs plain on the card
    fct = phase_fct(awfl_fct)
    print("phase 9b FCT kernel vs plain, dt a 0-d tensor: us/call kernel by "
          "graph replay (by eager launches) / plain by graph replay (bound "
          "from bytes), ulp from the plain version on the card, faces "
          "differing from the plain version on the CPU, cells limited: " +
          "; ".join(f"{d} {c} {k * 1e3:.2f} ({h * 1e3:.2f}) / {p * 1e3:.2f} "
                    f"({b[0] * 1e3:.2f}), {u:.2f} ulp, {n} faces, "
                    f"{share:.2f}"
                    for (d, c), (k, h, p, b, u, n, share) in fct.items()),
          flush=True)

    # 10. AWFL+Kessler reference trajectory on the card, f64, 5 steps
    #     through the kernels
    for obj, attr in (kernels["awfl_flux"], kernels["awfl_fct"],
                      cycle_count):
        setattr(obj, attr, 0)
    state = golden_run(setup_supercell_mmf, state_from_numpy, "awfl_kessler",
                       nsteps=5, dycore="awfl")
    cycles = AwflDycore.timestep.cycles
    check(cycles >= 5 and awfl_flux.flux_direction_cuda.launches
          == cycles * FLUX_CALLS_PER_CYCLE
          and awfl_fct.fct_limit_cuda.launches == cycles * FCT_PER_CYCLE,
          f"AWFL golden run: {awfl_flux.flux_direction_cuda.launches} B3 "
          f"and {awfl_fct.fct_limit_cuda.launches} FCT launches in "
          f"{cycles} sub-cycles")
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
            setup_supercell_mmf, gcm_forcing, with_cycles, nens, dtype,
            nsteps, WATER, dycore="awfl")
        check(counts["sub_cycles"] >= nsteps and counts["awfl_flux"]
              == counts["sub_cycles"] * FLUX_CALLS_PER_CYCLE
              and counts["awfl_fct"] == counts["sub_cycles"] * FCT_PER_CYCLE,
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
    weno_z.weno_edges_z_cuda.launches = 0
    with thomas_route():
        for _ in range(10):
            state = drv.crm_phys_step(state)
    check(weno_x.weno_edges_x_cuda.launches == 10 * WENO_CALLS_PER_STEP
          and weno_z.weno_edges_z_cuda.launches == 10 * Z1_CALLS_PER_STEP,
          f"phase 12: {weno_x.weno_edges_x_cuda.launches} x-WENO and "
          f"{weno_z.weno_edges_z_cuda.launches} Z1 launches")
    gerr = golden_errors(state, "mmf_pamc_small", {})
    operr = golden_errors(state, "mmf_pamc_small_opbyop", {})
    print(f"phase 12 stretched SPAM f64 10 steps, "
          f"{weno_x.weno_edges_x_cuda.launches} x-WENO and "
          f"{weno_z.weno_edges_z_cuda.launches} Z1 launches (per-level "
          "matrices): max rel err "
          "vs pam_tpu jitted " + ", ".join(f"{k} {e:.2e}"
                                            for k, e in gerr.items()) +
          "; vs op by op " + ", ".join(f"{k} {e:.2e}"
                                       for k, e in operr.items()),
          flush=True)
    del drv, state

    # 13. the four standalone configs through run_mmf at 65x1x50, each as
    #     its file sets it (nens, dtype, dycore, physics, ens_chunk, 2 GCM
    #     steps of 45 CRM steps), each with the counters at 0 just before it
    z1_launches = {}
    with tempfile.TemporaryDirectory() as tmp, thomas_route():
        for name in MMF_CONFIGS:
            line, counts, stats = run_config(standalone, mmf, with_cycles,
                                             name, tmp)
            z1_launches[name] = counts["weno_z"]
            if name == "production":
                production = (line, stats)
            print(f"phase 13 run_mmf on the compiled route {line}",
                  flush=True)

    phase_14(standalone, weno_x, golden, gw_verification)
    launches_3d = phase_15(standalone, weno_x, golden,
                           (setup_supercell_mmf, state_from_numpy,
                            gcm_forcing, kernels["weno_x"]))
    launches_16 = phase_16(standalone, weno_x, golden, setup_supercell_mmf)
    sharded = phase_17(standalone, weno, weno_x)
    pad32 = sharded["b1"][("float32", 32000, 65)]
    bench_launches, chunked_rows, bench_recs = phase_18(
        chip, with_cycles, sharded["counts_17c"])
    solve_launches = phase_19(setup_supercell_mmf, state_from_numpy,
                              gcm_forcing, standalone, kernels)
    chunked_launches = phase_20(mmf, gcm_forcing, standalone, with_cycles,
                                chip, production, chunked_rows)
    phase_21(mmf, gcm_forcing, state_from_numpy, standalone, with_cycles,
             chip, bench_recs, production)

    # the kernels' record: float32 times at the main path's shapes (B4
    # with cloud, rain and ice each at half of the points); no single
    # PyTorch call computes any of the three functions
    k32, _, p32 = timing["float32"]
    b32, _, bp32 = b4_timing[("float32", 0.5)]
    b1_bound = b1_bounds["float32"]
    b4_bound = b4_bounds["float32"]
    # Z1: the production density call on the configs' levels, the
    # largest of the main path's six a chunk step, the rest beside it
    z1_main = z1[("production densities", "per-level")]
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
         "bound_ms_padded": pad32[2],
         "launches_bench": bench_launches["weno_x"],
         "launches_pcr": solve_launches["weno_x"],
         "launches_chunked": chunked_launches["weno_x"]},
        {"name": "p3_part2", "route": "cuda",
         "source": "pam_tpu_torch/csrc/p3_part2.cu",
         "replaces": "pam_tpu/physics/p3/main.py:780",
         "launches": main_counts["p3_part2"],
         "max_abs_err": max(e for (d, _, _), (e, _) in b4_errs.items()
                            if d == "float64"),
         "ms": b32, "plain_ms": bp32, "bound_ms": b4_bound[0],
         "bound_by": b4_bound[1], "library_ms": None,
         "launches_sharded": sharded["p3_part2"],
         "launches_bench": bench_launches["p3_part2"],
         "launches_pcr": solve_launches["p3_part2"],
         "launches_chunked": chunked_launches["p3_part2"]},
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
         "launches_sharded": sharded["awfl_flux"],
         "launches_bench": bench_launches["awfl_flux"]},
        {"name": "awfl_fct", "route": "cuda",
         "source": "pam_tpu_torch/csrc/awfl_fct.cu",
         "replaces": "pam_tpu/dycore/awfl.py:399-445 (XLA-fused, no TPU "
                     "kernel)",
         "launches": awfl_counts["awfl_fct"],
         "max_ulps": max(r[4] for r in fct.values()),
         "faces_off_cpu": sum(r[5] for r in fct.values()),
         "ms": fct[("float64", "cell")][0],
         "plain_ms": fct[("float64", "cell")][2],
         "bound_ms": fct[("float64", "cell")][3][0], "bound_by": "bytes",
         "library_ms": None,
         "calls": {f"{d} {c}": {"ms": k, "ms_eager": h, "plain_ms": p,
                                "bound_ms": b[0], "ulps": u,
                                "faces_off_cpu": n}
                   for (d, c), (k, h, p, b, u, n, _) in fct.items()},
         "launches_bench": bench_launches["awfl_fct"]},
        {"name": "weno_z", "route": "cuda",
         "source": "pam_tpu_torch/csrc/weno_z.cu",
         "replaces": "pam_tpu/spam/tendencies.py:61 (XLA-fused, no TPU "
                     "kernel)",
         "launches": z1_launches["production"],
         "max_abs_err": max(r[4] for r in z1.values()),
         "ms": z1_main[0], "plain_ms": z1_main[2],
         "bound_ms": z1_main[3][0], "bound_by": z1_main[3][1],
         "library_ms": None,
         "calls": {f"{case} {grid}": {
             "shape": list(shape), "ms": k, "ms_eager": h, "plain_ms": p,
             "bound_ms": b[0], "max_abs_err": e}
             for (case, grid), (k, h, p, b, e, shape) in z1.items()},
         "launches_pamc": z1_launches["pamc"],
         "launches_eager": main_counts["weno_z"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

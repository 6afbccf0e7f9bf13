"""Times of the CUDA kernels on the card, at the main path's shapes, one
group a row of ``_cuda.KERNELS`` named by its short name: the
periodic-x edge reconstruction (B1) at (32000, 65), the AWFL
directional flux (B3) at 65x1x50, nens 128, three tracers, in x, in z
and in z with a matrix set per member, P3 part 2 (B4) at (50, 65, 128)
with cloud, rain and ice each at half of the points and at 2% of them,
the SPAM slab's vertical edge reconstruction (Z1) at the benchmark
cells' calls, and the AWFL FCT limiter (F1) at the PAM-A cell's call;
float32 and float64; microseconds of device time per call, the launches
replayed from a CUDA graph between two CUDA events.

    python pam_tpu_torch/kernel_times.py                # this checkout
    python pam_tpu_torch/kernel_times.py --compare DIR  # against another
    python pam_tpu_torch/kernel_times.py --sass         # instructions

``--compare DIR`` times the checkout at DIR (another commit of this
repository that has the kernel table, unpacked with ``git archive``) and
this one in turns, other, this, this, other, each in a process of its own
on the same card, and prints both columns: two versions are compared
inside one call only. ``--sass`` counts the instructions of each kernel
in the built libraries (``cuobjdump -sass``). Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
B3_SHAPE = (128, 1, 50, 65, 3)      # nens, ny, nz, nx, tracers
B4_SHAPE = (50, 65, 128)
# published issue rates of one H100 SXM at its 1.98 GHz boost clock: 132
# SMs, 4 warp instructions a clock each, 2 of them float64
SMS, WARP_INSTR_PER_CLOCK, FP64_PER_CLOCK, CLOCK_HZ = 132, 4, 2, 1.98e9


def cuda_ms(torch, fn, reps, per_graph=20):
    """Mean milliseconds of device time per call of fn: per_graph calls
    are captured into one CUDA graph, and the graph is replayed until
    reps calls have run. Launched one by one from Python these kernels
    would be timed at the host's launch rate, which is slower than they
    are."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    replays = max(1, reps // per_graph)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def b1_times(torch, dtype, reps):
    """{case: ms a call} of B1 at (32000, 65)."""
    import numpy as np
    from pam_tpu_torch.ops import weno, weno_x
    tb = weno.weno_tables(5, dtype)
    f = torch.as_tensor(np.random.default_rng(0).standard_normal((32000, 65)),
                        dtype=dtype, device="cuda")
    return {"": cuda_ms(torch, lambda: weno_x.weno_edges_x_cuda(f, tb), reps)}


def b3_times(torch, dtype, reps):
    """{case: ms a call} of B3 at B3_SHAPE: x, z, z with a matrix set per
    member."""
    from chip_smoke import b3_inputs
    from pam_tpu_torch.ops import awfl_flux, weno
    tb = weno.weno_tables(5, dtype)
    out = {}
    for case, axis, member_dz in (("x", awfl_flux.AX_X, False),
                                  ("z", awfl_flux.AX_Z, False),
                                  ("z member dz", awfl_flux.AX_Z, True)):
        nens, ny, nz, nx, ntr = B3_SHAPE
        prim, trac, pres, levels = b3_inputs(
            nens, ny, nz, nx, ntr, axis, dtype, "cuda", seed=axis + ntr,
            member_dz=member_dz)
        out[case] = cuda_ms(torch, lambda: awfl_flux.flux_direction_cuda(
            prim, trac, pres, axis, tb, levels), reps)
    return out


def b4_times(torch, dtype, reps):
    """{case: ms a call} of P3 part 2 at B4_SHAPE, cloud, rain and ice
    each at half of the points and at 2% of them."""
    from pam_tpu_torch.ops import p3_part2
    out = {}
    for present in (0.5, 0.02):
        args = p3_part2.cast_inputs(p3_part2.sample_inputs(
            B4_SHAPE, torch.float64, "cuda", seed=11, present=present), dtype)
        name = "part 2" + ("" if present == 0.5 else f" present {present}")
        out[name] = cuda_ms(torch, lambda: p3_part2.p3_part2_cuda(*args),
                            reps)
    return out


def z1_times(torch, dtype, reps):
    """{case: ms a call} of the vertical edge reconstruction at the calls
    of the benchmark's cells, the configs' 50 stretched levels, nens 128:
    densities (12 in float32 as production has, 5 in float64 as PAM-C
    Kessler) and PV, on the per-level matrices, on the uniform tables,
    and the plain version of the densities' call."""
    import numpy as np
    from pam_tpu_torch.driver.standalone import build_zint
    from pam_tpu_torch.ops import weno, weno_z
    from pam_tpu_torch.spam.geometry import ExtrudedGeometry
    from pam_tpu_torch.spam.tendencies import SpamTendencies
    geom = ExtrudedGeometry.build(65, build_zint({"crm_nz": 50}), 128000.0,
                                  128, dtype, "cuda")
    tend = SpamTendencies(geom=geom, varset=None, thermo=None)
    tb = weno.weno_tables(5, dtype)
    rng = np.random.default_rng(0)
    ndens = 12 if dtype == torch.float32 else 5
    out = {}
    for case, rows, nlev, pl, packed in (
            ("dens", ndens * 128, 50, tend.per_level_d, tend.packed_d),
            ("pv", 128, 49, tend.per_level_q, tend.packed_q)):
        f = torch.as_tensor(rng.standard_normal((rows, nlev + 4, 65)),
                            dtype=dtype, device="cuda")
        out[case] = cuda_ms(
            torch, lambda: weno_z.weno_edges_z(f, tb, nlev, pl, packed), reps)
        if case == "dens":
            out[f"{case} uniform"] = cuda_ms(
                torch, lambda: weno_z.weno_edges_z(f, tb, nlev), reps)
            f3 = f.reshape(ndens, 128, nlev + 4, 65)
            out[f"{case} plain"] = cuda_ms(
                torch, lambda: weno_z.weno_edges_z_reference(f3, tb, nlev, pl),
                max(reps // 20, 20))
    return out


def f1_times(torch, dtype, reps):
    """{case: ms a call} of the FCT limiter at the PAM-A cell's call: 3
    tracers, nens 128, 65x1x50, dt a 0-d tensor (chip_smoke.py phase
    9b's "cell")."""
    from chip_smoke import FCT_DX, fct_inputs
    from pam_tpu_torch.ops import awfl_fct
    fluxes, start, dz4, pos = fct_inputs(3, 128, 1, 50, 65, dtype, "cuda",
                                         seed=53)
    dt = torch.tensor(7.3, dtype=dtype, device="cuda")
    fx, fz = fluxes[0][3], fluxes[1][3]
    return {"cell": cuda_ms(torch, lambda: awfl_fct.fct_limit_cuda(
        fx, fz, start, dt, dz4, pos, FCT_DX, FCT_DX), reps)}


# the cases of each kernel timed here, by its key in _cuda.KERNELS
TIMES = {"weno_x": b1_times, "awfl_flux": b3_times, "p3_part2": b4_times,
         "weno_z": z1_times, "awfl_fct": f1_times}


def measure(root, reps):
    """{row: microseconds per call} for the checkout at ``root``, each row
    named by its kernel's short name in the checkout's ``_cuda.KERNELS``,
    its case and the dtype."""
    sys.path.insert(0, root)
    import torch
    from pam_tpu_torch._cuda import KERNELS
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    short = {k.key: k.short for k in KERNELS}
    out = {}
    for key, times in TIMES.items():
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            for case, ms in times(torch, dtype, reps).items():
                out[" ".join(filter(None, (short[key], case, tag)))] = ms * 1e3
    return out


INLINE_MATH = "-DP3_MATH_INLINE=__forceinline__"


def build_p3_inlined():
    """csrc/p3_part2.cu built with its math inlined at every call site
    (``P3_MATH_INLINE``) into the build directory; returns the library."""
    from pam_tpu_torch import _cuda
    src = _cuda.CSRC / "p3_part2.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _cuda.BUILD_DIR / "p3_part2_inlined.so"
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *_cuda.source_flags(src.name),
         INLINE_MATH, "-I", str(src.parent), "-o", str(so), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return so


def sass_counts():
    """Per kernel of the built libraries: instructions in all, and those
    of the floating-point, special-function and memory pipes. P3 part 2
    is counted twice: as it is built, where every call site of pow, exp,
    log, log10 and tanh shares one body, and with those inlined at every
    site, which is what a point that takes every branch issues."""
    sys.path.insert(0, os.path.dirname(HERE))
    from pam_tpu_torch import _cuda
    groups = (("fp32", r"^(FFMA|FMUL|FADD)"), ("fp64", r"^(DFMA|DMUL|DADD)"),
              ("mufu", r"^MUFU"), ("ld/st global", r"^(LDG|STG|LD\.|ST\.)"),
              ("ld/st shared", r"^(LDS|STS)"),
              ("ld/st local", r"^(LDL|STL)"), ("int", r"^(IMAD|IADD|LEA)"),
              ("compare/select", r"^(FSETP|DSETP|ISETP|FSEL|SEL|PLOP3)"),
              ("branch", r"^(BRA|BSSY|BSYNC|CALL|RET)"))
    out = {}
    inlined = build_p3_inlined()
    libs = [*_cuda.build().paths.values(), inlined]
    for lib in libs:
        suffix = " (math inlined)" if lib == inlined else ""
        text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for ln in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                name = m.group(1) + suffix
                out[name] = collections.Counter()
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)",
                         ln)
            if m and name:
                out[name]["all"] += 1
                for g, pat in groups:
                    if re.match(pat, m.group(1)):
                        out[name][g] += 1
    out = {k: dict(v) for k, v in out.items()}
    # P3 part 2 with its math inlined runs each instruction at most once
    # a point (no loop but the grid's): the time the card needs to issue
    # them all at B4_SHAPE, and the float64 ones through their pipe
    warps = B4_SHAPE[0] * B4_SHAPE[1] * B4_SHAPE[2] / 32
    for name, v in out.items():
        if "p3_part2" in name:
            v["issue bound us"] = warps * v["all"] / (
                SMS * WARP_INSTR_PER_CLOCK * CLOCK_HZ) * 1e6
            v["fp64 pipe bound us"] = warps * v.get("fp64", 0) / (
                SMS * FP64_PER_CLOCK * CLOCK_HZ) * 1e6
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="the checkout to time (default: this one)")
    ap.add_argument("--compare", metavar="DIR",
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object and nothing else")
    args = ap.parse_args(argv)
    if args.sass:
        print(json.dumps({"sass": sass_counts()}))
        return 0
    if not args.compare:
        times = measure(args.root, args.reps)
        if args.json:
            print(json.dumps(times))
        else:
            for k, v in times.items():
                print(f"{k}: {v:.2f} us")
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs = []
    for root in (args.compare, args.root, args.root, args.compare):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--json", "--reps", str(args.reps)], capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        sys.stderr.write(proc.stderr)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"{smi}; us per call: other, this, this, other")
    for k in list(runs[1]) + [k for k in runs[0] if k not in runs[1]]:
        print(f"{k}: " + ", ".join(f"{r[k]:.2f}" if k in r else "-"
                                   for r in runs))
    print(json.dumps({"card": smi, "other": [runs[0], runs[3]],
                      "this": [runs[1], runs[2]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

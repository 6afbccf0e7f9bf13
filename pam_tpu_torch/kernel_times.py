"""Times of the CUDA kernels on the card, at the main path's shapes: the
periodic-x edge reconstruction (csrc/weno_x.cu) at (32000, 65), the
AWFL directional flux (csrc/awfl_flux.cu) at 65x1x50, nens 128, three
tracers, in x, in z and in z with a matrix set per member, P3 part
2 (csrc/p3_part2.cu) at (50, 65, 128) with cloud, rain and ice each at
half of the points and at 2% of them, and the SPAM slab's vertical edge
reconstruction (csrc/weno_z.cu) at the benchmark cells' calls; float32
and float64; microseconds
of device time per call, the launches replayed from a CUDA graph
between two CUDA events.

    python pam_tpu_torch/kernel_times.py                # this checkout
    python pam_tpu_torch/kernel_times.py --compare DIR  # against another

``--compare DIR`` times the checkout at DIR (another commit of this
repository, unpacked with ``git archive``) and this one in turns, other,
this, this, other, each in a process of its own on the same card, and
prints both columns: two versions are compared inside one call only.
``--tiles`` also times the tilings that ops/weno_x.py::tiling and
ops/awfl_flux.py::tile_faces choose among, ``--b4-variants`` P3 part 2
built with other block sizes and register caps. ``--sass`` counts the
instructions of each kernel in the built libraries (``cuobjdump -sass``).
Needs a CUDA device; uses only what both checkouts offer
(``weno_edges_x_cuda``, ``flux_direction_cuda``, ``chip_smoke.b3_inputs``,
``p3_part2_cuda``, ``sample_inputs``). Where the other checkout's P3 part
2 is still two stages (a table stage of dense contractions in PyTorch,
then a kernel for the pointwise core), "B4 part 2" times both stages
together and "B4 core alone" its kernel.
"""

import argparse
import collections
import ctypes
import inspect
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


def eager_ms(torch, fn, reps):
    """Mean milliseconds per call of fn between two CUDA events, the
    calls launched one by one: device time only where the device, not
    the host, is what the calls wait for."""
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


def measure(root, tiles, reps):
    """{case: microseconds per call} for the checkout at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from chip_smoke import b3_inputs
    from pam_tpu_torch.ops import awfl_flux, weno, weno_x
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        tb = weno.weno_tables(5, dtype)
        rng = np.random.default_rng(0)
        f = torch.as_tensor(rng.standard_normal((32000, 65)), dtype=dtype,
                            device="cuda")
        out[f"B1 {tag}"] = cuda_ms(
            torch, lambda: weno_x.weno_edges_x_cuda(f, tb), reps)
        for rb in (1, 2, 4, 8, 16, 32, 63) if tiles else ():
            out[f"B1 {tag} rows/block {rb}"] = cuda_ms(
                torch, lambda: weno_x.weno_edges_x_cuda(
                    f, tb, rows_per_block=rb), reps)
        for case, axis, member_dz in (("x", awfl_flux.AX_X, False),
                                      ("z", awfl_flux.AX_Z, False),
                                      ("z member dz", awfl_flux.AX_Z, True)):
            nens, ny, nz, nx, ntr = B3_SHAPE
            inp = b3_inputs(nens, ny, nz, nx, ntr, axis, dtype, "cuda",
                            seed=axis + ntr, member_dz=member_dz)
            prim, trac, pres, levels = inp
            out[f"B3 {case} {tag}"] = cuda_ms(
                torch, lambda: awfl_flux.flux_direction_cuda(
                    prim, trac, pres, axis, tb, levels), reps)
            for tf in (1, 2, 3, 4, 5, 6, 8) if tiles and case == "z" else ():
                out[f"B3 z {tag} faces/tile {tf}"] = cuda_ms(
                    torch, lambda: awfl_flux.flux_direction_cuda(
                        prim, trac, pres, axis, tb, levels,
                        faces_per_tile=tf), reps)
        out.update(b4_times(torch, dtype, tag, reps))
        out.update(z_times(torch, dtype, tag, reps))
    return {k: v * 1e3 for k, v in out.items()}


def z_times(torch, dtype, tag, reps):
    """The vertical edge reconstruction (csrc/weno_z.cu) at the calls of
    the benchmark's cells, the configs' 50 stretched levels, nens 128:
    densities (12 in float32 as production has, 5 in float64 as PAM-C
    Kessler) and PV, on the per-level matrices, on the uniform tables,
    and the plain version of the densities' call. Nothing where the
    checkout has no such kernel."""
    import numpy as np
    try:
        from pam_tpu_torch.ops import weno, weno_z
    except ImportError:
        return {}
    from pam_tpu_torch.driver.standalone import build_zint
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
        out[f"Z {case} {tag}"] = cuda_ms(
            torch, lambda: weno_z.weno_edges_z(f, tb, nlev, pl, packed), reps)
        if case == "dens":
            out[f"Z {case} uniform {tag}"] = cuda_ms(
                torch, lambda: weno_z.weno_edges_z(f, tb, nlev), reps)
            f3 = f.reshape(ndens, 128, nlev + 4, 65)
            out[f"Z {case} plain {tag}"] = cuda_ms(
                torch, lambda: weno_z.weno_edges_z_reference(f3, tb, nlev, pl),
                max(reps // 20, 20))
    return out


def b4_times(torch, dtype, tag, reps):
    """{case: ms per call} of P3 part 2 at B4_SHAPE in the checkout that
    is on sys.path."""
    from pam_tpu_torch.ops import p3_part2
    from pam_tpu_torch.physics.p3 import main as p3main
    out = {}
    one_launch = "present" in inspect.signature(
        p3_part2.sample_inputs).parameters
    for present in (0.5, 0.02) if one_launch else (0.5,):
        kw = {"present": present} if one_launch else {}
        args = p3_part2.cast_inputs(p3_part2.sample_inputs(
            B4_SHAPE, torch.float64, "cuda", seed=11, **kw), dtype)
        name = "B4 part 2" + ("" if present == 0.5 else f" present {present}")
        if one_launch:
            out[f"{name} {tag}"] = cuda_ms(
                torch, lambda: p3_part2.p3_part2_cuda(*args), reps)
            continue
        st = args[11]
        # the table stage copies a Python scalar to the card (torch.where
        # with a number), which no CUDA graph captures: launched one by
        # one; ~100 launches over tens of MB each keep the device busy
        out[f"{name} (eager) {tag}"] = eager_ms(
            torch, lambda: p3_part2.p3_part2_cuda(
                *args[:12], p3main._part2_tables(st)), reps)
        out[f"B4 core alone {tag}"] = cuda_ms(
            torch, lambda: p3_part2.p3_part2_cuda(*args), reps)
    return out


INLINE_MATH = "-DP3_MATH_INLINE=__forceinline__"
# (threads a block, minimum resident blocks in f32, in f64, further nvcc
# flags): the first is what csrc/p3_part2.cu builds with; the last two
# inline the precise math at every call site, and time the kernel's
# loads and stores without its arithmetic
B4_VARIANTS = ((128, 5, 3, ""), (128, 4, 2, ""), (128, 6, 4, ""),
               (256, 3, 2, ""), (32, 20, 12, ""),
               (128, 5, 3, INLINE_MATH),
               (128, 5, 3, "-DPAM_P3_COPY_ONLY"))


def start_p3_build(name, *flags):
    """Start nvcc on csrc/p3_part2.cu with further flags; returns (the
    library it writes into the build directory, the running compiler)."""
    from pam_tpu_torch import _cuda
    src = _cuda.CSRC / "p3_part2.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _cuda.BUILD_DIR / f"{name}.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *_cuda.SOURCE_FLAGS[src.name],
           *flags, "-I", str(src.parent), "-o", str(so), str(src)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def b4_variants(reps):
    """P3 part 2 built with each of B4_VARIANTS (all compilers side by
    side), timed at B4_SHAPE with cloud, rain and ice each at none, 2%,
    half and all of the points; prints one line a variant with its
    registers and spills."""
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.ops import p3_part2
    lib = _cuda.library()
    running = [start_p3_build(
        f"p3_variant_{n}", f"-DPAM_P3_THREADS={threads}",
        f"-DPAM_P3_MIN_BLOCKS_F32={mb32}", f"-DPAM_P3_MIN_BLOCKS_F64={mb64}",
        *extra.split())
        for n, (threads, mb32, mb64, extra) in enumerate(B4_VARIANTS)]
    cases = [(dtype, tag, present, p3_part2.cast_inputs(
        p3_part2.sample_inputs(B4_SHAPE, torch.float64, "cuda", seed=11,
                               present=present), dtype))
             for dtype, tag in ((torch.float32, "f32"),
                                (torch.float64, "f64"))
             for present in (0.0, 0.02, 0.5, 1.0)]
    ptr = ctypes.c_void_p
    for variant, (so, proc) in zip(B4_VARIANTS, running):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        cdll = ctypes.CDLL(str(so))
        for name in ("pam_p3_part2_f32", "pam_p3_part2_f64"):
            fn = getattr(cdll, name)
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_double,
                           ctypes.c_int, ptr, ptr]
            fn.restype = ctypes.c_int
            setattr(lib, name, fn)
        times = ", ".join(
            f"{tag} present {present} "
            f"{cuda_ms(torch, lambda: p3_part2.p3_part2_cuda(*args), reps) * 1e3:.2f}"
            for dtype, tag, present, args in cases)
        used = "; ".join(ln.split(":", 1)[-1].strip()
                         for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln)
        print(f"B4 threads {variant[0]} min blocks f32 {variant[1]} f64 "
              f"{variant[2]} {variant[3]}: us {times} | {used}", flush=True)


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
    inlined, proc = start_p3_build("p3_part2_inlined", INLINE_MATH)
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout.read()}")
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
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--b4-variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object and nothing else")
    args = ap.parse_args(argv)
    if args.sass:
        print(json.dumps({"sass": sass_counts()}))
        return 0
    if args.b4_variants:
        b4_variants(args.reps)
        return 0
    if not args.compare:
        times = measure(args.root, args.tiles, args.reps)
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

"""Times of the WENO kernels on the card, at the main path's shapes: the
periodic-x edge reconstruction (csrc/weno_x.cu) at (32000, 65) and the
AWFL directional flux (csrc/awfl_flux.cu) at 65x1x50, nens 128, three
tracers, in x, in z and in z with a matrix set per member; float32 and
float64; microseconds of device time per call, the launches replayed
from a CUDA graph between two CUDA events.

    python pam_tpu_torch/kernel_times.py                # this checkout
    python pam_tpu_torch/kernel_times.py --compare DIR  # against another

``--compare DIR`` times the checkout at DIR (another commit of this
repository, unpacked with ``git archive``) and this one in turns, other,
this, this, other, each in a process of its own on the same card, and
prints both columns: two versions are compared inside one call only.
``--tiles`` also times the tilings that ops/weno_x.py::tiling and
ops/awfl_flux.py::tile_faces choose among. ``--sass`` counts the
instructions of each kernel in the built libraries (``cuobjdump -sass``).
Needs a CUDA device; uses only what both checkouts offer
(``weno_edges_x_cuda``, ``flux_direction_cuda``, ``chip_smoke.b3_inputs``).
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
    return {k: v * 1e3 for k, v in out.items()}


def sass_counts():
    """Per kernel of the built libraries: instructions in all, and those
    of the floating-point, special-function and memory pipes."""
    sys.path.insert(0, os.path.dirname(HERE))
    from pam_tpu_torch import _cuda
    groups = (("fp32", r"^(FFMA|FMUL|FADD)"), ("fp64", r"^(DFMA|DMUL|DADD)"),
              ("mufu", r"^MUFU"), ("ld/st global", r"^(LDG|STG|LD\.|ST\.)"),
              ("ld/st shared", r"^(LDS|STS)"), ("int", r"^(IMAD|IADD|LEA)"))
    out = {}
    for src, lib in _cuda.build().paths.items():
        if src == "p3_part2.cu":
            continue
        text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for ln in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                name = m.group(1)
                out[name] = collections.Counter()
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)",
                         ln)
            if m and name:
                out[name]["all"] += 1
                for g, pat in groups:
                    if re.match(pat, m.group(1)):
                        out[name][g] += 1
    return {k: dict(v) for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="the checkout to time (default: this one)")
    ap.add_argument("--compare", metavar="DIR",
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object and nothing else")
    args = ap.parse_args(argv)
    if args.sass:
        print(json.dumps({"sass": sass_counts()}))
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
            text=True, check=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"{smi}; us per call: other, this, this, other")
    for k in runs[1]:
        print(f"{k}: " + ", ".join(f"{r[k]:.2f}" for r in runs))
    print(json.dumps({"card": smi, "other": [runs[0], runs[3]],
                      "this": [runs[1], runs[2]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell of the benchmark of ``pam_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's configuration (``configs/<config>.json``) under its
traffic (``traffic/<traffic>.json``) with the program's own set-up, the
temperature perturbation's seeds drawn from ``--seed``; warms up (the
kernels built or loaded into the program's ``_build/``, the step captured
for the chunk's shape); then drives the GCM loop from t=0 for
``--seconds`` (``mmfbench/program.py``); then checks the steps it took
against the plain reference (``mmfbench/check.py``) and prints one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics, read by ``metrics/<metric>.py`` from the
window's spans and from ``torch.profiler`` stretches after it.

It fails, and prints no result, where no card is there, where the cell
asks for more cards than there are, and where ``jax``, ``jaxlib``,
``flax`` or ``pam_tpu`` is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse   # noqa: E402
import json   # noqa: E402
import os   # noqa: E402
import sys   # noqa: E402
from pathlib import Path   # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of a build or a kernel inside the checkout, at fixed paths,
# so only the first run in a checkout builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
    os.makedirs(os.environ[_var], exist_ok=True)
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from mmfbench import runner, spec

    if not torch.cuda.is_available():
        runner.log("run.py: torch.cuda.is_available() is false; the "
                   "benchmark runs on the card only")
        return 2
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        runner.log(f"run.py: {cell.name} asks for {cell.chips} cards, "
                   f"{torch.cuda.device_count()} are there")
        return 2
    try:
        result = runner.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), T0)
    except runner.ForbiddenImport as e:
        runner.log(f"run.py: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

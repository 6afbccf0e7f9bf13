"""Build and load the package's CUDA kernels (``csrc/*.cu``).

:data:`KERNELS` holds what the package knows of its hand-written kernels
outside their own files, a row a kernel; the build and every tool
(``bench.py``, ``profile_step.py``, ``kernel_times.py``,
``chip_smoke.py``) read it, so a new kernel is its ``.cu``, its module in
``ops/`` and one row. ``csrc/graph_while.cu`` (the CUDA graph's WHILE
nodes that ``ops/graph.py`` drives) and ``csrc/trace_stamp.cu`` (the
stamps of ``utils/observe.py``'s tracer) are machinery and have no row.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library of its own with a plain C interface, loaded with ctypes;
the compilers of all sources run side by side. The build happens at first
use, into ``_build/`` beside this file, under a name keyed on a hash of
the source, of every header ``csrc/*.cuh`` (``csrc/weno5.cuh`` is the
limiter that ``weno_x.cu``, ``weno_z.cu`` and ``awfl_flux.cu`` include,
``csrc/p3_tables.cuh`` the table lookups of ``p3_part2.cu``) and of the
flags: an edited source or header is rebuilt and an unchanged one is
reused. A missing ``nvcc`` or a failed compile raises with the compiler's
output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import time
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One hand-written kernel: a row of :data:`KERNELS`."""
    short: str        # its name in PERF.md (B1, B3, B4, Z1, F1)
    source: str       # its file in csrc/
    trace_name: str   # its __global__ function, as a profiler trace names it
    launcher: str     # "module.function" in ops/ that launches it
    flags: tuple = ()  # nvcc flags beyond NVCC_FLAGS

    @property
    def key(self) -> str:
        """The source's stem (``weno_x``): the kernel's key in launch
        counts."""
        return self.source.removesuffix(".cu")

    def launcher_fn(self):
        """The launcher, whose ``launches`` counts the kernel's launches
        (imported at the call: the ops modules import this one)."""
        module, name = self.launcher.split(".")
        return getattr(importlib.import_module(f"{__package__}.ops.{module}"),
                       name)


# -fmad=false: no multiply-add contraction, so that the kernel rounds
# every product and sum as its plain version's separate PyTorch launches
# do. P3 part 2 needs it (float32 clips of drained species flip
# otherwise), and the FCT limiter follows its plain version's roundings;
# the WENO kernels are held to a tolerance and contract.
KERNELS = (
    Kernel("B1", "weno_x.cu", "weno_x_kernel", "weno_x.weno_edges_x_cuda"),
    Kernel("B3", "awfl_flux.cu", "awfl_flux_kernel",
           "awfl_flux.flux_direction_cuda"),
    Kernel("B4", "p3_part2.cu", "p3_part2_kernel", "p3_part2.p3_part2_cuda",
           ("-fmad=false",)),
    Kernel("Z1", "weno_z.cu", "weno_z_edges_kernel",
           "weno_z.weno_edges_z_cuda"),
    Kernel("F1", "awfl_fct.cu", "awfl_fct_kernel", "awfl_fct.fct_limit_cuda",
           ("-fmad=false",)),
)


def source_flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>`` beyond NVCC_FLAGS."""
    return next((k.flags for k in KERNELS if k.source == name), ())


@dataclasses.dataclass(frozen=True)
class Build:
    paths: dict      # source name -> its shared library
    seconds: float   # wall time of this call's compiles (0: all reused)
    log: str         # nvcc's output (ptxas registers/spills per kernel)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_key(src: Path) -> str:
    """Hash of what a source's library is made from: the flags, the
    source and every ``*.cuh`` beside it."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + source_flags(src.name)).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME   # torch's own search
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of pam_tpu_torch cannot be built")


def build() -> Build:
    """Compile every ``csrc/*.cu`` whose library does not exist yet, all
    at once."""
    paths, logs, running = {}, [], []
    t0 = time.perf_counter()
    for src in _sources():
        stem = f"lib{src.stem}_{source_key(src)}"
        lib, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
        paths[src.name] = lib
        if lib.exists():
            logs.append(log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *source_flags(src.name),
               "-I", str(src.parent), "-o", str(tmp), str(src)]
        running.append((cmd, tmp, lib, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, lib, log, proc in running:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (rc {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)   # atomic: no process sees a partial file
        logs.append(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0 if running else 0.0
    return Build(paths, seconds, "".join(logs))


@functools.cache
def library() -> types.SimpleNamespace:
    """The kernels' entry points, built and loaded on first call in this
    process."""
    paths = build().paths
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = types.SimpleNamespace()

    def bind(cdll, name, argtypes):
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, i32
        setattr(lib, name, fn)

    from .ops import awfl_fct, awfl_flux, p3_part2, weno5, weno_x, weno_z
    cdll = ctypes.CDLL(str(paths["weno_x.cu"]))
    for name in ("pam_weno_x_f32", "pam_weno_x_f64", "pam_weno_x_padded_f32",
                 "pam_weno_x_padded_f64"):
        bind(cdll, name, [ptr, ptr, ptr, i64, i32, i32, i32, ptr, ptr])
    bind(cdll, "pam_weno_x_ntables", [])
    bind(cdll, "pam_weno_x_tile", [])
    if lib.pam_weno_x_ntables() != weno5.NTAB:
        raise RuntimeError("csrc/weno5.cuh expects another table layout "
                           "than ops/weno5.py::prepare_tables packs")
    if lib.pam_weno_x_tile() != weno_x.TILE:
        raise RuntimeError("csrc/weno_x.cu has another tile size than "
                           "ops/weno_x.py")
    cdll = ctypes.CDLL(str(paths["weno_z.cu"]))
    for name in ("pam_weno_z_f32", "pam_weno_z_f64"):
        bind(cdll, name, [ptr, ptr, ptr, i64, i64, i32, i32, ptr, i64, ptr,
                          ptr])
    bind(cdll, "pam_weno_z_layout", [])
    if lib.pam_weno_z_layout() != weno5.NTAB * 1000 + weno_z.NMAT:
        raise RuntimeError("csrc/weno_z.cu expects another table or "
                           "per-level layout than ops/weno_z.py passes")
    cdll = ctypes.CDLL(str(paths["p3_part2.cu"]))
    for name in ("pam_p3_part2_f32", "pam_p3_part2_f64"):
        bind(cdll, name, [ptr, ptr, ptr, i64, ctypes.c_double, i32, ptr,
                          ptr])
    bind(cdll, "pam_p3_part2_layout", [])
    bind(cdll, "pam_p3_part2_table_size", [i32])
    want = (p3_part2.N_IN * 1000000 + p3_part2.N_OUT * 10000
            + len(p3_part2._constants()) * 100 + p3_part2.N_TABLES)
    if lib.pam_p3_part2_layout() != want:
        raise RuntimeError("csrc/p3_part2.cu expects another argument "
                           "layout than ops/p3_part2.py passes")
    cdll = ctypes.CDLL(str(paths["awfl_flux.cu"]))
    for name in ("pam_awfl_flux_f32", "pam_awfl_flux_f64"):
        bind(cdll, name, [ptr, ptr, ctypes.c_double, ptr])
    bind(cdll, "pam_awfl_flux_layout", [])
    bind(cdll, "pam_awfl_flux_max_tile", [])
    want = (awfl_flux.N_ARGS * 1000000 + weno5.NTAB * 1000
            + awfl_flux.LEVEL_STRIDE)
    if (lib.pam_awfl_flux_layout() != want
            or lib.pam_awfl_flux_max_tile() != awfl_flux.MAX_TILE_FACES):
        raise RuntimeError("csrc/awfl_flux.cu expects another argument, "
                           "table or tile layout than ops/awfl_flux.py "
                           "passes")
    cdll = ctypes.CDLL(str(paths["awfl_fct.cu"]))
    for name in ("pam_awfl_fct_f32", "pam_awfl_fct_f64"):
        bind(cdll, name, [ptr, ctypes.c_double, ctypes.c_double,
                          ctypes.c_double, ptr])
    bind(cdll, "pam_awfl_fct_layout", [])
    if (lib.pam_awfl_fct_layout()
            != awfl_fct.N_ARGS * 1000000 + awfl_fct.ENTRIES):
        raise RuntimeError("csrc/awfl_fct.cu expects another argument or "
                           "tile layout than ops/awfl_fct.py passes")
    cdll = ctypes.CDLL(str(paths["graph_while.cu"]))
    bind(cdll, "pam_capture_begin", [ptr, ptr])
    bind(cdll, "pam_while_begin", [ptr, ptr, ptr, ptr, ptr])
    bind(cdll, "pam_while_end", [ptr, ctypes.c_ulonglong, ptr, ptr, ptr])
    bind(cdll, "pam_while_abort", [ptr, ptr, ptr])
    bind(cdll, "pam_capture_end", [ptr, ptr, i32, ptr])
    bind(cdll, "pam_graph_launch", [ptr, ptr])
    bind(cdll, "pam_graph_destroy", [ptr])
    cdll = ctypes.CDLL(str(paths["trace_stamp.cu"]))
    bind(cdll, "pam_stamp_begin", [ptr, ptr])
    bind(cdll, "pam_stamp_end", [ptr, ptr, ptr, ptr, ptr, i64, i32, ptr])
    bind(cdll, "pam_stamp_now", [ptr, ptr])
    bind(cdll, "pam_stamp_ticks", [ptr, i32, ptr])
    return lib

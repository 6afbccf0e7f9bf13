"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library of its own with a plain C interface, loaded with ctypes;
the compilers of all sources run side by side. The build happens at first
use, into ``_build/`` beside this file, under a name keyed on a hash of
the source, of every header ``csrc/*.cuh`` (``csrc/weno5.cuh`` is the
limiter that ``weno_x.cu`` and ``awfl_flux.cu`` include,
``csrc/p3_tables.cuh`` the table lookups of ``p3_part2.cu``) and of the
flags (``csrc/graph_while.cu`` is no kernel of the TPU's but the capture
of a CUDA graph with WHILE nodes that ``ops/graph.py`` drives): an edited source or header is rebuilt and an unchanged one is
reused. A missing ``nvcc`` or a failed compile raises with the compiler's
output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
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
# -fmad=false: no multiply-add contraction, so that the kernel rounds
# every product and sum as its plain version's separate PyTorch launches
# do. P3 part 2 needs it (float32 clips of drained species flip
# otherwise); the WENO kernels are held to a tolerance and contract.
SOURCE_FLAGS = {"p3_part2.cu": ("-fmad=false",)}


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
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(src.name, ())).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()),
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

    from .ops import awfl_flux, p3_part2, weno5, weno_x
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
    cdll = ctypes.CDLL(str(paths["graph_while.cu"]))
    bind(cdll, "pam_capture_begin", [ptr, ptr])
    bind(cdll, "pam_while_begin", [ptr, ptr, ptr, ptr, ptr])
    bind(cdll, "pam_while_end", [ptr, ctypes.c_ulonglong, ptr, ptr, ptr])
    bind(cdll, "pam_while_abort", [ptr, ptr, ptr])
    bind(cdll, "pam_capture_end", [ptr, ptr, i32, ptr])
    bind(cdll, "pam_graph_launch", [ptr, ptr])
    bind(cdll, "pam_graph_destroy", [ptr])
    return lib

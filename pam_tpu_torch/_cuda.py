"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ctypes. The build
happens at first use, into ``_build/`` beside this file, under a name
keyed on a hash of the sources, so an edited source is rebuilt and an
unchanged one is reused. A missing ``nvcc`` or a failed compile raises
with the compiler's output; nothing falls back to the plain versions.
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -fmad=false: no multiply-add contraction, so a kernel rounds every
# product and sum as its plain version's separate PyTorch launches do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path       # the shared library
    seconds: float   # compile time of this call (0 when it was reused)
    log: str         # nvcc's output (ptxas registers/spills per kernel)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    """Compile ``csrc/*.cu`` unless a library of the same sources exists."""
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    key = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libpam_tpu_torch_{key}.so"
    log = BUILD_DIR / f"libpam_tpu_torch_{key}.log"
    if lib.exists():
        return Build(lib, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial file
    return Build(lib, seconds, out)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("pam_weno_x_f32", "pam_weno_x_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr]
        fn.restype = i32
    lib.pam_weno_x_ntables.argtypes = []
    lib.pam_weno_x_ntables.restype = i32
    if lib.pam_weno_x_ntables() != 101:   # ops/weno_x.py::_packed_tables
        raise RuntimeError("csrc/weno_x.cu expects another table layout")
    for name in ("pam_p3_part2_f32", "pam_p3_part2_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, ctypes.c_double, i32, ptr, ptr]
        fn.restype = i32
    lib.pam_p3_part2_layout.argtypes = []
    lib.pam_p3_part2_layout.restype = i32
    from .ops import p3_part2
    want = (p3_part2.N_IN * 10000 + p3_part2.N_OUT * 100
            + len(p3_part2._constants()))
    if lib.pam_p3_part2_layout() != want:
        raise RuntimeError("csrc/p3_part2.cu expects another argument "
                           "layout than ops/p3_part2.py passes")
    for name in ("pam_awfl_flux_f32", "pam_awfl_flux_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ctypes.c_double, ptr]
        fn.restype = i32
    lib.pam_awfl_flux_layout.argtypes = []
    lib.pam_awfl_flux_layout.restype = i32
    from .ops import awfl_flux
    want = awfl_flux.N_ARGS * 1000000 + 101 * 1000 + awfl_flux.LEVEL_STRIDE
    if lib.pam_awfl_flux_layout() != want:
        raise RuntimeError("csrc/awfl_flux.cu expects another argument or "
                           "table layout than ops/awfl_flux.py passes")
    return lib

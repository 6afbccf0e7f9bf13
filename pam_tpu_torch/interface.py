"""Python bridge to the native GCM-facing host data plane (port of
pam_tpu/interface.py, numpy and ctypes).

Builds on first use the shared source ``native/pam_interface.cpp`` (the
C++ equivalent of the reference's pam_interface layer) with ``g++`` into
``pam_tpu_torch/_build/libpam_interface_<hash>.so``, keyed on a hash of the
source and the flags, and exposes the array registry and the options
store with zero-copy numpy views through ctypes. The library is this
package's own: ``pam_tpu``'s copy builds and loads
``native/libpam_interface.so``, so the two packages' registries stay
apart in one process. The host GCM drives the CRM through it: it mirrors
its arrays read-write, the CRM copies them into its state on the device
(``torch.tensor(view)``, never a view of the host memory), steps, and
writes the results back through the registry views.

Parity reference: pam_core/pam_interface/pam_interface.h (API semantics)
and pam_interface_extern_c.cpp (the C ABI the Fortran bindings call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "pam_interface.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_LIB = None

_DTYPES = {0: np.bool_, 1: np.int32, 2: np.float32, 3: np.float64}
_SUFFIX = {np.dtype(np.bool_): "bool", np.dtype(np.int32): "int",
           np.dtype(np.float32): "float", np.dtype(np.float64): "double"}


def library_path() -> Path:
    """Where this package's build of the source lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpam_interface_{h.hexdigest()[:16]}.so"


def _build_and_load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True)
        os.replace(tmp, so)   # atomic: no process sees a partial file
    lib = ctypes.CDLL(str(so))
    lib.pam_interface_get_array_ptr.restype = ctypes.c_void_p
    lib.pam_interface_get_option_double.restype = ctypes.c_double
    lib.pam_interface_get_option_float.restype = ctypes.c_float
    lib.pam_interface_get_option_bool.restype = ctypes.c_bool
    lib.pam_interface_get_option_int64.restype = ctypes.c_longlong
    lib.pam_interface_validate_array.restype = ctypes.c_int64
    lib.pam_interface_set_option_double.argtypes = [ctypes.c_char_p,
                                                    ctypes.c_double]
    lib.pam_interface_set_option_bool.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_bool]
    # explicit 64-bit argtype: without it ctypes would silently mask a
    # wide Python int to a C int
    lib.pam_interface_set_option_int64.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_longlong]
    _LIB = lib
    return lib


def _b(s: str) -> bytes:
    return s.encode()


class HostDataManager:
    """GCM-facing named array registry (host memory)."""

    def __init__(self):
        self.lib = _build_and_load()
        self._keepalive = {}

    def finalize(self):
        self.lib.pam_interface_finalize()
        self._keepalive.clear()

    # ---- dimensions ----
    def register_dimension(self, name: str, length: int):
        self.lib.pam_interface_register_dimension(_b(name), length)

    def get_dimension_size(self, name: str) -> int:
        return self.lib.pam_interface_get_dimension_size(_b(name))

    # ---- arrays ----
    def mirror_array(self, name: str, arr: np.ndarray, desc: str = "",
                    readonly: bool = True):
        """Zero-copy register of caller-owned memory (the GCM side of the
        MMF coupling; ref: register_existing, DataManager.h:157).

        The registry aliases ``arr``'s buffer directly, so the input must
        be C-contiguous — silently substituting a contiguous COPY would
        break the alias (native-side writes would land in a hidden copy
        the caller never sees)."""
        if not (isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]):
            raise ValueError(
                f"mirror_array({name!r}): input must be a C-contiguous "
                "numpy array (the registry aliases its memory; pass "
                "np.ascontiguousarray(a) yourself if a copy is acceptable)")
        if arr.dtype not in _SUFFIX:
            raise TypeError(
                f"mirror_array({name!r}): unsupported dtype {arr.dtype}; "
                f"supported: {sorted(str(d) for d in _SUFFIX)} (note: "
                "numpy's default int64 must be cast to int32 explicitly)")
        sfx = _SUFFIX[arr.dtype]
        dims = (ctypes.c_int * arr.ndim)(*arr.shape)
        fn = getattr(self.lib,
                     f"pam_interface_mirror_array_"
                     f"{'readonly' if readonly else 'readwrite'}_{sfx}")
        fn(_b(name), _b(desc), dims, arr.ndim,
           arr.ctypes.data_as(ctypes.c_void_p))
        self._keepalive[name] = arr  # the registry borrows; keep it alive

    def register_and_allocate(self, name: str, shape, dtype=np.float64,
                              desc: str = ""):
        if np.dtype(dtype) not in _SUFFIX:
            raise TypeError(
                f"register_and_allocate({name!r}): unsupported dtype "
                f"{np.dtype(dtype)}; supported: "
                f"{sorted(str(d) for d in _SUFFIX)}")
        sfx = _SUFFIX[np.dtype(dtype)]
        dims = (ctypes.c_int * len(shape))(*shape)
        getattr(self.lib, f"pam_interface_register_and_allocate_{sfx}")(
            _b(name), _b(desc), dims, len(shape))

    def unregister(self, name: str):
        self.lib.pam_interface_unregister_and_deallocate(_b(name))
        self._keepalive.pop(name, None)

    def exists(self, name: str) -> bool:
        return bool(self.lib.pam_interface_array_exists(_b(name)))

    def get(self, name: str) -> np.ndarray:
        """Zero-copy numpy view of a registered array.

        Lifetime contract (same as the reference's raw-pointer `get`,
        DataManager.h:286): the view aliases registry-owned memory and is
        valid only until ``unregister(name)`` or ``finalize()`` — using
        it after that reads freed memory. Copy with ``np.array(view)``
        if it must outlive the entry."""
        rank = self.lib.pam_interface_get_array_rank(_b(name))
        if rank < 0:
            raise KeyError(name)
        dims = (ctypes.c_int * rank)()
        self.lib.pam_interface_get_array_dims(_b(name), dims)
        dt = _DTYPES[self.lib.pam_interface_get_array_dtype(_b(name))]
        ptr = self.lib.pam_interface_get_array_ptr(_b(name))
        buf = (ctypes.c_char * (np.dtype(dt).itemsize *
                                int(np.prod(dims)))).from_address(ptr)
        a = np.frombuffer(buf, dtype=dt).reshape(tuple(dims))
        if self.lib.pam_interface_array_readonly(_b(name)) == 1:
            a.flags.writeable = False
        return a

    def make_readonly(self, name: str):
        self.lib.pam_interface_make_readonly(_b(name))

    # ---- dirty tracking / validation ----
    def clean_all_entries(self):
        self.lib.pam_interface_clean_all_entries()

    def entry_dirty(self, name: str) -> bool:
        return self.lib.pam_interface_entry_dirty(_b(name)) == 1

    def validate(self, name: str, nan=True, inf=True, pos=False) -> int:
        return int(self.lib.pam_interface_validate_array(
            _b(name), int(nan), int(inf), int(pos)))

    # ---- options ----
    # variant indices of the native Options::Value
    _OPT_TYPES = {0: "bool", 1: "int", 2: "float", 3: "str"}

    def _check_option(self, name: str, want: str):
        """Raise KeyError (missing) / TypeError (mismatch) BEFORE calling
        a typed native getter — the C++ side deliberately returns zero
        values instead of throwing across the FFI boundary (a C++
        exception unwinding through ctypes would std::terminate the
        process with no Python traceback)."""
        t = self.lib.pam_interface_get_option_type(_b(name))
        if t < 0:
            raise KeyError(name)
        have = self._OPT_TYPES[t]
        if have != want and not (want == "float" and have == "int"):
            raise TypeError(
                f"option {name!r} holds a {have}, requested {want}")

    def set_option(self, name: str, value):
        if isinstance(value, bool):
            self.lib.pam_interface_set_option_bool(_b(name), value)
        elif isinstance(value, (int, np.integer)):
            self.lib.pam_interface_set_option_int64(_b(name), int(value))
        elif isinstance(value, (float, np.floating)):
            self.lib.pam_interface_set_option_double(_b(name), float(value))
        elif isinstance(value, str):
            self.lib.pam_interface_set_option_string(_b(name), _b(value))
        else:
            raise TypeError(type(value))

    def get_option_float(self, name: str) -> float:
        self._check_option(name, "float")
        return float(self.lib.pam_interface_get_option_double(_b(name)))

    def get_option_int(self, name: str) -> int:
        self._check_option(name, "int")
        return int(self.lib.pam_interface_get_option_int64(_b(name)))

    def get_option_bool(self, name: str) -> bool:
        self._check_option(name, "bool")
        return bool(self.lib.pam_interface_get_option_bool(_b(name)))

    def get_option_str(self, name: str, maxlen: int = 256) -> str:
        self._check_option(name, "str")
        buf = ctypes.create_string_buffer(maxlen)
        self.lib.pam_interface_get_option_string(_b(name), buf, maxlen)
        return buf.value.decode()

    def option_is_set(self, name: str) -> bool:
        return bool(self.lib.pam_interface_option_is_set(_b(name)))

    def remove_option(self, name: str):
        self.lib.pam_interface_remove_option(_b(name))

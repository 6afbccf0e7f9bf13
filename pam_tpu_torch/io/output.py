"""NetCDF output of the coupler state (port of pam_tpu/io/output.py).

Parity reference: standalone/mmf_simplified/output.h — per-run NetCDF file
with x/y/z coordinate variables and every coupler field appended along an
unlimited time dimension. Uses scipy's NetCDF-3 writer; the reference's
MPI token-passing rank serialization is unnecessary (single process,
ensemble axis instead of ranks). Tensors go to the host as float64 numpy
arrays; h5py is imported by the HDF5 writer alone.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..convert import host_array as _host
from ..core.coupler import Coupler


class NetCDFWriter:
    """Appends coupler-state snapshots to ``<prefix>.nc``."""

    def __init__(self, coupler: Coupler, state, prefix: str):
        self.coupler = coupler
        self.fname = f"{prefix}.nc"
        self.num_out = 0
        self._create(state)

    def _create(self, state):
        c = self.coupler
        f = netcdf_file(self.fname, "w")
        f.createDimension("t", None)
        f.createDimension("x", c.nx)
        f.createDimension("y", c.ny)
        f.createDimension("z", c.nz)
        f.createDimension("zp1", c.nz + 1)
        f.createDimension("nens", c.nens)
        xv = f.createVariable("x", "d", ("x",))
        xv[:] = (np.arange(c.nx) + 0.5) * c.dx
        yv = f.createVariable("y", "d", ("y",))
        yv[:] = (np.arange(c.ny) + 0.5) * c.dy
        zv = f.createVariable("z", "d", ("z", "nens"))
        zv[:] = _host(state["vertical_midpoint_height"]).T
        zi = f.createVariable("zint", "d", ("zp1", "nens"))
        zi[:] = _host(state["vertical_interface_height"]).T
        f.createVariable("t", "d", ("t",))
        self._vars = {}
        for name, arr in state.items():
            shape = tuple(arr.shape)
            if shape == (c.nens, c.nz, c.ny, c.nx):
                self._vars[name] = f.createVariable(
                    name, "d", ("t", "nens", "z", "y", "x"))
            elif shape == (c.nens, c.ny, c.nx):
                self._vars[name] = f.createVariable(
                    name, "d", ("t", "nens", "y", "x"))
            elif shape == (c.nens, c.nz):
                self._vars[name] = f.createVariable(
                    name, "d", ("t", "nens", "z"))
            elif shape == (c.nens, c.nz + 1):
                # interface-staggered columns (ref_presi,
                # gcm_pressure_int, vertical_interface_height)
                self._vars[name] = f.createVariable(
                    name, "d", ("t", "nens", "zp1"))
        self.f = f

    def write(self, state, etime: float):
        i = self.num_out
        self.f.variables["t"][i] = etime
        for name, var in self._vars.items():
            if name in state:
                var[i] = _host(state[name])
        self.num_out += 1
        self.f.sync()

    def close(self):
        self.f.close()


class HDF5Writer:
    """Appends coupler-state snapshots to ``<prefix>.h5`` (chunked +
    gzip-compressed, unlimited time axis).

    The scalable-IO analog of the reference's PNetCDF backend
    (dynamics/spam/src/io/parallel_io.h; backend choice fileio.h:5-15):
    scipy's NetCDF-3 writer has a 2 GB file limit and no compression, so
    large-ensemble production output goes through HDF5. Same interface as
    NetCDFWriter; select with make_writer(..., backend="hdf5")."""

    def __init__(self, coupler: Coupler, state, prefix: str):
        import h5py
        c = self.coupler = coupler
        self.fname = f"{prefix}.h5"
        self.num_out = 0
        f = h5py.File(self.fname, "w")
        f.create_dataset("x", data=(np.arange(c.nx) + 0.5) * c.dx)
        f.create_dataset("y", data=(np.arange(c.ny) + 0.5) * c.dy)
        f.create_dataset("z", data=_host(
            state["vertical_midpoint_height"]).T)
        f.create_dataset("zint", data=_host(
            state["vertical_interface_height"]).T)
        f.create_dataset("t", shape=(0,), maxshape=(None,), dtype="f8")
        self._names = []
        for name, arr in state.items():
            shape = tuple(arr.shape)
            if shape in ((c.nens, c.nz, c.ny, c.nx), (c.nens, c.ny, c.nx),
                         (c.nens, c.nz), (c.nens, c.nz + 1)):
                # chunk per (snapshot, ensemble member): appends stay
                # cheap, reads of one member decompress only that
                # member, and chunks stay far below HDF5's 4 GiB cap at
                # any grid/ensemble size
                f.create_dataset(name, shape=(0,) + shape,
                                 maxshape=(None,) + shape,
                                 chunks=(1, 1) + shape[1:], dtype="f8",
                                 compression="gzip", compression_opts=1)
                self._names.append(name)
        self.f = f

    def write(self, state, etime: float):
        i = self.num_out
        self.f["t"].resize((i + 1,))
        self.f["t"][i] = etime
        for name in self._names:
            if name in state:
                d = self.f[name]
                d.resize((i + 1,) + d.shape[1:])
                d[i] = _host(state[name])
        self.num_out += 1
        self.f.flush()

    def close(self):
        self.f.close()


class NullWriter:
    """No-op backend (the reference's blank_io.h): satisfies the writer
    interface so callers need no None-guards."""

    def write(self, state, etime: float):
        pass

    def close(self):
        pass


def make_writer(coupler: Coupler, state, prefix: str,
                backend: str = "netcdf"):
    """Output-backend dispatch (the reference's compile-time IO choice,
    fileio.h:5-15: serial NetCDF / parallel / none)."""
    if backend == "netcdf":
        return NetCDFWriter(coupler, state, prefix)
    if backend == "hdf5":
        return HDF5Writer(coupler, state, prefix)
    if backend == "none":
        return NullWriter()
    raise ValueError(f"unknown io backend {backend!r}")


class StatsWriter:
    """Conservation-statistics time series -> ``<prefix>_stats.nc``.

    Parity reference: the SPAM stats subsystem (src/models/stats.h +
    ModelStats::compute, extrudedmodel.h:4599-4860) written by
    yakl_serial_io.h outputStats — per-ensemble global mass/min/max,
    energies (TE/KE/PE/IE), PV and potential enstrophy. Accepts the dict
    produced by SpamTendencies.statistics / LayerModel.statistics."""

    def __init__(self, stats0: dict, nens: int, prefix: str):
        self.fname = f"{prefix}_stats.nc"
        self.num_out = 0
        f = netcdf_file(self.fname, "w")
        f.createDimension("t", None)
        f.createDimension("nens", nens)
        f.createVariable("t", "d", ("t",))
        self._vars = {}
        for name, val in stats0.items():
            a = _host(val)
            if a.ndim == 1:                       # (nens,)
                self._vars[name] = f.createVariable(name, "d", ("t", "nens"))
            elif a.ndim == 2:                     # (ndens, nens)
                dim = f"n_{name}"
                f.createDimension(dim, a.shape[0])
                self._vars[name] = f.createVariable(name, "d",
                                                    ("t", dim, "nens"))
        self.f = f

    def write(self, stats: dict, etime: float):
        i = self.num_out
        self.f.variables["t"][i] = etime
        for name, var in self._vars.items():
            if name in stats:
                var[i] = _host(stats[name])
        self.num_out += 1
        self.f.sync()

    def close(self):
        self.f.close()

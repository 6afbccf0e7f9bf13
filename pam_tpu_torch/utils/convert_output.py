"""Output-format converter: HDF5 <-> NetCDF-3 (a copy of
pam_tpu/utils/convert_output.py, which imports no JAX; numpy, with h5py
and scipy imported where a conversion runs).

Parity analog of the reference's utils/convert_to_netcdf4.py (which
re-encodes its NetCDF output as NETCDF4/HDF5): the HDF5 writer's files
(io/output.py HDF5Writer) -> NetCDF-3 for tools that only read classic
NetCDF, and back.

Usage: python -m pam_tpu_torch.utils.convert_output out.h5 out.nc
       python -m pam_tpu_torch.utils.convert_output out.nc out.h5
"""

from __future__ import annotations

import sys

import numpy as np


def h5_to_nc(src: str, dst: str):
    import h5py
    from scipy.io import netcdf_file
    with h5py.File(src, "r") as f:
        out = netcdf_file(dst, "w")
        dims = {}

        def dim(n):
            name = f"d{n}"
            if name not in dims:
                out.createDimension(name, n)
                dims[name] = True
            return name

        out.createDimension("t", None)
        for name in f:
            data = np.asarray(f[name])
            if name == "t" or (data.ndim >= 1 and f[name].maxshape[0] is None):
                dnames = ("t",) + tuple(dim(n) for n in data.shape[1:])
            else:
                dnames = tuple(dim(n) for n in data.shape)
            var = out.createVariable(name, "d", dnames)
            var[:] = data
        out.close()


def nc_to_h5(src: str, dst: str):
    import h5py
    from scipy.io import netcdf_file
    f = netcdf_file(src, "r", mmap=False)
    # record variables (unlimited time dim) keep an unlimited maxshape so
    # the output matches the HDF5Writer format — h5_to_nc then classifies
    # them back as record variables and the round trip preserves the
    # schema (and HDF5Writer-style appends keep working)
    unlimited = {n for n, d in f.dimensions.items() if d is None}
    with h5py.File(dst, "w") as out:
        for name, var in f.variables.items():
            data = np.asarray(var[:])
            record = bool(var.dimensions) and var.dimensions[0] in unlimited
            out.create_dataset(
                name, data=data,
                maxshape=((None,) + data.shape[1:]) if record else None,
                compression="gzip", compression_opts=1)
    f.close()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 1
    src, dst = argv
    if src.endswith(".h5") and dst.endswith(".nc"):
        h5_to_nc(src, dst)
    elif src.endswith(".nc") and dst.endswith(".h5"):
        nc_to_h5(src, dst)
    else:
        raise SystemExit("expected .h5 -> .nc or .nc -> .h5")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

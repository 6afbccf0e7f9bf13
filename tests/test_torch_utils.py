"""The port's utilities against pam_tpu (tests/test_utils.py, mirrored):
checkpoint round trip, module timers and dirty entries, validate_state,
horizontal and time averages, vertical levels and their vcoords NetCDF
file, the writers with staggered fields and the "none" backend, the
h5 <-> nc converter, and the torch.profiler trace.
"""

import json
import os

import h5py
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.io import netcdf_file

from pam_tpu.core import Coupler as JCoupler
from pam_tpu.driver.standalone import build_zint as jbuild_zint
from pam_tpu.io.output import make_writer as jwriter
from pam_tpu.modules import averaging as javg
from pam_tpu.utils import convert_output as jconvert
from pam_tpu.utils import observe as jobserve
from pam_tpu.utils import vertical_levels as jvl
from pam_tpu_torch.core.coupler import Coupler as TCoupler
from pam_tpu_torch.driver.standalone import build_zint as tbuild_zint
from pam_tpu_torch.io.output import make_writer as twriter
from pam_tpu_torch.modules import averaging as tavg
from pam_tpu_torch.utils import checkpoint as ckpt
from pam_tpu_torch.utils import convert_output as tconvert
from pam_tpu_torch.utils import observe
from pam_tpu_torch.utils import vertical_levels as tvl

torch.set_num_threads(1)


def _state(nens=2, nz=4, ny=1, nx=6):
    cpl = TCoupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=1000., ylen=1000.,
                   dtype=torch.float64, device=torch.device("cpu"))
    cpl = cpl.add_tracer("water_vapor")
    state = cpl.allocate_state(np.linspace(0., 1000., nz + 1))
    state["temp"] = state["temp"] + 300.0
    return cpl, state


def _pair(nz=3, nx=4):
    """The same coupler and state in both packages (numpy-equal)."""
    j = JCoupler(nz=nz, ny=1, nx=nx, nens=2, xlen=4000.0, ylen=1000.0,
                 dtype=jnp.float64).add_tracer("water_vapor")
    t = TCoupler(nz=nz, ny=1, nx=nx, nens=2, xlen=4000.0, ylen=1000.0,
                 dtype=torch.float64,
                 device=torch.device("cpu")).add_tracer("water_vapor")
    zint = np.linspace(0, 1000.0 * nz, nz + 1)
    base = {k: np.asarray(v) for k, v in j.allocate_state(zint).items()}
    rng = np.random.default_rng(1)
    base = {k: v + rng.random(v.shape) for k, v in base.items()}
    base["precl"] = rng.random((2, 1, nx))
    return (j, {k: jnp.asarray(v) for k, v in base.items()},
            t, {k: torch.tensor(v) for k, v in base.items()})


def test_checkpoint_roundtrip(tmp_path):
    cpl, state = _state()
    state["count"] = torch.arange(3)
    p = os.path.join(tmp_path, "sub", "ck")
    ckpt.save_checkpoint(p, state, etime=123.5, meta={"note": "x"})
    with open(p + ".json") as f:
        assert json.load(f)["fields"] == sorted(state)
    restored, etime, meta = ckpt.load_checkpoint(p, device="cpu")
    assert etime == 123.5 and meta["note"] == "x"
    assert set(restored) == set(state)
    for k in state:
        assert restored[k].dtype == state[k].dtype
        assert torch.equal(restored[k], state[k]), k
    as32, _, _ = ckpt.load_checkpoint(p + ".npz", torch.float32, "cpu")
    assert as32["temp"].dtype == torch.float32
    assert float(as32["temp"].max()) == 300.0


def test_module_timers_and_dirty_tracking():
    cpl, state = _state()
    timers = observe.ModuleTimers(trace=True)
    jtimers = jobserve.ModuleTimers(trace=True)

    def warm(s):
        out = dict(s)
        out["temp"] = s["temp"] + 1.0
        out["new"] = s["temp"][:, :1]
        return out

    out = timers.run_module("warm", warm, state)
    jout = jtimers.run_module("warm", warm, {k: jnp.asarray(v.numpy())
                                             for k, v in state.items()})
    assert timers.counts["warm"] == 1 and timers.times["warm"] > 0
    assert timers.trace_log == jtimers.trace_log == [("warm",
                                                      ("temp", "new"))]
    assert "warm" in timers.report()
    assert float(out["temp"].max()) == float(jout["temp"].max())
    # a field that already holds NaN is not dirty when unchanged
    state["temp"][0, 0, 0, 0] = float("nan")
    assert observe.state_diff(state, dict(state)) == ()


def test_validate_state_matches_jax():
    cpl, state = _state()
    assert observe.validate_state(state) == {}
    bad = dict(state)
    bad["temp"] = bad["temp"].clone()
    bad["temp"][0, 0, 0, 0] = float("nan")
    bad["temp"][1, 0, 0, 0] = float("inf")
    bad["water_vapor"] = bad["water_vapor"] - 1.0
    rep = observe.validate_state(bad, positive=("water_vapor",))
    assert rep == {"temp": ["nan", "inf"], "water_vapor": ["negative"]}
    assert rep == jobserve.validate_state(
        {k: jnp.asarray(v.numpy()) for k, v in bad.items()},
        positive=("water_vapor",))


def test_horizontal_and_time_average_match_jax():
    jc, js, tc, ts = _pair()
    ref = javg.horizontal_average(jc, js, ["temp", "uvel"])
    got = tavg.horizontal_average(tc, ts, ["temp", "uvel"])
    for k in ("temp_horizontal_average", "uvel_horizontal_average"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-15, atol=0)
    s, sj = dict(ts), dict(js)
    for _ in range(10):
        s = tavg.time_average(tc, s, ["temp"], dt=1.0, window=10.0)
        sj = javg.time_average(jc, sj, ["temp"], dt=1.0, window=10.0)
    np.testing.assert_allclose(s["temp_time_average"].numpy(),
                               np.asarray(sj["temp_time_average"]),
                               rtol=1e-15)
    np.testing.assert_allclose(s["temp_time_average"].numpy(),
                               ts["temp"].numpy(), rtol=1e-12)
    s = tavg.reset_time_average(s, ["temp"])
    assert float(s["temp_time_average"].abs().max()) == 0.0


@pytest.mark.parametrize("fn", ["equal", "exp", "tanh"])
def test_vertical_levels_equal_jax(fn):
    kw = dict(exp_base=5.0, tanh_inflect=3000.0)
    got = tvl.generate(fn, nlev=32, z0=100.0, ztop=5000.0, **kw)
    np.testing.assert_array_equal(got, jvl.generate(fn, nlev=32, z0=100.0,
                                                    ztop=5000.0, **kw))
    assert got.shape == (33,) and (np.diff(got) > 0).all()
    with pytest.raises(ValueError):
        tvl.generate("cubic")


def test_vcoords_netcdf_roundtrip(tmp_path):
    """save_netcdf -> build_zint of both packages (and the command line
    entry point writes the same file)."""
    path = str(tmp_path / "vcoords.nc")
    zint = tvl.generate("tanh", nlev=16, ztop=2000.0)
    tvl.save_netcdf(path, zint)
    np.testing.assert_array_equal(tbuild_zint({"vcoords": path}), zint)
    np.testing.assert_array_equal(jbuild_zint({"vcoords": path}), zint)
    cli = str(tmp_path / "cli.nc")
    tvl.main(["--nlev", "16", "--ztop", "2000", "--output", cli])
    np.testing.assert_array_equal(tbuild_zint({"vcoords": cli}), zint)


def test_writer_staggered_fields_and_none_backend(tmp_path):
    """(nens, nz+1) interface-staggered coupler fields appear in both
    backends, as in pam_tpu's; the 'none' backend takes writes and writes
    nothing; an unknown backend is refused."""
    jc, js, tc, ts = _pair()
    for backend in ("netcdf", "hdf5"):
        w = twriter(tc, ts, str(tmp_path / backend), backend)
        w.write(ts, 0.0)
        w.close()
    with netcdf_file(str(tmp_path / "netcdf.nc"), "r", mmap=False) as f:
        assert f.variables["ref_presi"].shape == (1, 2, 4)
        assert f.variables["ref_presi"].dimensions == ("t", "nens", "zp1")
        np.testing.assert_array_equal(f.variables["ref_presi"][0],
                                      ts["ref_presi"].numpy())
    with h5py.File(str(tmp_path / "hdf5.h5")) as f:
        assert f["gcm_pressure_int"].shape == (1, 2, 4)
    w = twriter(tc, ts, str(tmp_path / "n"), backend="none")
    w.write(ts, 0.0)
    w.close()
    assert not (tmp_path / "n.nc").exists()
    with pytest.raises(ValueError, match="unknown io backend"):
        twriter(tc, ts, str(tmp_path / "x"), backend="zarr")


def test_convert_output_matches_jax(tmp_path):
    """h5 -> nc and nc -> h5 of the port's converter write what
    pam_tpu's writes, and the round trip keeps the record axis."""
    jc, js, tc, ts = _pair()
    w = twriter(tc, ts, str(tmp_path / "o"), backend="hdf5")
    w.write(ts, 0.0)
    w.write(ts, 10.0)
    w.close()
    tconvert.h5_to_nc(str(tmp_path / "o.h5"), str(tmp_path / "t.nc"))
    jconvert.h5_to_nc(str(tmp_path / "o.h5"), str(tmp_path / "j.nc"))
    with netcdf_file(str(tmp_path / "t.nc"), "r", mmap=False) as ft, \
            netcdf_file(str(tmp_path / "j.nc"), "r", mmap=False) as fj:
        assert ft.variables["temp"].shape == (2, 2, 3, 1, 4)
        assert sorted(ft.variables) == sorted(fj.variables)
        for k, v in fj.variables.items():
            assert ft.variables[k].dimensions == v.dimensions, k
            np.testing.assert_array_equal(ft.variables[k][:], v[:])
    assert tconvert.main([str(tmp_path / "t.nc"), str(tmp_path / "b.h5")]) \
        == 0
    with h5py.File(str(tmp_path / "b.h5")) as h, \
            h5py.File(str(tmp_path / "o.h5")) as o:
        assert h["temp"].maxshape == (None, 2, 3, 1, 4)
        assert h["x"].maxshape == (4,)
        np.testing.assert_array_equal(h["temp"][()], o["temp"][()])
    with pytest.raises(SystemExit):
        tconvert.main([str(tmp_path / "t.nc"), str(tmp_path / "c.nc")])


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    cpl, state = _state()
    timers = observe.ModuleTimers()
    with observe.profile_trace(str(tmp_path / "log")) as prof:
        timers.run_module("pam:warm", lambda s: {**s, "temp": s["temp"] * 2},
                          state)
    assert any(e.name == "pam:warm" for e in prof.events())
    with open(tmp_path / "log" / "trace.json") as f:
        assert "pam:warm" in f.read()

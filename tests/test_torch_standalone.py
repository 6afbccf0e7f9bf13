"""The port's standalone MMF driver against pam_tpu's, on the four
configs/input_mmf_*.yaml cut to a small grid.

* load_config equals yaml.safe_load on every file in configs/, and
  refuses what it cannot read flatly; build_zint equals pam_tpu's;
* each config, loaded from its file and shrunk by SHRINK (every other key
  as the file sets it), through both packages' run_mmf: the setup
  arguments agree, the port's own initial state equals pam_tpu's at 1e-12
  apart from the perturbed levels, and from pam_tpu's initial state
  carried across the final state matches at 1e-9 per field (P3 fields by
  test_torch_mmf.P3_GOLDEN_TOL: pam_tpu's run is jitted);
* the production config runs in f32 as it says (f64: false); it is held
  in f64 against pam_tpu, and its f32 run against its f64 run by
  F32_TOL;
* run_mmf's NetCDF output has pam_tpu's layout and record count, both
  packages' writers write the same arrays from the same state, the
  callback fires once per GCM step, ens_chunk is refused as pam_tpu
  refuses it, and an idealized config is refused.
"""

import contextlib
import glob
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml
from scipy.io import netcdf_file

import pam_tpu.driver.mmf as jmmf
import pam_tpu.driver.standalone as jstandalone
import pam_tpu_torch.driver.mmf as tmmf
import pam_tpu_torch.driver.standalone as tstandalone
from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
from test_torch_mmf import P3_GOLDEN_TOL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
MMF = ("kessler", "p3", "pamc", "production")
# the cut: 16x1x12 cells, 2 members, 2 GCM steps of 5 CRM steps (dt_crm_phys
# stays 20 s); every other key as the file sets it
SHRINK = dict(crm_nx=16, crm_nz=12, nens=2, dt_gcm=100, sim_time=200)
P3_FIELDS = ("cloud_water", "cloud_water_num", "rain", "rain_num", "ice",
             "ice_num", "ice_rime", "ice_rime_vol")
# production config, the port's f32 run against its f64 run after 10 CRM
# steps from the same start, relative to each field's largest |value|:
# 1e-4, but 2e-2 for wvel (~0.1 m/s after 10 steps) and for the forcing
# tendencies (differences of two nearly equal columns, held as below
# relative to at least 1e-6), where f32 rounding shows at 1e-3 to 1e-2
F32_TOL, F32_TOL_NOISY = 1e-4, 2e-2


def reduced(name, tmp_path, **extra):
    """configs/input_mmf_<name>.yaml with SHRINK and ``extra`` applied;
    output, if any, goes to tmp_path."""
    cfg = tstandalone.load_config(
        os.path.join(ROOT, "configs", f"input_mmf_{name}.yaml"))
    cfg.update(SHRINK, out_prefix=str(tmp_path / name), **extra)
    return cfg


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_equals_yaml(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = tstandalone.load_config(path)
    assert got == ref
    assert [type(v) for v in got.values()] == [type(v) for v in ref.values()]


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: 2\n", "a:\n- 1\n", "a: [1, 2]\n", "a: {b: 1}\n",
    "a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n", "a: 1\na: 2\n",
    "---\na: 1\n", "a: 0x1f\n", "a: 1:30\n", "a: b: c\n", " a: 1\n"])
def test_load_config_refuses_what_is_not_flat(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        tstandalone.load_config(str(path))


def test_load_config_scalars(tmp_path):
    path = tmp_path / "c.yaml"
    text = ("# head\na: 20.  # tail\nb: -1.\nc: 1_000\nd: true\ne: Off\n"
            "f: ~\ng: 'x # y'\nh: 1e3\ni: .5\nj: -.inf\nk: auto\nl:\n"
            "m: a#b\n")
    path.write_text(text)
    assert tstandalone.load_config(str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("cfg", [
    {"crm_nz": 50, "zlen": 20000}, {"crm_nz": 12, "zlen": 20000.0},
    {"crm_nz": 7}] + [{"config": n} for n in MMF])
def test_build_zint_equals_jax(cfg):
    if "config" in cfg:
        cfg = tstandalone.load_config(
            os.path.join(ROOT, "configs", f"input_mmf_{cfg['config']}.yaml"))
    np.testing.assert_array_equal(tstandalone.build_zint(cfg),
                                  jstandalone.build_zint(cfg))


class Capture:
    """Wraps a package's setup_supercell_mmf inside its run_mmf: records
    the arguments and the initial state, and optionally hands run_mmf
    another initial state."""

    def __init__(self, monkeypatch, module, replace=None):
        self.real = module.setup_supercell_mmf
        self.replace = replace
        monkeypatch.setattr(module, "setup_supercell_mmf", self)

    def __call__(self, **kw):
        self.kw = dict(kw)
        drv, state = self.real(**kw)
        self.drv, self.state = drv, state
        if self.replace is not None:
            state = self.replace(state)
        return drv, state


def _run_pair(name, tmp_path):
    """pam_tpu's run_mmf on the reduced config in f64, then the port's
    from pam_tpu's initial state, output every 100 s into tmp_path
    (j.nc, t.nc); returns (jax capture, jax final, port capture, port
    final, the port's printed lines) with numpy leaves."""
    cfg = reduced(name, tmp_path, f64=True, out_freq=100.0)
    with pytest.MonkeyPatch.context() as mp:
        jcap = Capture(mp, jmmf)
        jfinal = jstandalone.run_mmf(
            dict(cfg, out_prefix=str(tmp_path / "j")), verbose=False)
        jinit = {k: np.asarray(v) for k, v in jcap.state.items()}
        tcap = Capture(mp, tmmf, replace=lambda s: state_from_numpy(
            jinit, "cpu", torch.float64))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tfinal = tstandalone.run_mmf(
                dict(cfg, out_prefix=str(tmp_path / "t")), verbose=True,
                device="cpu")
    return (jcap, {k: np.asarray(v) for k, v in jfinal.items()}, tcap,
            state_to_numpy(tfinal), out.getvalue().splitlines())


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """_run_pair per config, run once for the tests that read it."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (tmp_path_factory.mktemp(name),)
            cache[name] += _run_pair(name, cache[name][0])
        return cache[name]
    return get


@pytest.mark.parametrize("name", MMF)
def test_reduced_config_matches_jax(name, pairs):
    _, jcap, jfinal, tcap, tfinal, _ = pairs(name)
    # the same setup call (the port adds the device; dtypes by name)
    tkw, jkw = dict(tcap.kw), dict(jcap.kw)
    assert tkw.pop("device") == "cpu"
    assert str(tkw.pop("dtype")) == "torch." + jnp.dtype(jkw.pop("dtype")).name
    zj, zt = jkw.pop("zint"), tkw.pop("zint")
    np.testing.assert_array_equal(zt, zj)
    assert tkw == jkw
    # the port's own initial state equals pam_tpu's, the perturbed
    # temperature included
    tinit = state_to_numpy(tcap.state)
    assert sorted(tinit) == sorted(jcap.state)
    for k, v in jcap.state.items():
        a, b = np.asarray(v), tinit[k]
        assert a.shape == b.shape and _rel(a, b) < 1e-12, k
    # from pam_tpu's initial state, the runs agree
    assert sorted(tfinal) == sorted(jfinal)
    for k in jfinal:
        tol = P3_GOLDEN_TOL.get(k, 1e-9) if k in P3_FIELDS + ("wvel",) and \
            jkw["micro"] == "p3" else 1e-9
        # a forcing tendency is held relative to at least 1e-6 (per s):
        # below that it is the rounding of a difference of two equal
        # columns (gcm_forcing_tend_rho_d is ~7e-9 here, of a density ~1)
        floor = 1e-6 if k.startswith("gcm_forcing_tend_") else 1e-9
        scale = max(float(np.abs(jfinal[k]).max()), floor)
        assert float(np.abs(jfinal[k] - tfinal[k]).max()) < tol * scale, k


def test_production_config_f32_against_f64(tmp_path, monkeypatch):
    """The production config as it says (f32), against the same run in
    f64, both the port's, from pam_tpu's f64 initial state."""
    cfg = reduced("production", tmp_path)
    assert cfg["f64"] is False and cfg["ens_chunk"] == "auto"
    _, state = jmmf.setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=cfg["xlen"], ylen=cfg["ylen"],
        zint=jstandalone.build_zint(cfg), micro="p3", sgs="shoc",
        dt_gcm=100.0, dycore="spam", dtype=jnp.float64, state_only=True)
    init = {k: np.asarray(v) for k, v in state.items()}
    out = {}
    for dtype in (torch.float32, torch.float64):
        Capture(monkeypatch, tmmf,
                replace=lambda s, d=dtype: state_from_numpy(init, "cpu", d))
        final = tstandalone.run_mmf(dict(cfg, f64=dtype == torch.float64),
                                    verbose=False, device="cpu")
        assert all(v.dtype == dtype for v in final.values())
        out[dtype] = state_to_numpy(final)
    for k, ref in out[torch.float64].items():
        got = out[torch.float32][k].astype(np.float64)
        assert np.isfinite(got).all(), k
        floor = 1e-6 if k.startswith("gcm_forcing_tend_") else 1e-30
        err = float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                   floor)
        noisy = k == "wvel" or k.startswith("gcm_forcing_tend_")
        assert err < (F32_TOL_NOISY if noisy else F32_TOL), (k, err)


def test_run_mmf_writes_pam_tpus_layout(pairs):
    """The reduced Kessler config with out_freq 100 through both
    packages' run_mmf: the same dimensions, variables, times, zint and
    record count; the verbose line once per GCM step."""
    tmp_path, *_, lines = pairs("kessler")
    lines = [ln for ln in lines if ln.startswith("Etime")]
    assert [ln.split("maxw:")[1].split(",")[0].strip() for ln in lines] \
        == ["100.0", "200.0"]
    with netcdf_file(str(tmp_path / "j.nc"), "r", mmap=False) as fj, \
            netcdf_file(str(tmp_path / "t.nc"), "r", mmap=False) as ft:
        assert ft.dimensions == fj.dimensions
        assert sorted(ft.variables) == sorted(fj.variables)
        for k, v in fj.variables.items():
            assert ft.variables[k].dimensions == v.dimensions, k
            assert ft.variables[k].shape == v.shape, k
        assert ft.variables["t"].shape[0] == 3      # t = 0, 100, 200
        for k in ("t", "zint", "x", "y"):
            np.testing.assert_array_equal(ft.variables[k][:],
                                          fj.variables[k][:])
        np.testing.assert_array_equal(
            ft.variables["zint"][:, 0],
            jstandalone.build_zint(reduced("kessler", tmp_path)))


@pytest.mark.parametrize("backend", ["netcdf", "hdf5"])
def test_writers_write_the_same_arrays(tmp_path, backend):
    """Both packages' writers, fed the same state, write the same arrays."""
    import h5py
    from pam_tpu.io.output import make_writer as jwriter
    from pam_tpu_torch.io.output import make_writer as twriter
    kw = dict(nx=8, ny=1, nz=8, nens=2, xlen=16000.0, ylen=64000.0,
              zlen=16000.0, dycore="spam")
    jdrv, jstate = jmmf.setup_supercell_mmf(**kw, dtype=jnp.float64)
    init = {k: np.asarray(v) for k, v in jstate.items()}
    init["precl"] = np.random.default_rng(0).random(init["precl"].shape)
    tstate = state_from_numpy(init, "cpu", torch.float64)
    tdrv, _ = tmmf.setup_supercell_mmf(**kw, device="cpu")
    paths = {}
    for side, make, cpl, state in (
            ("j", jwriter, jdrv.coupler, {k: jnp.asarray(v)
                                          for k, v in init.items()}),
            ("t", twriter, tdrv.coupler, tstate)):
        w = make(cpl, state, str(tmp_path / side), backend)
        w.write(state, 0.0)
        w.write(state, 20.0)
        w.close()
        paths[side] = w.fname
    if backend == "netcdf":
        with netcdf_file(paths["j"], "r", mmap=False) as fj, \
                netcdf_file(paths["t"], "r", mmap=False) as ft:
            assert sorted(ft.variables) == sorted(fj.variables)
            for k, v in fj.variables.items():
                np.testing.assert_array_equal(ft.variables[k][:], v[:], k)
    else:
        with h5py.File(paths["j"]) as fj, h5py.File(paths["t"]) as ft:
            assert sorted(ft) == sorted(fj)
            for k in fj:
                np.testing.assert_array_equal(ft[k][()], fj[k][()], k)


def test_ens_chunk_is_refused_as_pam_tpu_refuses_it(tmp_path):
    cfg = reduced("kessler", tmp_path, nens=4, ens_chunk=3, out_freq=-1.0)
    with pytest.raises(ValueError, match="ens_chunk=3 must divide nens=4") \
            as jerr:
        jstandalone.run_mmf(cfg, verbose=False)
    with pytest.raises(ValueError) as terr:
        tstandalone.run_mmf(cfg, verbose=False, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_callback_once_per_gcm_step_and_idealized_refused(tmp_path,
                                                          monkeypatch):
    cfg = reduced("kessler", tmp_path, out_freq=-1.0, crm_nx=8, crm_nz=8,
                  nens=1, dt_gcm=40, sim_time=120)
    seen = []
    real_run = tmmf.MmfDriver.run

    def run(self, state, sim_time, callback=None):
        return real_run(self, state, sim_time,
                        lambda s, t: (seen.append(t), callback(s, t)))
    monkeypatch.setattr(tmmf.MmfDriver, "run", run)
    tstandalone.run_mmf(cfg, verbose=False, device="cpu")
    assert seen == [40.0, 80.0, 120.0]
    with pytest.raises(NotImplementedError, match="idealized"):
        tstandalone.run_mmf(dict(cfg, idealized=True), device="cpu")


def test_main_runs_a_config_file(tmp_path, monkeypatch, capsys):
    """python -m pam_tpu_torch.driver.standalone <config>: main() loads the
    file and runs it (on the CPU here, as run_mmf is told)."""
    cfg_path = tmp_path / "c.yaml"
    cfg = reduced("pamc", tmp_path, crm_nx=8, crm_nz=8, nens=1, dt_gcm=20,
                  sim_time=20, out_freq=-1.0)
    cfg_path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    real = tstandalone.run_mmf
    monkeypatch.setattr(tstandalone, "run_mmf",
                        lambda c: real(c, device="cpu"))
    assert tstandalone.main([str(cfg_path)]) == 0
    assert "Simulation Time: 20" in capsys.readouterr().out
    assert tstandalone.main([]) == 1


def test_setup_defaults_equal_jax():
    """setup_supercell_mmf takes pam_tpu's parameters in pam_tpu's order
    with pam_tpu's defaults (dycore "awfl", float64); the port adds
    device, "cuda" by default."""
    import inspect
    jp = inspect.signature(jmmf.setup_supercell_mmf).parameters
    tp = dict(inspect.signature(tmmf.setup_supercell_mmf).parameters)
    assert tp.pop("device").default == "cuda"
    assert list(tp) == list(jp)
    for k, p in jp.items():
        if k == "dtype":
            assert tp[k].default == torch.float64
            assert jnp.dtype(p.default) == np.float64
        else:
            assert tp[k].default == p.default, k


@pytest.mark.parametrize("dycore", ["awfl", "spam"])
def test_micro_none_is_refused_by_both(dycore):
    """pam_tpu accepts micro="none" and then fails in its setup, as no
    tracer is registered; the port refuses it first, with its reason."""
    kw = dict(nx=8, ny=1, nz=8, nens=1, xlen=16000.0, zlen=16000.0,
              micro="none", dycore=dycore)
    with pytest.raises(ValueError) as jerr:
        jmmf.setup_supercell_mmf(**kw)
    assert str(jerr.value) == {
        "awfl": "Need at least one array to stack.",
        "spam": "tuple.index(x): x not in tuple"}[dycore]
    with pytest.raises(ValueError, match="micro='none'"):
        tmmf.setup_supercell_mmf(**kw, device="cpu")


def test_setup_options(monkeypatch):
    """zint, perturb_seeds, dycore_kwargs and micro_kwargs reach what they
    set; a zint of the wrong length and a card that is absent are
    refused."""
    kw = dict(nx=8, ny=1, nz=8, nens=2, xlen=16000.0, zlen=16000.0,
              dycore="spam", device="cpu")
    drv, state = tmmf.setup_supercell_mmf(
        **kw, perturb_seeds=[3, 3], dycore_kwargs={"si_max_iters": 2},
        micro_kwargs={"ens_chunk": 1})
    assert torch.equal(state["temp"][0], state["temp"][1])
    assert drv.dycore.si_max_iters == 2 and drv.micro.ens_chunk == 1
    zint = jstandalone.build_zint({"crm_nz": 8, "zlen": 16000.0})
    drv, state = tmmf.setup_supercell_mmf(**kw, zint=zint)
    np.testing.assert_array_equal(
        state["vertical_interface_height"][0].numpy(), zint)
    assert drv.dycore.tend.vert_per_level() is not None
    with pytest.raises(ValueError, match="9 interface heights"):
        tmmf.setup_supercell_mmf(**kw, zint=zint[:-1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmmf.setup_supercell_mmf(**dict(kw, device="cuda"))
    with pytest.raises(RuntimeError, match="is_available"):
        tstandalone.run_mmf(dict(SHRINK, xlen=16000.0, dt_crm_phys=20.0,
                                 out_freq=-1.0), verbose=False)


def test_mmf_pamc_small_golden_init_file_is_current():
    from test_torch_mmf import _check_init_file_is_current
    _check_init_file_is_current("mmf_pamc_small")


def test_mmf_pamc_small_trajectory_from_jax_initial_state():
    """configs/input_mmf_pamc.yaml cut to 16x1x12 nens 2 on its build_zint
    levels (stretched-grid SPAM+SI, Kessler): from
    tests/golden/mmf_pamc_small_init.npz, 10 port steps match pam_tpu's
    jitted and op-by-op runs at 1e-9 per field (chip_smoke.py phase 12
    on the card)."""
    import sys
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from make_torch_golden_init import pamc_small_kwargs
    finally:
        sys.path.pop(0)
    drv, _ = tmmf.setup_supercell_mmf(**pamc_small_kwargs("cpu"))
    assert drv.dycore.tend.vert_per_level() is not None
    init = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "mmf_pamc_small_init.npz")))
    state = state_from_numpy(init, "cpu", torch.float64)
    for _ in range(10):
        state = drv.crm_phys_step(state)
    out = state_to_numpy(state)
    for name in ("mmf_pamc_small", "mmf_pamc_small_opbyop"):
        ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        assert len(ref.files) == 7
        for k in ref.files:
            assert _rel(ref[k], out[k]) < 1e-9, (name, k)

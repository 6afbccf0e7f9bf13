"""The 3-D SPAM slice of the port end to end against pam_tpu, f64 on the
CPU: run_idealized over configs/input_risingbubble3d.yaml and
configs/input_supercell3d.yaml cut to 10x8x10 cells and 2 members
(tools/make_torch_golden_init.py::ideal_small_config; the supercell in
float64, and once more through the plain pressure system), and the
coupled ny > 1 SPAM+Kessler CRM step (SPAM3D_KW, 12x8x12, 2 members)
from the carried-across start state.

* every field of the port's final state within 1e-9 of pam_tpu's jitted
  run (relative to its largest |value|); pam_tpu's runs equal
  tests/golden/ideal_{risingbubble3d,supercell3d}_small.npz and
  mmf_spam3d_small{,_init}.npz (the golden files are current);
* B1 is called 6 times a 3-D right-hand side, 18 times an SSPRK3 step and
  an SI step of 3 iterations (on the CPU its plain version: 0 launches);
* the coupled 3-D step on a y-invariant state reproduces the slab's;
* the statistics file, main() on a 3-D file, the numerics knobs ignored
  as pam_tpu ignores them, and the refusals of what the 3-D model has
  not (diffusion, anelastic, other integrators, the slab-only velocity
  system).
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import pam_tpu_torch.driver.standalone as tstandalone
from pam_tpu_torch.convert import state_from_numpy
from pam_tpu_torch.driver.mmf import setup_supercell_mmf
from pam_tpu_torch.ops import weno_x
from pam_tpu_torch.spam import si as tsi
from pam_tpu_torch.spam.extruded3d import Tendencies3D

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_golden_init as golden  # noqa: E402

torch.set_num_threads(1)

TRAJ_TOL = 1e-9
# (config, what the cut changes beyond ideal_small_config)
RUNS = {"risingbubble3d": ("risingbubble3d", {}),
        "supercell3d": ("supercell3d", {}),
        "supercell3d_pressure": ("supercell3d",
                                 {"linear_system": "pressure"})}
COUPLED_FIELDS = ("temp", "uvel", "vvel", "wvel", "density_dry",
                  "water_vapor", "cloud_liquid", "precip_liquid")


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _cfg(run, **kw):
    name, extra = RUNS[run]
    return dict(golden.ideal_small_config(name, **kw), **extra)


@pytest.fixture(scope="module")
def runs():
    """{run: (pam_tpu's final (dens, v, w), the port's)} built on
    demand."""
    import pam_tpu.driver.standalone as jstandalone
    cache = {}

    def get(run):
        if run not in cache:
            ref = jstandalone.run_idealized(_cfg(run), verbose=False)
            got = tstandalone.run_idealized(_cfg(run), verbose=False,
                                            device="cpu")
            cache[run] = ([np.asarray(a) for a in ref], got)
        return cache[run]
    return get


@pytest.mark.parametrize("run", list(RUNS))
def test_run_idealized_3d_matches_jax(runs, run):
    ref, got = runs(run)
    assert got[1].shape[0] == 2 and got[0].ndim == 5
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        err = _rel(r, g)
        assert err < TRAJ_TOL, (run, field, err)


@pytest.mark.parametrize("name", golden.IDEAL3D_GOLDEN)
def test_ideal3d_golden_file_is_current(runs, name):
    ref, got = runs(name)
    gold = np.load(golden.ideal_path(name))
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert _rel(gold[field], r) < 1e-12, (name, field)
        assert _rel(gold[field], g) < TRAJ_TOL, (name, field)


def test_the_3d_cut_keeps_each_config_s_integrator():
    """What the cut keeps from the files: risingbubble3d's SSPRK3 at the
    acoustic rule's step (dy counts), the supercell's SI steps of 10 s
    through pressure_gravity."""
    rb = _cfg("risingbubble3d")
    assert rb["tstype"] == "ssprk3" and rb["crm_ny"] == 8
    tc_dx = 1000.0 / rb["crm_nx"]
    assert tstandalone.idealized_dt(rb) == pytest.approx(
        0.3 * min(tc_dx, 1000.0 / rb["crm_ny"], 1500.0 / rb["crm_nz"]) /
        350.0)
    sc = _cfg("supercell3d")
    assert (sc["tstype"], sc["dtcrm"], sc["linear_system"], sc["f64"]) == \
        ("si", 10.0, "pressure_gravity", True)
    for run in RUNS:
        cfg = _cfg(run)
        steps = int(np.ceil(cfg["sim_time"] / tstandalone.idealized_dt(cfg)))
        assert steps == golden.IDEAL3D_STEPS[RUNS[run][0]]


@pytest.mark.parametrize("run", ("risingbubble3d", "supercell3d"))
def test_b1_calls_per_3d_step(monkeypatch, run):
    """From the code: Tendencies3D.recons reconstructs the densities, qhz
    and qxy along x and y, 6 B1 calls a right-hand side; an SSPRK3 step
    takes 3 right-hand sides, an SI step of 3 iterations compute_rhs and
    2 quasi-Newton evaluations: 18 either way. On the CPU every call takes
    the plain version and nothing is launched."""
    calls, kinds = [], []
    real = weno_x.weno_edges_x

    def counted(field, tables, kind="x"):
        calls.append(tuple(field.shape))
        kinds.append(kind)
        return real(field, tables, kind)
    monkeypatch.setattr(weno_x, "weno_edges_x", counted)
    tend, step, x, geop, dt, _ = tstandalone.idealized_setup(
        _cfg(run, nsteps=1), "cpu")
    assert isinstance(tend, Tendencies3D)
    before = weno_x.weno_edges_x_cuda.launches
    step(*x)
    assert len(calls) == 18
    assert weno_x.weno_edges_x_cuda.launches == before
    # half of them along y: the field with y moved last
    nx, ny = x[0].shape[-1], x[0].shape[-2]
    last = [c[-1] for c in calls[:6]]
    assert last.count(nx) == 3 and last.count(ny) == 3
    # the y ones name their axis, for the halo exchange under y sharding
    assert kinds.count("y") == 9 and kinds.count("x") == 9


# --------------------------------------------------------- coupled 3-D
@pytest.fixture(scope="module")
def coupled_run():
    """The port's 3 CRM steps of mmf_spam3d_small from its _init file."""
    drv, _ = setup_supercell_mmf(**golden.SPAM3D_KW, dtype=torch.float64,
                                 device="cpu")
    state = state_from_numpy(dict(np.load(golden.path("mmf_spam3d_small"))),
                             "cpu", torch.float64)
    for _ in range(golden.SPAM3D_NSTEPS):
        state = drv.crm_phys_step(state)
    return drv, state


def test_coupled_3d_steps_match_golden(coupled_run):
    drv, state = coupled_run
    assert drv.dycore.ndims == 2 and isinstance(
        drv.dycore.si_linsys, tsi.CompressiblePressureGravityLinearSystem)
    gold = np.load(golden.out_path("mmf_spam3d_small"))
    assert set(COUPLED_FIELDS) <= set(gold.files)
    for k in gold.files:
        assert _rel(gold[k], state[k]) < TRAJ_TOL, k
    assert float(state["vvel"].abs().max()) > 0.0    # the flow is 3-D


def test_coupled_3d_golden_files_are_current():
    """pam_tpu's start state and 3 jitted CRM steps equal
    tests/golden/mmf_spam3d_small{_init,}.npz."""
    init = golden.initial_state("mmf_spam3d_small")
    gold = np.load(golden.path("mmf_spam3d_small"))
    assert set(init) == set(gold.files)
    for k in init:
        np.testing.assert_array_equal(init[k], gold[k], err_msg=k)
    traj = golden.trajectory("mmf_spam3d_small", golden.SPAM3D_NSTEPS,
                             False)
    gold = np.load(golden.out_path("mmf_spam3d_small"))
    for k in traj:
        assert _rel(gold[k], traj[k]) < 1e-12, k


def test_coupled_3d_ydegenerate_matches_slab():
    """The port's copy of tests/test_spam3d_coupled.py::
    test_3d_coupled_ydegenerate_matches_slab: a y-invariant coupled state
    (ylen = ny, so dy = 1 as in the slab) steps as the slab does through
    pressure_gravity, and vvel stays zero."""
    kw = dict(nx=16, nz=12, nens=2, xlen=32000.0, ylen=4.0, zlen=20000.0,
              micro="kessler", dt_gcm=80.0, dt_crm_phys=20.0, dycore="spam",
              dycore_kwargs={"linear_system": "pressure_gravity"},
              dtype=torch.float64, device="cpu")
    drv1, s1 = setup_supercell_mmf(ny=1, **kw)
    drv3, _ = setup_supercell_mmf(ny=4, **kw)
    s3 = {k: (v.expand(*v.shape[:2], 4, v.shape[3]).contiguous()
              if v.ndim == 4 and v.shape[2] == 1 else
              v.expand(v.shape[0], 4, v.shape[2]).contiguous()
              if v.ndim == 3 and v.shape[1] == 1 else v)
          for k, v in s1.items()}
    out1 = drv1.dycore.timestep(s1, 20.0)
    out3 = drv3.dycore.timestep(s3, 20.0)
    for k in ("temp", "uvel", "wvel", "density_dry", "water_vapor"):
        for j in range(4):
            assert _rel(out1[k][:, :, 0], out3[k][:, :, j]) < 1e-12, (k, j)
    assert float(out3["vvel"].abs().max()) < 1e-10


# ------------------------------------------------------- the entry point
def test_3d_statistics_file(tmp_path):
    """out_prefix in 3-D: the statistics at t=0 and every stat_freq, with
    the three PV components; mass conserved to 1e-13."""
    cfg = _cfg("supercell3d", nsteps=2)
    cfg.update(stat_freq=cfg["dtcrm"], out_prefix=str(tmp_path / "s"))
    tstandalone.run_idealized(cfg, verbose=False, device="cpu")
    with netcdf_file(str(tmp_path / "s_stats.nc"), mmap=False) as f:
        assert f.variables["t"].shape == (3,)
        assert f.variables["PV"].shape == (3, 3, 2)
        assert "PENS" not in f.variables
        mass = f.variables["densstat"][:, 0, :].copy()
    assert np.abs(mass - mass[0]).max() / np.abs(mass[0]).max() < 1e-13


def test_main_runs_a_3d_file(tmp_path, monkeypatch, capsys):
    """python -m pam_tpu_torch.driver.standalone <3-D config>: main()
    takes run_idealized, which builds the run with idealized_setup_3d."""
    seen = []
    real = tstandalone.idealized_setup_3d
    monkeypatch.setattr(
        tstandalone, "idealized_setup_3d",
        lambda c, device: seen.append(c) or real(c, "cpu"))
    cfg = _cfg("supercell3d", nsteps=2)
    cfg.update(crm_nx=6, crm_ny=4, crm_nz=6, nens=1, f64=False,
               stat_freq=cfg["sim_time"])
    path = tmp_path / "sc3d.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    assert tstandalone.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "Run Time:" in out and " E=" in out
    assert [c["crm_ny"] for c in seen] == [4]


@pytest.mark.parametrize("change,what", [
    ({"scalar_horiz_diffusion_coeff": 100.0}, "scalar_horiz_diffusion"),
    ({"hamil": "an"}, "hamil an"),
    ({"tstype": "rk4"}, "tstype rk4"),
    ({"tstype": "si_fixed"}, "tstype si_fixed"),
    ({"tstype": "si", "linear_system": "velocity"}, "linear_system")])
def test_3d_run_refuses_what_the_3d_model_has_not(change, what):
    """pam_tpu's run_idealized_3d ignores these keys (and takes SSPRK3 for
    any tstype but si); the port refuses them, naming them."""
    cfg = dict(_cfg("risingbubble3d", nsteps=1), **change)
    with pytest.raises(ValueError, match=what):
        tstandalone.run_idealized(cfg, verbose=False, device="cpu")


def test_3d_run_ignores_the_numerics_knobs(runs):
    """pam_tpu's run_idealized_3d builds Tendencies3D with its default
    numerics whatever the config says; so does the port: the same run
    with the three numerics knobs set gives the same state, bit for
    bit."""
    cfg = dict(_cfg("risingbubble3d"), reconstruction_type="cfv",
               dual_upwind_type="tanh", tanh_upwind_coeff=10.0)
    got = tstandalone.run_idealized(cfg, verbose=False, device="cpu")
    for a, b in zip(runs("risingbubble3d")[1], got):
        assert torch.equal(a, b)

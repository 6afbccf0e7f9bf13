"""The port's run_idealized against pam_tpu's, on the x-z
configs/input_*.yaml cut to 16x12 cells and 2 members
(tools/make_torch_golden_init.py::ideal_small_config), f64 on the CPU.

* the five configs that stay finite, each with its own tstype, dtcrm,
  si_max_iters and diffusion keys: the final (dens, v, w) within 1e-9 of
  pam_tpu's jitted run per field (relative to its largest |value|);
  pam_tpu's run equals tests/golden/ideal_<case>_small.npz where there is
  one (the golden file is current);
* the two configs whose dtcrm breaks the acoustic limit under SSPRK3
  (twobubbles, moistrisingbubble) go non-finite within 10 steps in both
  packages, and stay finite at the acoustic rule's step;
* the conservation statistics file, the B1 launch count (0 on the CPU),
  main() on an idealized file, the unknown tstype and the missing
  reference state refused (the 3-D configs run in
  tests/test_torch_spam3d_runs.py, the anelastic and layer ones in
  tests/test_torch_anelastic.py and tests/test_torch_layer.py).
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import pam_tpu.driver.standalone as jstandalone
import pam_tpu_torch.driver.standalone as tstandalone
from pam_tpu_torch.ops import weno_x

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_golden_init as golden  # noqa: E402

torch.set_num_threads(1)

TRAJ_TOL = 1e-9
STABLE = tuple(golden.IDEAL_STEPS)
UNSTABLE = ("twobubbles", "moistrisingbubble")


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


@pytest.fixture(scope="module")
def runs():
    """{name: (pam_tpu's final (dens, v, w), the port's)} built on
    demand."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = golden.ideal_small_config(name)
            ref = jstandalone.run_idealized(dict(cfg), verbose=False)
            got = tstandalone.run_idealized(dict(cfg), verbose=False,
                                            device="cpu")
            cache[name] = ([np.asarray(a) for a in ref], got)
        return cache[name]
    return get


@pytest.mark.parametrize("name", STABLE)
def test_run_idealized_matches_jax(runs, name):
    ref, got = runs(name)
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        err = _rel(r, g)
        assert err < TRAJ_TOL, (name, field, err)


@pytest.mark.parametrize("name", golden.IDEAL_GOLDEN)
def test_ideal_golden_file_is_current(runs, name):
    ref, got = runs(name)
    gold = np.load(golden.ideal_path(name))
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert _rel(gold[field], r) < 1e-12, (name, field)
        assert _rel(gold[field], g) < TRAJ_TOL, (name, field)


def test_the_cut_keeps_each_config_s_integrator():
    """What the cut keeps from the files: the supercell's five SI
    iterations and six diffusion coefficients, gravitywave's and
    largerisingbubble's SI steps, the explicit SSPRK3 of the others."""
    cfg = golden.ideal_small_config("supercell")
    assert cfg["tstype"] == "si" and cfg["si_max_iters"] == 5
    assert all(cfg[k] > 0 for k in tstandalone.DIFFUSION_KEYS)
    for name in STABLE:
        cfg = golden.ideal_small_config(name)
        dt = tstandalone.idealized_dt(cfg)
        assert int(np.ceil(cfg["sim_time"] / dt)) == \
            golden.IDEAL_STEPS[name]
        assert (cfg.get("tstype", "ssprk3") == "si") == \
            (name in ("gravitywave", "largerisingbubble", "supercell"))


@pytest.mark.parametrize("name", UNSTABLE)
def test_dtcrm_deviation_goes_non_finite_in_both(name):
    """The files' dtcrm (twobubbles 0.5 s, moistrisingbubble 1 s) under
    SSPRK3 is above the acoustic limit: both packages' runs go non-finite
    within 10 steps; the same grid at the acoustic rule's step stays
    finite. The port keeps the reference's configs as they are."""
    cfg = golden.ideal_small_config(name, nsteps=10)
    assert cfg.get("tstype", "ssprk3") == "ssprk3"
    ref = jstandalone.run_idealized(dict(cfg), verbose=False)
    assert not all(np.isfinite(np.asarray(a)).all() for a in ref)
    tend, step, x, geop, dt, nsteps = tstandalone.idealized_setup(cfg, "cpu")
    assert nsteps == 10 and dt == cfg["dtcrm"]
    first_bad = None
    for n in range(nsteps):
        x = step(*x)
        if not all(bool(torch.isfinite(a).all()) for a in x):
            first_bad = n + 1
            break
    assert first_bad is not None and first_bad > 1, first_bad
    acoustic = {k: v for k, v in cfg.items() if k != "dtcrm"}
    acoustic["sim_time"] = 9.5 * tstandalone.idealized_dt(acoustic)
    out = tstandalone.run_idealized(acoustic, verbose=False, device="cpu")
    assert all(bool(torch.isfinite(a).all()) for a in out)


def test_statistics_file_matches_jax(tmp_path):
    """out_prefix: the conservation statistics at t=0 and every stat_freq
    seconds, in pam_tpu's layout and values; mass conserved to 1e-13."""
    cfg = golden.ideal_small_config("largerisingbubble", nsteps=4)
    cfg["stat_freq"] = 2 * cfg["dtcrm"]
    jstandalone.run_idealized(dict(cfg, out_prefix=str(tmp_path / "j")),
                              verbose=False)
    before = weno_x.weno_edges_x_cuda.launches
    tstandalone.run_idealized(dict(cfg, out_prefix=str(tmp_path / "t")),
                              verbose=False, device="cpu")
    assert weno_x.weno_edges_x_cuda.launches == before  # CPU: no kernel
    with netcdf_file(str(tmp_path / "j_stats.nc"), mmap=False) as fj, \
            netcdf_file(str(tmp_path / "t_stats.nc"), mmap=False) as ft:
        assert set(fj.variables) == set(ft.variables)
        assert fj.variables["t"].shape == ft.variables["t"].shape == (3,)
        for k in fj.variables:
            r, g = fj.variables[k][:], ft.variables[k][:]
            assert r.shape == g.shape, k
            if k == "PV":
                # the domain sum of the curl vanishes (periodic x, zero
                # boundary rows): both hold rounding noise (~5e-8)
                assert np.abs(r - g).max() < 1e-9 and \
                    np.abs(g).max() < 1e-6, (r, g)
            else:
                assert _rel(r, g) < 1e-9, k
        mass = ft.variables["densstat"][:, 0, :]
        assert np.abs(mass - mass[0]).max() / np.abs(mass[0]).max() < 1e-13


def test_main_runs_an_idealized_file(tmp_path, monkeypatch, capsys):
    """python -m pam_tpu_torch.driver.standalone <idealized config>: main()
    takes run_idealized for ``idealized: true`` and for ``mode:
    idealized``."""
    real = tstandalone.run_idealized
    seen = []
    monkeypatch.setattr(tstandalone, "run_idealized",
                        lambda c: seen.append(c) or real(c, device="cpu"))
    for name in ("gravitywave", "risingbubble"):
        cfg = golden.ideal_small_config(name, nsteps=2)
        cfg.update(crm_nx=8, crm_nz=8, nens=1, stat_freq=cfg["sim_time"])
        path = tmp_path / f"{name}.yaml"
        path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
        assert tstandalone.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "Run Time:" in out and " E=" in out
    assert [c["init_data"] for c in seen] == ["gravitywave", "risingbubble"]
    assert seen[0]["mode"] == "idealized" and seen[1]["idealized"] is True


def test_unknown_tstype_and_missing_reference_state():
    cfg = golden.ideal_small_config("densitycurrent", nsteps=1)
    with pytest.raises(ValueError, match="unknown tstype"):
        tstandalone.run_idealized(dict(cfg, tstype="rk4"), verbose=False,
                                  device="cpu")
    # densitycurrent has no reference state: tstype si is refused, as in
    # pam_tpu
    for run in (lambda c: jstandalone.run_idealized(c, verbose=False),
                lambda c: tstandalone.run_idealized(c, verbose=False,
                                                    device="cpu")):
        with pytest.raises(ValueError, match="no reference state"):
            run(dict(cfg, tstype="si"))

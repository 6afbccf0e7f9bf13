"""The port's MMF slices end to end, against pam_tpu and the golden files.

* the deterministic initial state equals pam_tpu's (Kessler, P3+SHOC);
* the port's own temperature perturbation keeps pam_tpu's statistics;
* tests/golden/{kessler,p3_shoc}_spam_si_init.npz are what pam_tpu
  builds today;
* from those files, 10 port steps (f64, CPU) match
  tests/golden/kessler_spam_si.npz at 1e-9 per field — the bar of
  tests/test_golden.py — and tests/golden/p3_shoc_spam_si_opbyop.npz
  (pam_tpu's own run of the P3+SHOC steps op by op) at 1e-9 per field;
  against tests/golden/p3_shoc_spam_si.npz (one fused XLA program) the
  P3+SHOC run is held at 1e-9 where pam_tpu's op-by-op run is, and
  elsewhere within 10x of that run's own distance (P3_GOLDEN_TOL);
* the other physics options (P3 without SHOC, Kessler with SHOC) take
  the same step as pam_tpu.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
from pam_tpu_torch.driver.mmf import setup_supercell_mmf as torch_setup

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
          dt_crm_phys=20.0, dycore="spam")
P3KW = dict(KW, micro="p3", sgs="shoc")
# Distances of pam_tpu's own op-by-op P3+SHOC run
# (tests/golden/p3_shoc_spam_si_opbyop.npz) from the golden file, where
# they exceed 1e-9: 9.4e-9 (wvel), 5.0e-10 (cloud_water, near the bar),
# 1.1e-6 (rain), 3.0e-2 of ice's 6.6e-14 max. The bound is 10x that.
P3_GOLDEN_TOL = {"wvel": 1e-7, "cloud_water": 5e-9, "rain": 1.1e-5,
                 "ice": 0.3}


def _rel(a, b):
    scale = max(float(np.abs(a).max()), 1e-300)
    return float(np.abs(a - b).max()) / scale


def test_deterministic_initial_state_matches_jax():
    _, js = jax_setup(**KW, dtype=jnp.float64, state_only=True)
    _, ts = torch_setup(**KW, dtype=torch.float64, device="cpu",
                        state_only=True)
    assert sorted(js) == sorted(ts)
    nlev = KW["nz"] // 4
    for k in js:
        a, b = np.asarray(js[k]), ts[k].numpy()
        assert a.shape == b.shape and b.dtype == np.float64, k
        if k == "temp":   # the perturbed levels differ by construction
            a, b = a[:, nlev:], b[:, nlev:]
        assert _rel(a, b) < 1e-12, k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_perturbation_statistics(dtype):
    _, ts = torch_setup(**KW, dtype=dtype, device="cpu", state_only=True)
    nz, nlev = KW["nz"], KW["nz"] // 4
    temp = ts["temp"].double()
    base = ts["gcm_temp"].double()[:, :, None, None].expand_as(temp)
    # the horizontal mean of every level is conserved
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert _rel(base.mean(dim=(-2, -1)).numpy(),
                temp.mean(dim=(-2, -1)).numpy()) < tol
    # only the bottom nz/4 levels change, by about the 0.1 K amplitude
    # (plus the small per-level rescale)
    diff = (temp - base).abs()
    assert float(diff[:, nlev:].max()) <= tol * 300.0
    assert 0.01 < float(diff[:, :nlev].max()) < 0.2
    # members differ from each other; the same seeds repeat exactly
    assert not torch.equal(temp[0], temp[1])
    _, again = torch_setup(**KW, dtype=dtype, device="cpu", state_only=True)
    assert torch.equal(again["temp"], ts["temp"])


def _check_init_file_is_current(name):
    tools = os.path.join(os.path.dirname(GOLDEN), "..", "tools")
    sys.path.insert(0, os.path.abspath(tools))
    try:
        from make_torch_golden_init import initial_state
    finally:
        sys.path.pop(0)
    fresh = initial_state(name)
    committed = np.load(os.path.join(GOLDEN, f"{name}_init.npz"))
    assert sorted(fresh) == sorted(committed.files)
    for k in committed.files:
        np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)


def test_golden_init_file_is_current():
    _check_init_file_is_current("kessler_spam_si")


def test_p3_shoc_golden_init_file_is_current():
    _check_init_file_is_current("p3_shoc_spam_si")


def test_golden_trajectory_from_jax_initial_state():
    """The slice end to end: the port's driver on the carried-across
    initial state, 10 CRM steps, every field of the golden file at 1e-9."""
    drv, _ = torch_setup(**KW, dtype=torch.float64, device="cpu")
    init = dict(np.load(os.path.join(GOLDEN, "kessler_spam_si_init.npz")))
    state = state_from_numpy(init, "cpu", torch.float64)
    for _ in range(10):
        state = drv.crm_phys_step(state)
    out = state_to_numpy(state)
    golden = np.load(os.path.join(GOLDEN, "kessler_spam_si.npz"))
    assert len(golden.files) == 7
    for k in golden.files:
        assert _rel(golden[k], out[k]) < 1e-9, k


def test_p3_shoc_deterministic_initial_state_matches_jax():
    _, js = jax_setup(**P3KW, dtype=jnp.float64, state_only=True)
    _, ts = torch_setup(**P3KW, dtype=torch.float64, device="cpu",
                        state_only=True)
    assert sorted(js) == sorted(ts)
    nlev = KW["nz"] // 4
    for k in js:
        a, b = np.asarray(js[k]), ts[k].numpy()
        if k in ("temp", "t_prev"):   # the perturbed levels differ
            a, b = a[:, nlev:], b[:, nlev:]
        assert a.shape == b.shape and _rel(a, b) < 1e-12, k


def test_p3_shoc_golden_trajectory_from_jax_initial_state():
    """The P3+SHOC slice end to end: the port's driver on the
    carried-across initial state, 10 CRM steps, every field within 1e-9
    of pam_tpu's op-by-op run and within P3_GOLDEN_TOL (else 1e-9) of the
    golden file; the run rains, and its ice stays near zero."""
    drv, _ = torch_setup(**P3KW, dtype=torch.float64, device="cpu")
    assert drv.sgs.npbl == 1
    init = dict(np.load(os.path.join(GOLDEN, "p3_shoc_spam_si_init.npz")))
    state = state_from_numpy(init, "cpu", torch.float64)
    for _ in range(10):
        state = drv.crm_phys_step(state)
    out = state_to_numpy(state)
    golden = np.load(os.path.join(GOLDEN, "p3_shoc_spam_si.npz"))
    opbyop = np.load(os.path.join(GOLDEN, "p3_shoc_spam_si_opbyop.npz"))
    assert sorted(golden.files) == sorted(opbyop.files)
    assert len(golden.files) == 9
    assert np.count_nonzero(out["rain"]) > 50
    for k in golden.files:
        assert _rel(opbyop[k], out[k]) < 1e-9, k
        assert _rel(golden[k], out[k]) < P3_GOLDEN_TOL.get(k, 1e-9), k
        # the op-by-op file is a run of the golden config: it sits inside
        # the same bounds (a stale file would not)
        assert _rel(golden[k], opbyop[k]) < P3_GOLDEN_TOL.get(k, 1e-9), k


@pytest.mark.parametrize("micro,sgs", [("p3", "none"), ("kessler", "shoc")])
def test_other_physics_options_match_jax(micro, sgs):
    """One CRM step of P3 with saturation adjustment and of Kessler with
    SHOC, from pam_tpu's initial state, against pam_tpu's jitted step."""
    import jax
    from pam_tpu.modules import gcm_forcing as jforcing
    kw = dict(KW, micro=micro, sgs=sgs)
    jd, js = jax_setup(**kw, dtype=jnp.float64)
    js = jforcing.compute_gcm_forcing_tendencies(jd.coupler, js, jd.dt_gcm)
    td, _ = torch_setup(**kw, dtype=torch.float64, device="cpu")
    assert (td.sgs is None) == (sgs == "none")
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu",
                          torch.float64)
    ref = jax.jit(jd.crm_phys_step)(js)
    got = state_to_numpy(td.crm_phys_step(ts))
    assert sorted(ref) == sorted(got)
    for k in ref:
        # relative to the field's largest |value|, or to 1e-9 for fields
        # that are rounding noise (a forcing tendency of ~1e-20)
        a = np.asarray(ref[k])
        err = float(np.abs(a - got[k]).max())
        assert err < 1e-10 * max(float(np.abs(a).max()), 1e-9), k


def test_run_calls_back_after_every_gcm_step():
    drv, state = torch_setup(**{**KW, "nens": 1, "dt_gcm": 40.0},
                             dtype=torch.float64, device="cpu")
    seen = []
    out = drv.run(state, 80.0, callback=lambda s, t: seen.append(t))
    assert seen == [40.0, 80.0]
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    with pytest.raises(ValueError, match="nens"):
        drv.crm_phys_step(state_from_numpy(
            {k: np.concatenate([v.numpy()] * 2) for k, v in state.items()},
            "cpu", torch.float64))

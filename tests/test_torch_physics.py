"""Column physics of the port against pam_tpu at the golden size (f64):
Kessler microphysics, the sponge layer, and both GCM-forcing functions
(with hole filling), on the golden initial state with seeded moisture
and forcing added. Tolerance 1e-12 relative to each field's largest
|value|: the same arithmetic, with other exp/pow rounding.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
from pam_tpu.modules import gcm_forcing as jgf, sponge as jsp
from pam_tpu.physics import kessler as jkess
from pam_tpu_torch.convert import state_from_numpy
from pam_tpu_torch.driver.mmf import setup_supercell_mmf as torch_setup
from pam_tpu_torch.modules import gcm_forcing as tgf, sponge as tsp
from pam_tpu_torch.physics import kessler as tkess

torch.set_num_threads(1)

KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
          dt_crm_phys=20.0, dycore="spam")
FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor",
          "cloud_liquid", "precip_liquid")


@pytest.fixture(scope="module")
def setup():
    """(jax driver, torch driver, numpy state with noise, cloud, rain and
    a drying forcing that drives some vapor negative)."""
    jdrv, _ = jax_setup(**KW, dtype=jnp.float64)
    tdrv, _ = torch_setup(**KW, dtype=torch.float64, device="cpu")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "kessler_spam_si_init.npz")
    s = dict(np.load(path))
    rng = np.random.default_rng(11)
    s["density_dry"] = s["density_dry"] * (1 + 1e-3 * rng.standard_normal(
        s["density_dry"].shape))
    s["temp"] = s["temp"] + 0.5 * rng.standard_normal(s["temp"].shape)
    s["uvel"] = s["uvel"] + rng.standard_normal(s["uvel"].shape)
    rho = s["density_dry"]
    s["water_vapor"] = s["water_vapor"] * (1 + 0.3 * rng.random(rho.shape))
    s["cloud_liquid"] = np.where(rng.random(rho.shape) < 0.5,
                                 2e-3 * rng.random(rho.shape) * rho, 0.0)
    s["precip_liquid"] = np.where(rng.random(rho.shape) < 0.5,
                                  5e-3 * rng.random(rho.shape) * rho, 0.0)
    s["wvel"] = rng.standard_normal(rho.shape)
    s["gcm_forcing_tend_qv"] = -1e-5 * rng.random(s["gcm_forcing_tend_qv"]
                                                  .shape)
    s["gcm_forcing_tend_ql"] = 1e-6 * rng.standard_normal(
        s["gcm_forcing_tend_ql"].shape)
    return jdrv, tdrv, s


def _compare(ref, got, keys):
    for k in keys:
        a = np.asarray(ref[k])
        b = got[k].numpy()
        assert a.shape == b.shape, k
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(a - b).max()) / scale < 1e-12, k


def _both(setup):
    jdrv, tdrv, s = setup
    return (jdrv, {k: jnp.asarray(v) for k, v in s.items()}, tdrv,
            state_from_numpy(s, "cpu", torch.float64))


@pytest.mark.parametrize("ens_chunk", [None, 1])
def test_kessler_timestep_matches_jax(setup, ens_chunk):
    jdrv, js, tdrv, ts = _both(setup)
    ref = jkess.KesslerMicro(jdrv.coupler, ens_chunk=ens_chunk).timestep(
        js, 20.0)
    got = tkess.KesslerMicro(tdrv.coupler, ens_chunk=ens_chunk).timestep(
        ts, 20.0)
    _compare(ref, got, ("temp", "water_vapor", "cloud_liquid",
                        "precip_liquid", "precl"))
    assert float(got["precl"].max()) > 0.0   # rain reached the ground


def test_kessler_rejects_nonpositive_dt(setup):
    _, _, tdrv, ts = _both(setup)
    with pytest.raises(ValueError, match="nonpositive"):
        tkess.KesslerMicro(tdrv.coupler).timestep(ts, 0.0)


def test_coupler_pressure_matches_jax(setup):
    jdrv, js, tdrv, ts = _both(setup)
    ref = np.asarray(jdrv.coupler.pressure(js))
    got = tdrv.coupler.pressure(ts).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)


def test_sponge_layer_matches_jax(setup):
    jdrv, js, tdrv, ts = _both(setup)
    ref = jsp.sponge_layer(jdrv.coupler, js, 20.0)
    got = tsp.sponge_layer(tdrv.coupler, ts, 20.0)
    _compare(ref, got, FIELDS)


def test_compute_gcm_forcing_matches_jax(setup):
    jdrv, js, tdrv, ts = _both(setup)
    ref = jgf.compute_gcm_forcing_tendencies(jdrv.coupler, js, 200.0)
    got = tgf.compute_gcm_forcing_tendencies(tdrv.coupler, ts, 200.0)
    keys = [k for k in ref if k.startswith("gcm_forcing_tend")]
    assert sorted(keys) == sorted(k for k in got
                                  if k.startswith("gcm_forcing_tend"))
    _compare(ref, got, keys)


def test_apply_gcm_forcing_matches_jax(setup):
    jdrv, js, tdrv, ts = _both(setup)
    ref = jgf.apply_gcm_forcing_tendencies(jdrv.coupler, js, 20.0, 200.0)
    got = tgf.apply_gcm_forcing_tendencies(tdrv.coupler, ts, 20.0, 200.0)
    _compare(ref, got, FIELDS + ("gcm_forcing_tend_rho_v",
                                 "gcm_forcing_tend_rho_l",
                                 "gcm_forcing_tend_rho_i"))
    assert float(got["water_vapor"].min()) >= 0.0


def test_fill_holes_matches_jax():
    """Negative cells clamped, their mass taken from the positive cells
    of the level, then of the column where a level runs short."""
    rng = np.random.default_rng(5)
    rho = rng.standard_normal((2, 6, 1, 9))
    rho[:, 2] = -np.abs(rho[:, 2])       # a level with no positive mass
    dz = 100.0 + 50.0 * rng.random((2, 6))
    ref = np.asarray(jgf.fill_holes(jnp.asarray(rho), jnp.asarray(dz)))
    got = tgf.fill_holes(torch.from_numpy(rho), torch.from_numpy(dz))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert float(got.min()) >= 0.0

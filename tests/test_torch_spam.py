"""SPAM+SI dycore of the port against pam_tpu on a carried-across state.

Both drivers are built at the golden size (16x1x12, nens=2, f64) by
their own setup_supercell_mmf; the dynamics state (dens, v, w) comes from
pam_tpu's initial state with seeded noise added, and goes through both
sides as the same numpy arrays. Tolerances, relative to the largest
|value| of each output: 1e-12 for single operators, 1e-10 for one whole
si_step (three linear solves and two quasi-Newton evaluations compound
the rounding of the different exp/pow and FFT paths).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
from pam_tpu.spam import operators as jop
from pam_tpu.spam import si as jsi
from pam_tpu_torch.driver.mmf import setup_supercell_mmf as torch_setup
from pam_tpu_torch.spam import operators as top
from pam_tpu_torch.spam import si as tsi

torch.set_num_threads(1)

KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
          dt_crm_phys=20.0, dycore="spam")


@pytest.fixture(scope="module")
def pair():
    jdrv, jstate = jax_setup(**KW, dtype=jnp.float64)
    tdrv, _ = torch_setup(**KW, dtype=torch.float64, device="cpu")
    dens, v, w = (np.asarray(a) for a in
                  jdrv.dycore.coupler_to_dynamics(jstate))
    rng = np.random.default_rng(7)
    g = jdrv.dycore.geom
    dens = dens.copy()
    dens[:2] *= 1.0 + 1e-3 * rng.standard_normal(dens[:2].shape)
    dens[2:] *= 1.0 + 0.2 * rng.random(dens[2:].shape)
    # cloud and rain where the column is moist, zero elsewhere
    mask = rng.random(dens[3:].shape) < 0.5
    dens[3:] = np.where(mask, 1e-3 * rng.random(dens[3:].shape) * dens[0],
                        0.0)
    v = v + 3.0 * g.dx * rng.standard_normal(v.shape)
    w = w + 1.0 * np.asarray(g.dz_p)[:, :, None] * \
        rng.standard_normal(w.shape)
    return jdrv.dycore, tdrv.dycore, (dens, v, w)


def _close(ref, got, tol, name=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max()) / scale
    assert err < tol, (name, err)


def _args(x):
    return ([jnp.asarray(a) for a in x], [torch.from_numpy(a) for a in x])


def test_linear_system_coefficients_equal_jax(pair):
    """build_coupled reads only the ref_* columns; the port's setup gives
    the same columns, so the numpy-built coefficients are the same."""
    jd, td, _ = pair
    jl, tl = jd.si_linsys, td.si_linsys
    for name in ("Blin", "vcoeff0", "tri_l", "tri_d", "tri_u", "a_kp1",
                 "a_k", "g_up", "g_dn", "q_pi", "q_di", "rho_pi", "rho_di"):
        ref = np.asarray(getattr(jl, name))
        got = getattr(tl, name).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(td.geop.numpy(), np.asarray(jd.geop))
    for name in ("refdens", "ref_q_pi", "ref_rho_pi", "ref_q_di",
                 "ref_rho_di", "ref_B"):
        np.testing.assert_array_equal(getattr(td.tend, name).numpy(),
                                      np.asarray(getattr(jd.tend, name)),
                                      err_msg=name)


OPS = ("functional_derivatives", "q_and_f", "recons", "fct", "compute_rhs",
       "linsys.solve")


def _run_all(side, dyc, x):
    """Every operator of the pipeline on (dens, v, w) = x, by name."""
    o = jop if side == "jax" else top
    tend = dyc.tend
    dens, v, w = x
    geop = dyc.geop
    dt = 20.0
    out = {}
    F, FW, K, B = out["functional_derivatives"] = \
        tend.functional_derivatives(dens, v, w, geop)
    qhz = tend.q_and_f(dens, v, w)
    out["q_and_f"] = (qhz,)
    rec = out["recons"] = tend.recons(dens, qhz, F, FW, o.Wxz_u(FW),
                                      o.Wxz_w(F))
    out["fct"] = tend.fct(dens, rec[0], rec[1], F, FW, dt)
    out["compute_rhs"] = tend.compute_rhs(dens, v, w, geop, dt)
    out["linsys.solve"] = dyc.si_linsys.solve(dens * 1e-3, v * 1e-2,
                                              w * 1e-2)
    return out


@pytest.fixture(scope="module")
def outputs(pair):
    jd, td, x = pair
    jx, tx = _args(x)
    return _run_all("jax", jd, jx), _run_all("torch", td, tx)


@pytest.mark.parametrize("op", OPS)
def test_operator_matches_jax(outputs, op):
    ref, got = outputs[0][op], outputs[1][op]
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        _close(r, g, 1e-12, f"{op}[{i}]")


def test_si_step_matches_jax(pair):
    jd, td, x = pair
    jx, tx = _args(x)
    before = [a.clone() for a in tx]
    ref = jsi.si_step(jd.tend, jd.si_linsys, *jx, jd.geop, 20.0)
    got = tsi.si_step(td.tend, td.si_linsys, *tx, td.geop, 20.0)
    for i, (r, g) in enumerate(zip(ref, got)):
        _close(r, g, 1e-10, f"si_step[{i}]")
    # the inputs are not written into
    for a, b in zip(tx, before):
        assert torch.equal(a, b)


def test_timestep_with_two_substeps_matches_jax():
    """Two SI substeps per CRM step (crm_per_phys=2) with the clip of the
    positive densities after each, coupler state in and out."""
    kw = {**KW, "crm_per_phys": 2}
    jdrv, jstate = jax_setup(**kw, dtype=jnp.float64)
    tdrv, _ = torch_setup(**kw, dtype=torch.float64, device="cpu")
    init = {k: np.asarray(v) for k, v in jstate.items()}
    rng = np.random.default_rng(3)
    init["wvel"] = rng.standard_normal(init["wvel"].shape)
    init["cloud_liquid"] = 1e-5 * rng.random(init["cloud_liquid"].shape)
    assert tdrv.dycore.si_dt == 10.0
    ref = jdrv.dycore.timestep({k: jnp.asarray(v) for k, v in init.items()},
                               20.0)
    got = tdrv.dycore.timestep({k: torch.tensor(v)
                                for k, v in init.items()}, 20.0)
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor",
              "cloud_liquid", "precip_liquid"):
        _close(ref[k], got[k], 1e-10, k)

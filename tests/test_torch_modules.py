"""The port's small coupler modules against pam_tpu on the same seeded
inputs (the column-physics tests of tests/test_modules.py, mirrored):
forced radiation, saturation adjustment, the dry-density broadcast,
surface friction, vertical interpolation, the idealized profiles, the
banded solve, the coupler's option and allocation helpers, and Kessler's
rainsplit in float32.
"""

import math
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pam_tpu.core import Coupler as JCoupler
from pam_tpu.core import profiles as jprof
from pam_tpu.core import vinterp as jvinterp
from pam_tpu.core.constants import DEFAULT_CONSTANTS as JCONST
from pam_tpu.modules import broadcast as jbroadcast
from pam_tpu.modules import saturation as jsat
from pam_tpu.modules import surface_friction as jsf
from pam_tpu.ops import banded as jbanded
from pam_tpu.physics import kessler as jkessler
from pam_tpu.physics import radiation as jrad
from pam_tpu_torch.core import profiles as tprof
from pam_tpu_torch.core import vinterp as tvinterp
from pam_tpu_torch.core.constants import DEFAULT_CONSTANTS as TCONST
from pam_tpu_torch.core.coupler import Coupler as TCoupler
from pam_tpu_torch.modules import broadcast as tbroadcast
from pam_tpu_torch.modules import saturation as tsat
from pam_tpu_torch.modules import surface_friction as tsf
from pam_tpu_torch.ops import banded as tbanded
from pam_tpu_torch.physics import kessler as tkessler
from pam_tpu_torch.physics import radiation as trad

torch.set_num_threads(1)
CPU = torch.device("cpu")


def couplers(nx=8, ny=1, nz=12, nens=2, micro=True):
    j = JCoupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=8000.0, ylen=8000.0,
                 dtype=jnp.float64)
    t = TCoupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=8000.0, ylen=8000.0,
                 dtype=torch.float64, device=CPU)
    if micro:
        j, t = jkessler.register(j), tkessler.register(t)
    return j, t


def states(cpl_pair, seed):
    """The same seeded state for both packages (tests/test_modules.py's
    base_state): (numpy, jax, torch) dicts."""
    jc, tc = cpl_pair
    rng = np.random.default_rng(seed)
    zint = np.linspace(0.0, 12000.0, jc.nz + 1)
    base = {k: np.asarray(v) for k, v in jc.allocate_state(zint).items()}
    shape = (jc.nens, jc.nz, jc.ny, jc.nx)
    base["density_dry"] = 1.0 + 0.1 * rng.random(shape)
    base["temp"] = 280.0 + 10.0 * rng.random(shape)
    for k in ("uvel", "vvel", "wvel"):
        base[k] = rng.standard_normal(shape)
    base["water_vapor"] = 0.005 * rng.random(shape)
    for k in base:
        if k.startswith("gcm_"):
            base[k] = rng.random(base[k].shape)
    return (base, {k: jnp.asarray(v) for k, v in base.items()},
            {k: torch.tensor(v) for k, v in base.items()})


def close(ref, got, tol=1e-13, name=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(ref - got).max()) <= tol * scale, name


def test_coupler_options_and_allocation_helpers():
    jc, tc = couplers()
    tc = tc.with_options(rad_nx=4)
    assert tc.get_option("rad_nx") == 4 and tc.get_option("x", 7) == 7
    assert tc.get_option("micro") == jc.get_option("micro") == "kessler"
    for name, args in (("zeros3d", ()), ("zeros_col", ()),
                       ("zeros_col", (True,))):
        j, t = getattr(jc, name)(*args), getattr(tc, name)(*args)
        assert tuple(t.shape) == j.shape and t.dtype == torch.float64
        assert not bool(t.any())


def test_forced_radiation_matches_jax():
    """Forced radiation heats each CRM column by the coarse-cell tendency
    (physics/radiation/forced/radiation.h:40-44)."""
    jc, tc = couplers(nx=8, micro=False)
    jc, tc = (m.register(c, rad_nx=2, rad_ny=1)
              for m, c in ((jrad, jc), (trad, tc)))
    _, js, ts = states((jc, tc), 7)
    js, ts = jrad.init_state(jc, js), trad.init_state(tc, ts)
    close(js["rad_enthalpy_tend"], ts["rad_enthalpy_tend"])
    tend = np.random.default_rng(8).random((2, 12, 1, 2)) * 100.0
    js["rad_enthalpy_tend"] = jnp.asarray(tend)
    ts["rad_enthalpy_tend"] = torch.tensor(tend)
    assert trad.ForcedRadiation(tc).name == "forced"
    ref = jrad.ForcedRadiation(jc).timestep(js, 10.0)
    got = trad.ForcedRadiation(tc).timestep(ts, 10.0)
    close(ref["temp"], got["temp"], 1e-15, "temp")
    dT = (got["temp"] - ts["temp"]).numpy()
    np.testing.assert_allclose(dT[..., :4], (tend[..., :1] / tc.const.cp_d
                                             * 10.0).repeat(4, -1))


def test_radiation_slot_of_the_driver():
    """MmfDriver's rad slot runs after the microphysics; with the sponge
    and the forcing switched off the step is dycore, micro, rad."""
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    drv, state = setup_supercell_mmf(
        nx=8, ny=1, nz=8, nens=1, xlen=16000.0, ylen=64000.0, zlen=16000.0,
        dt_gcm=40.0, dycore="spam", device="cpu")
    cpl = trad.register(drv.coupler)
    state = trad.init_state(cpl, state)
    state["rad_enthalpy_tend"] = torch.full_like(
        state["rad_enthalpy_tend"], 500.0)
    order = []

    class Spy:
        def __init__(self, name, inner):
            self.name, self.inner = name, inner

        def timestep(self, s, dt):
            order.append(self.name)
            return self.inner.timestep(s, dt)
    drv.micro = Spy("micro", drv.micro)
    drv.rad = Spy("rad", trad.ForcedRadiation(cpl))
    drv.apply_sponge = drv.apply_gcm_forcing = False
    out = drv.run(state, 40.0)
    assert order == ["micro", "rad"] * 2
    assert "gcm_forcing_tend_temp" not in out
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_saturation_adjustment_matches_jax():
    jc, tc = couplers()
    base, js, ts = states((jc, tc), 2)
    rng = np.random.default_rng(3)
    # supersaturated low levels, cloud to evaporate above
    qv = base["water_vapor"].copy()
    qv[:, :4] = 0.03
    cl = np.where(rng.random(qv.shape) < 0.5, 1e-3 * rng.random(qv.shape),
                  0.0)
    for k, v in (("water_vapor", qv), ("cloud_liquid", cl)):
        js[k], ts[k] = jnp.asarray(v), torch.tensor(v)
    ref = jsat.saturation_adjustment(jc, js)
    got = tsat.saturation_adjustment(tc, ts)
    for k in ("water_vapor", "cloud_liquid", "temp"):
        close(ref[k], got[k], 1e-12, k)
    assert float(got["cloud_liquid"][:, :4].min()) > 0.0
    # svp has one definition, shared with the idealized profiles
    assert tsat.saturation_vapor_pressure is tprof.saturation_vapor_pressure


def test_broadcast_dry_density_matches_jax():
    jc, tc = couplers()
    _, js, ts = states((jc, tc), 4)
    ref = jbroadcast.broadcast_initial_gcm_column_dry_density(jc, js)
    got = tbroadcast.broadcast_initial_gcm_column_dry_density(tc, ts)
    np.testing.assert_array_equal(got["density_dry"].numpy(),
                                  np.asarray(ref["density_dry"]))
    np.testing.assert_array_equal(got["temp"].numpy(),
                                  np.asarray(ref["temp"]))


@pytest.mark.parametrize("bflx", [0.0, 0.05, -0.05])
def test_surface_friction_matches_jax(bflx):
    jc, tc = couplers()
    _, js, ts = states((jc, tc), 4)
    for s in (js, ts):
        s["gcm_uvel"] = s["gcm_uvel"] * 0 + 10.0
    tau, b = np.array([0.1, 0.3]), np.full(2, bflx)
    js = jsf.surface_friction_init(jc, js, tau_in=tau, bflx_in=b)
    ts = tsf.surface_friction_init(tc, ts, tau_in=tau, bflx_in=b)
    for k in ("z0", "sfc_bflx", "sfc_mom_flx_u"):
        close(js[k], ts[k], 1e-13, k)
    ref = jsf.compute_surface_friction(jc, js)
    got = tsf.compute_surface_friction(tc, ts)
    for k in ("sfc_mom_flx_u", "sfc_mom_flx_v"):
        close(ref[k], got[k], 1e-12, k)
    # the fluxes oppose the deviation from the horizontal-mean wind
    du = ts["uvel"][:, 0] - ts["uvel"][:, 0].mean(dim=(-2, -1), keepdim=True)
    assert float((got["sfc_mom_flx_u"] * du).sum()) < 0


@pytest.mark.parametrize("bc", [(0, 0), (1, 1), (0, 1)])
def test_vertical_interp_matches_jax(bc):
    """WENO cells -> edges on a stretched column, with trailing spatial
    axes and a shared 1-D zint broadcast over the members."""
    rng = np.random.default_rng(0)
    nz = 24
    zint = np.concatenate([[0.0], np.cumsum(50.0 + 40.0 * rng.random(nz))])
    data = rng.random((3, nz, 2, 5)) + np.sin(
        0.5 * (zint[:-1] + zint[1:]) / 200.0)[None, :, None, None]
    ref = jvinterp.cells_to_edges(jnp.asarray(data), zint, *bc)
    got = tvinterp.cells_to_edges(torch.tensor(data), zint, *bc)
    close(ref, got, 1e-12)
    # exact for quadratics away from the ghost cells
    dz = np.diff(zint)
    f_avg = (zint[1:] ** 3 - zint[:-1] ** 3) / (3 * dz)
    edges = tvinterp.cells_to_edges(torch.tensor(f_avg)[None], zint).numpy()
    assert np.abs(edges[0, 3:-3] / zint[3:-3] ** 2 - 1).max() < 1e-10


def test_profiles_match_jax():
    z = np.linspace(0.0, 20000.0, 41)
    zj, zt = jnp.asarray(z), torch.tensor(z)
    c = (300.0, zj, 287.0, 1004.0, 1.4, 1e5, 27.5, 9.81)
    close(jprof.const_theta_density(*c),
          tprof.const_theta_density(c[0], zt, *c[2:]))
    close(jprof.const_theta_pressure(*c),
          tprof.const_theta_pressure(c[0], zt, *c[2:]))
    close(jprof.const_bvf_density(300.0, 0.01, zj, 287.0, 1004.0, 1.4, 27.5,
                                  1e5, 9.81),
          tprof.const_bvf_density(300.0, 0.01, zt, 287.0, 1004.0, 1.4, 27.5,
                                  1e5, 9.81))
    sc = (0.0, 12000.0, 20000.0, 300.0, 213.0, 213.0)
    close(jprof.supercell_temperature(zj, *sc),
          tprof.supercell_temperature(zt, *sc))
    close(jprof.supercell_pressure_dry(zj, *sc, 1e5, 287.0, 9.81),
          tprof.supercell_pressure_dry(zt, *sc, 1e5, 287.0, 9.81))
    close(jprof.supercell_relhum(zj, 0.0, 12000.0),
          tprof.supercell_relhum(zt, 0.0, 12000.0))
    t = 200.0 + z / 100.0
    close(jprof.supercell_sat_mix_dry(9e4, jnp.asarray(t)),
          tprof.supercell_sat_mix_dry(9e4, torch.tensor(t)))
    x = np.linspace(0.0, 10000.0, 41)
    args = (5000.0, 0.0, 2000.0, 3000.0, 1.0, 1500.0, 2.0)
    close(jprof.ellipsoid_cosine(jnp.asarray(x), 0.0, zj, *args),
          tprof.ellipsoid_cosine(torch.tensor(x), 0.0, zt, *args))
    for a, b in zip(jprof.hydro_const_theta(zj, 9.81, 27.5, 1004.0, 1e5,
                                            1.4, 287.0),
                    tprof.hydro_const_theta(zt, 9.81, 27.5, 1004.0, 1e5,
                                            1.4, 287.0)):
        close(a, b)


@pytest.mark.parametrize("nbands", [3, 5])
def test_solve_banded_matches_jax(nbands):
    rng = np.random.default_rng(nbands)
    n = 10
    diags = rng.standard_normal((nbands, n, 2, 3))
    diags[nbands // 2] += 10.0          # diagonally dominant
    rhs = rng.standard_normal((n, 2, 3))
    ref = jbanded.solve_banded(jnp.asarray(diags), jnp.asarray(rhs))
    got = tbanded.solve_banded(torch.tensor(diags), torch.tensor(rhs))
    close(ref, got, 1e-12)
    np.testing.assert_array_equal(
        tbanded.banded_to_dense(torch.tensor(diags)).numpy(),
        np.asarray(jbanded.banded_to_dense(jnp.asarray(diags))))
    with pytest.raises(ValueError, match="odd"):
        tbanded.banded_to_dense(torch.tensor(diags[:2]))


def _rain_column(seed):
    """A seeded float32 Kessler column set (nz, cols): rain at half of
    the points, cloud, vapour, theta and exner."""
    f = np.float32
    rng = np.random.default_rng(seed)
    nz, ncol = 8, 16
    z = ((np.arange(nz) + 0.5) * 500.0).astype(f)[:, None]
    rho = (1.1 * np.exp(-z / 8000.0) *
           (1.0 + 0.01 * rng.random((nz, ncol)))).astype(f)
    qr = np.where(rng.random((nz, ncol)) < 0.5,
                  3e-3 * rng.random((nz, ncol)), 0.0).astype(f)
    qc = (1e-4 * rng.random((nz, ncol))).astype(f)
    theta = (300.0 + z / 250.0 + rng.random((nz, ncol))).astype(f)
    exner = np.broadcast_to(1.0 - z / 30000.0, (nz, ncol)).astype(f)
    qv = (0.01 * np.exp(-z / 3000.0) *
          (0.5 + rng.random((nz, ncol)))).astype(f)
    return theta, qv, qc, qr, rho, z, exner


def test_kessler_rainsplit_in_float32_matches_jax():
    """pam_tpu takes ceil(dt / dt_max) in the state's dtype. With a dt
    whose dt / dt_max rounds to an integer N in float32 but lies above N
    in exact arithmetic (and in double), both packages take N sub-cycles
    and agree to 1e-5 of each field's largest value."""
    cols = _rain_column(5)
    theta, qv, qc, qr, rho, z, exner = cols
    f = np.float32
    # dt_max as pam_tpu computes it, over the rain points (elsewhere it is
    # dt itself): the CFL bound 0.8 dz / v of the lowest limiting level
    r = 0.001 * jnp.asarray(rho)
    vel = jkessler._terminal_velocity(jnp.asarray(qr), r, jnp.sqrt(
        jnp.asarray(rho)[:1] / jnp.asarray(rho)))
    dz = jnp.asarray(z)[1:] - jnp.asarray(z)[:-1]
    m = f(jnp.min(jnp.where(vel[:-1] > 1e-10, 0.8 * dz / vel[:-1],
                            jnp.inf)))
    # the port's terminal velocity gives the same bound here
    tr = torch.from_numpy(rho)
    tvel = tkessler._terminal_velocity(torch.from_numpy(qr), 0.001 * tr,
                                       torch.sqrt(tr[:1] / tr))
    tdz = torch.from_numpy(z)[1:] - torch.from_numpy(z)[:-1]
    assert f(torch.where(tvel[:-1] > 1e-10, 0.8 * tdz / tvel[:-1],
                         torch.inf).min()) == m
    # the f32 dt next to N * dt_max where float32 and exact division part
    found = None
    for n in range(2, 60):
        cand = f(n * float(m))
        for step in range(-6, 7):
            dt = cand
            for _ in range(abs(step)):
                dt = np.nextafter(dt, f(np.sign(step) * np.inf), dtype=f)
            if f(dt) / m == f(n) and \
                    Fraction(float(dt)) / Fraction(float(m)) > n:
                found = (n, float(dt))
                break
        if found:
            break
    n, dt = found
    assert math.ceil(dt / float(m)) == n + 1    # what double would take
    ref = jkessler.kessler_column(*(jnp.asarray(a) for a in cols), dt,
                                  JCONST)
    got = tkessler.kessler_column(*(torch.from_numpy(a) for a in cols), dt,
                                  TCONST)
    assert tkessler.kessler_column.rainsplit == n
    for name, a, b in zip(("theta", "qv", "qc", "qr", "precl"), ref, got):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and a.shape == tuple(b.shape)
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b.numpy()).max()) <= 1e-5 * scale, name

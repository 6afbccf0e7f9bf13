"""The 3-D SPAM modules of the port against pam_tpu and against the numpy
oracle tests/spam3d_oracle.py, f64, on the same seeded numpy inputs:
the pressure SI linear systems (slab and 3-D), ExtrudedGeometry.build3d,
spam/extruded3d.py::Tendencies3D function by function, the 3-D test
cases, diagnostics and coupler conversions; the port's 3-D model against
its own slab on y-invariant and x-invariant states; and, on the card, B1
along y and one 3-D SSPRK3 step against the CPU.

Tolerance: 1e-12 of each output's largest |value| against pam_tpu;
1e-10 of max(1, |value|) against the oracle (its tolerance in
tests/test_spam3d_oracle.py); 1e-13 between the degenerate 3-D model and
the slab. JAX is imported inside the fixtures and tests that use it, so
that the card-side cases run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_spam3d.py
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from pam_tpu_torch.ops import dft, tridiag, weno, weno_x
from pam_tpu_torch.spam import diagnostics as tdiag
from pam_tpu_torch.spam import extruded3d, si as tsi, testcases as ttcs
from pam_tpu_torch.spam import thermo as tthermo
from pam_tpu_torch.spam.extruded3d import Tendencies3D
from pam_tpu_torch.spam.geometry import ExtrudedGeometry as TGeom
from pam_tpu_torch.spam.tendencies import SpamTendencies
from pam_tpu_torch.spam.varset import VariableSet as TVarSet

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import spam3d_oracle as orc3  # noqa: E402
from torch_spam3d_case import oracle_case_3d  # noqa: E402

TOL = 1e-12
ORACLE_TOL = 1e-10
DEGENERATE_TOL = 1e-13
NX, NY, NZ, NENS = 8, 6, 8, 2


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol=TOL, name=""):
    """Every array of ``ref`` (array, tuple, list or dict) within tol of
    its largest |value| in ``got``."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), name
        for k in ref:
            _close(ref[k], got[k], tol, f"{name}.{k}")
        return
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), name
        for i, (r, g) in enumerate(zip(ref, got)):
            _close(r, g, tol, f"{name}[{i}]")
        return
    r, g = np.asarray(_np(ref), np.float64), np.asarray(_np(got), np.float64)
    assert r.shape == g.shape, (name, r.shape, g.shape)
    err = float(np.abs(r - g).max()) / max(float(np.abs(r).max()), 1e-300)
    assert err <= tol, (name, err)


def _jax():
    """pam_tpu's modules, imported on first use."""
    import jax.numpy as jnp
    import pam_tpu.spam as jspam
    import pam_tpu.spam.diagnostics as jdiag
    import pam_tpu.spam.extruded3d as jext
    import pam_tpu.spam.si as jsi
    import pam_tpu.spam.testcases as jtcs
    import pam_tpu.spam.thermo as jthermo
    return types.SimpleNamespace(
        jnp=jnp, Geom=jspam.ExtrudedGeometry, VarSet=jspam.VariableSet,
        Tend=jext.Tendencies3D, Slab=jspam.SpamTendencies, si=jsi,
        tcs=jtcs, thermo=jthermo, diag=jdiag, T=jnp.asarray,
        dtype=jnp.float64, dev=())


TORCH = types.SimpleNamespace(
    Geom=TGeom, VarSet=TVarSet, Tend=Tendencies3D, Slab=SpamTendencies,
    si=tsi, tcs=ttcs, thermo=tthermo, diag=tdiag,
    T=lambda a: torch.as_tensor(np.asarray(a)), dtype=torch.float64,
    dev=("cpu",))


def _build3d(M, nx, ny, zint, xlen, ylen, nens=NENS):
    return M.Geom.build3d(nx, ny, zint, xlen, ylen, nens, M.dtype, *M.dev)


# ------------------------------------------------------ Tendencies3D cases
# (test case, variant, thermo, stretched z, SI reference state, knobs)
CASES = {
    "dry_ref": ("risingbubble", "CE", "idealgaspottemp", False, True, ()),
    "dry_stretched": ("risingbubble", "CE", "idealgaspottemp", True, False,
                      ()),
    "moist_tanh_cfv": ("moistrisingbubble", "MCE_rho",
                       "constkappavirpottemp", False, False,
                       (("dual_upwind_type", "tanh"),
                        ("tanh_upwind_coeff", 50.0),
                        ("reconstruction_type", "cfv"))),
}


def _side(M, case):
    """Tendencies3D of ``case`` on package M's side with its initial
    state (numpy)."""
    name, variant, thermo, stretched, si, knobs = CASES[case]
    tc, _ = M.tcs.testcase_from_string(name)
    zint = np.linspace(0.0, tc.Lz, NZ + 1)
    if stretched:
        zint = tc.Lz * (np.linspace(0.0, 1.0, NZ + 1) ** 1.4)
    geom = _build3d(M, NX, NY, zint, tc.Lx, 0.8 * tc.Lx)
    th = M.thermo.thermo_from_string(thermo)
    if variant == "CE":
        vs = M.VarSet(variant="CE", tracer_names=("puff",),
                      tracer_positive=(True,), geom=geom, thermo=th)
    else:
        vs = M.VarSet(variant="MCE_rho", tracer_names=("water_vapor",),
                      tracer_positive=(True,), geom=geom, thermo=th)
    dens, v, w, geop = (np.asarray(_np(a)) for a in
                        M.tcs.setup_testcase_3d(tc, geom, th))
    if dens.shape[0] < vs.ndensity:          # the dry cases' tracer
        dens = np.concatenate([dens, np.zeros_like(dens[:1])])
    tend = M.Tend(geom=geom, varset=vs, thermo=th, grav=tc.g, **dict(knobs))
    if si:
        ref = M.si.build_reference_state(
            geom, th, vs, lambda z: tc.refrho_f(z, th),
            lambda z: tc.refentropicdensity_f(z, th),
            lambda z: np.asarray(tc.refnsq_f(z, th)), tc.g)
        tend = dataclasses.replace(
            tend, force_refstate_hydrostatic_balance=True,
            refdens=M.T(ref["dens"]), ref_rho_pi=M.T(ref["rho_pi"]),
            ref_q_pi=M.T(ref["q_pi"]), ref_rho_di=M.T(ref["rho_di"]),
            ref_q_di=M.T(ref["q_di"]), ref_B=M.T(ref["B"]))
    return tend, (dens, v, w, geop)


def _state(x0, geom, seed):
    """The initial state made y-varying and moving, with a sharp positive
    tracer where the case has none, so that every y term and the FCT
    limiter act: numpy (dens, v, w, geop)."""
    rng = np.random.default_rng(seed)
    dens, v, w, geop = (np.array(a) for a in x0)
    ny = dens.shape[-2]
    ymod = (1.0 + 0.02 * np.sin(2 * np.pi * np.arange(ny) / ny)
            )[None, None, :, None]
    dens[:2] *= ymod * (1.0 + 3e-3 * rng.standard_normal(dens[:2].shape))
    if not dens[2].any():
        dens[2] = 1e-3 * dens[0] * (rng.random(dens[0].shape) < 0.3)
    else:
        dens[2] *= 1.0 + 0.2 * rng.random(dens[2].shape)
    v = v + np.stack([3.0 * geom.dx, 2.0 * geom.dy])[
        :, None, None, None, None] * rng.standard_normal(v.shape)
    w = w + 1.5 * np.asarray(geom.dz_p)[:, :, None, None] * \
        rng.standard_normal(w.shape)
    return dens, v, w, geop


@pytest.fixture(scope="module")
def pairs():
    """{case: (jax tend, torch tend, numpy (dens, v, w, geop))}."""
    cache = {}

    def get(case):
        if case not in cache:
            J = _jax()
            jt, x0 = _side(J, case)
            tt, tx0 = _side(TORCH, case)
            _close(x0, tx0, TOL, f"{case} initial state")
            cache[case] = (jt, tt, _state(x0, tt.geom,
                                          list(CASES).index(case) + 5))
        return cache[case]
    return get


def _both(x):
    import jax.numpy as jnp
    return ([jnp.asarray(a) for a in x],
            [torch.from_numpy(np.array(a)) for a in x])


def _fluxes(tend, x):
    F, FW, _, _ = tend.functional_derivatives(*x)
    return F, FW


FUNCTIONS = {
    "functional_derivatives": lambda t, x: t.functional_derivatives(*x),
    "q_and_f": lambda t, x: t.q_and_f(*x[:3]),
    "tangent_fluxes": lambda t, x: t.tangent_fluxes(*_fluxes(t, x)),
    "recons": lambda t, x: t.recons(
        x[0], *t.q_and_f(*x[:3]), *_fluxes(t, x),
        *t.tangent_fluxes(*_fluxes(t, x))),
    "compute_rhs": lambda t, x: t.compute_rhs(*x, 0.5),
    "ssprk3_step": lambda t, x: t.ssprk3_step(*x, 0.05),
    "statistics": lambda t, x: t.statistics(*x),
}


@pytest.mark.parametrize("fn", list(FUNCTIONS))
@pytest.mark.parametrize("case", list(CASES))
def test_tendencies3d_matches_jax(pairs, case, fn):
    jt, tt, x = pairs(case)
    jx, tx = _both(x)
    _close(FUNCTIONS[fn](jt, jx), FUNCTIONS[fn](tt, tx), TOL, f"{case} {fn}")


def test_fct_fires_and_matches_jax(pairs):
    """The limiter changes the tracer's reconstructions in the dry cases'
    states (so the comparison above certifies the limited path), and the
    limited stacks equal pam_tpu's."""
    jt, tt, x = pairs("dry_ref")
    out = []
    for t, xx in zip((jt, tt), _both(x)):
        F, FW = _fluxes(t, xx)
        dr, dvr, *_ = t.recons(xx[0], *t.q_and_f(*xx[:3]), F, FW,
                               *t.tangent_fluxes(F, FW))
        out.append((dr, dvr, t.fct(xx[0], dr, dvr, F, FW, 40.0)))
    _close(out[0][2], out[1][2], TOL, "fct")
    (dr, dvr), (lr, lvr) = (out[1][0], out[1][1]), out[1][2]
    assert not torch.equal(lr[1][2], dr[1][2]) or \
        not torch.equal(lvr[2], dvr[2])
    assert torch.equal(lr[0][0], dr[0][0])       # rho is not limited


# --------------------------------------------------------- numpy oracle
@pytest.fixture(scope="module")
def oracle_case():
    tend, x, kw = oracle_case_3d("cpu")
    return tend, x, [torch.from_numpy(np.array(a)) for a in x], kw


def test_functional_derivatives_match_oracle(oracle_case):
    tend, (dens, v, w, geop), tx, kw = oracle_case
    want = orc3.fd_3d_oracle(dens, v, w, geop, kw["dz_d"], kw["dz_p"],
                             kw["dx"], kw["dy"], kw["cst"])
    for name, g, o in zip(("F", "FW", "K", "B"),
                          tend.functional_derivatives(*tx), want):
        _oracle_close(g, o, name)


def _oracle_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(_np(got) - want).max()) / scale
    assert err < ORACLE_TOL, (name, err)


def test_q_and_tangent_fluxes_match_oracle(oracle_case):
    tend, (dens, v, w, geop), tx, kw = oracle_case
    qhz, qxy = tend.q_and_f(*tx[:3])
    qhzo, qxyo = orc3.q_3d_oracle(dens, v, w)
    _oracle_close(qhz, qhzo, "qhz")
    _oracle_close(qxy, qxyo, "qxy")
    F, FW, _, _ = tend.functional_derivatives(*tx)
    want = orc3.tangent_fluxes_3d_oracle(F.numpy(), FW.numpy())
    for name, g, o in zip(("FT", "FTW", "FTxy"),
                          tend.tangent_fluxes(F, FW), want):
        _oracle_close(torch.stack(g), o, name)


def test_compute_rhs_matches_oracle(oracle_case):
    """One y-varying compute_rhs with the reference state on and the 3-D
    FCT firing on the tracer (checked: unlimited availability changes its
    tendency in the oracle)."""
    tend, (dens, v, w, geop), tx, kw = oracle_case
    dt = 2.0
    want = orc3.compute_rhs_3d_oracle(dens, v, w, geop, dt, **kw)
    for name, g, o in zip(("dens", "v", "w"), tend.compute_rhs(*tx, dt),
                          want):
        _oracle_close(g, o, name)
    unlimited = orc3.compute_rhs_3d_oracle(
        dens, v, w, geop, dt, **kw, fct_avail=np.full_like(dens, 1e30))
    assert np.abs(unlimited[0][2] - want[0][2]).max() > 0.0


# ------------------------------------------- the degenerate 3-D model
def _slab_and_3d(nx, nz, nens=1):
    tc = ttcs.RisingBubble()
    zint = np.linspace(0.0, tc.Lz, nz + 1)
    th = tthermo.IdealGasPottemp()
    g1 = TGeom.build(nx, zint, tc.Lx, nens, torch.float64, "cpu")
    vs1 = TVarSet(variant="CE", geom=g1, thermo=th)
    t1 = SpamTendencies(geom=g1, varset=vs1, thermo=th, grav=tc.g)
    x1 = ttcs.setup_testcase(tc, g1, th)
    rng = np.random.default_rng(3)
    v1 = x1[1] + 0.3 * torch.from_numpy(rng.standard_normal(x1[1].shape))
    w1 = x1[2] + 0.3 * torch.from_numpy(rng.standard_normal(x1[2].shape))
    return tc, th, t1, (x1[0], v1, w1, x1[3])


def test_y_degenerate_matches_slab():
    """A y-invariant state with v[1] = 0 (and dy = 1, the slab's implicit
    dy: the WENO weights are not scale-invariant) reproduces the port's
    slab in every y slice: the ndims=2 signs of zeta_xz and of the Qxz
    operators cancel."""
    tc, th, t1, (d1, v1, w1, geop1) = _slab_and_3d(16, 12)
    ny = 6
    g3 = TGeom.build3d(16, ny, np.linspace(0.0, tc.Lz, 13), tc.Lx,
                       float(ny), 1, torch.float64, "cpu")
    t3 = Tendencies3D(geom=g3, varset=TVarSet(variant="CE", geom=g3,
                                              thermo=th),
                      thermo=th, grav=tc.g)
    tile = lambda a: a[..., None, :].expand(*a.shape[:-1], ny,
                                            a.shape[-1]).contiguous()
    v3 = torch.stack([tile(v1), torch.zeros_like(tile(v1))])
    dt = 0.05
    F1 = t1.compute_rhs(d1, v1, w1, geop1, dt)
    F3 = t3.compute_rhs(tile(d1), v3, tile(w1), tile(geop1), dt)
    for j in range(ny):
        _close(F1[0], F3[0][..., j, :], DEGENERATE_TOL, "dens")
        _close(F1[1], F3[1][0][..., j, :], DEGENERATE_TOL, "v")
        _close(F1[2], F3[2][..., j, :], DEGENERATE_TOL, "w")
    assert float(F3[1][1].abs().max()) == 0.0


def test_x_degenerate_matches_slab():
    """x-invariant data with v = (0, vy): the qyz / Wyz / Qyz path
    reproduces the slab with x taken as y (dx = 1)."""
    tc, th, t1, (d1, v1, w1, geop1) = _slab_and_3d(12, 12)
    nx3 = 5
    g3 = TGeom.build3d(nx3, 12, np.linspace(0.0, tc.Lz, 13), float(nx3),
                       tc.Lx, 1, torch.float64, "cpu")
    t3 = Tendencies3D(geom=g3, varset=TVarSet(variant="CE", geom=g3,
                                              thermo=th),
                      thermo=th, grav=tc.g)
    tile = lambda a: a[..., None].expand(*a.shape, nx3).contiguous()
    vy = tile(v1)
    dt = 0.05
    F1 = t1.compute_rhs(d1, v1, w1, geop1, dt)
    F3 = t3.compute_rhs(tile(d1), torch.stack([torch.zeros_like(vy), vy]),
                        tile(w1), tile(geop1), dt)
    for i in range(nx3):
        _close(F1[0], F3[0][..., i], DEGENERATE_TOL, "dens")
        _close(F1[1], F3[1][1][..., i], DEGENERATE_TOL, "v")
        _close(F1[2], F3[2][..., i], DEGENERATE_TOL, "w")
    assert float(F3[1][0].abs().max()) == 0.0


def test_qxy_of_horizontal_gradient_vanishes():
    """The vertical vorticity of a horizontal gradient is zero (discrete
    d d = 0 of the xy curl, ext_deriv.h compute_D1)."""
    tend = oracle_case_3d("cpu")[0]
    g = tend.geom
    rng = np.random.default_rng(5)
    phi = torch.from_numpy(rng.standard_normal((g.nens, g.nz, g.ny, g.nx)))
    v = torch.stack([phi - extruded3d.rx(phi, -1),
                     phi - extruded3d.ry(phi, -1)])
    dens = torch.ones((3, g.nens, g.nz, g.ny, g.nx), dtype=torch.float64)
    _, qxy = tend.q_and_f(dens, v, torch.zeros_like(phi[:, 1:]))
    assert float(qxy.abs().max()) < 1e-12


# ----------------------------------------------- pressure linear systems
def _pressure_side(M, ny, cls, dt=3.0, nx=8, nz=10):
    tc = M.tcs.RisingBubble()
    zint = np.linspace(0.0, tc.Lz, nz + 1)
    if ny > 1:
        geom = _build3d(M, nx, ny, zint, tc.Lx, 700.0)
    else:
        geom = M.Geom.build(nx, zint, tc.Lx, NENS, M.dtype, *M.dev)
    th = M.thermo.IdealGasPottemp()
    vs = M.VarSet(variant="CE", geom=geom, thermo=th)
    ref = M.si.build_reference_state(
        geom, th, vs, lambda z: tc.refrho_f(z, th),
        lambda z: tc.refentropicdensity_f(z, th),
        lambda z: np.asarray(tc.refnsq_f(z, th)), tc.g)
    return getattr(M.si, cls).build(geom, th, vs, ref, dt)


SYSTEMS = ("CompressiblePressureLinearSystem",
           "CompressiblePressureGravityLinearSystem")


@pytest.mark.parametrize("cls", SYSTEMS)
@pytest.mark.parametrize("ny", (1, 6))
def test_pressure_system_matches_jax(cls, ny):
    """build's coefficients and a solve of a seeded rhs against pam_tpu,
    on the slab (ny 1) and the 3-D layout, at 1e-12."""
    J = _jax()
    jl, tl = _pressure_side(J, ny, cls), _pressure_side(TORCH, ny, cls)
    assert tl.ndims == (2 if ny > 1 else 1) and tl.dtype == torch.float64
    for k in ("linp", "tri_l", "tri_d", "tri_u", "q_pi", "q_di", "rho_pi",
              "rho_di"):
        _close(getattr(jl, k), getattr(tl, k), TOL, k)
    if cls == SYSTEMS[1]:
        for k in ("Dmod_u", "Dmod_d", "A_l", "A_d", "A_u", "Fhorz"):
            _close(getattr(jl, k), getattr(tl, k), TOL, k)
        _close(1.0 / (jl.rho_pi ** 2 * jl.omega), tl.omega_c, TOL, "c")
    rng = np.random.default_rng(ny)
    h = (ny, 8) if ny > 1 else (8,)
    x = (rng.standard_normal((2, NENS, 10) + h),
         rng.standard_normal(((2,) if ny > 1 else ()) + (NENS, 10) + h),
         rng.standard_normal((NENS, 9) + h))
    jx, tx = _both(x)
    _close(jl.solve(*jx), tl.solve(*tx), TOL, "solve")
    with pytest.raises(TypeError, match="built for"):
        tl.solve(*(a.float() for a in tx))


def _gravity_wave_si():
    """The port's copy of tests/test_si.py::_setup: the gravity wave at
    40x16 with its reference state."""
    tc = ttcs.GravityWave(add_perturbation=True)
    geom = TGeom.build(40, np.linspace(0, tc.Lz, 17), tc.Lx, 1,
                       torch.float64, "cpu")
    th = tthermo.IdealGasPottemp(tthermo.ThermoConstants())
    vs = TVarSet(variant="CE", tracer_names=(), tracer_positive=(),
                 geom=geom, thermo=th)
    dens, v, w, geop = ttcs.setup_testcase(tc, geom, th)
    ref = tsi.build_reference_state(
        geom, th, vs, lambda z: tc.refrho_f(z, th),
        lambda z: tc.refentropicdensity_f(z, th),
        lambda z: np.asarray(tc.refnsq_f(z, th)), tc.g)
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    tend = SpamTendencies(
        geom=geom, varset=vs, thermo=th, grav=tc.g,
        force_refstate_hydrostatic_balance=True, refdens=T(ref["dens"]),
        ref_rho_pi=T(ref["rho_pi"]), ref_q_pi=T(ref["q_pi"]),
        ref_rho_di=T(ref["rho_di"]), ref_q_di=T(ref["q_di"]),
        ref_B=T(ref["B"]))
    linv = tsi.CompressibleVelocityLinearSystem.build(geom, th, vs, ref,
                                                      10.0, grav=tc.g)
    step = lambda lin: tsi.si_step(tend, lin, dens, v, w, geop, 10.0,
                                   max_iters=8)
    return geom, th, vs, ref, step, step(linv)


@pytest.mark.parametrize("cls,vtol,wtol", [
    ("CompressiblePressureLinearSystem", 1e-6, 1e-5),
    ("CompressiblePressureGravityLinearSystem", 1e-8, 1e-8)])
def test_pressure_system_converges_to_the_velocity_step(cls, vtol, wtol):
    """The port's copy of tests/test_si.py::
    test_pressure_linear_system_matches_velocity_system and
    ::test_pressure_gravity_matches_velocity_system: 8 quasi-Newton
    iterations on the gravity wave reach the velocity system's step."""
    geom, th, vs, ref, step, (_, vv, wv) = _gravity_wave_si()
    _, vp, wp = step(getattr(tsi, cls).build(geom, th, vs, ref, 10.0))
    assert float((vv - vp).abs().max()) / float(vv.abs().max()) < vtol
    assert float((wv - wp).abs().max()) / float(wv.abs().max()) < wtol


def test_thomas_keeps_real_factors_for_a_complex_rhs():
    """Real coefficients with a complex rhs (the pressure systems): the
    solution of the tridiagonal system, with the coefficients broadcast
    over the rhs's trailing axes."""
    rng = np.random.default_rng(2)
    n, m = 7, 5
    L, U = rng.standard_normal((2, n, 1))
    D = 4.0 + rng.random((n, 1))
    R = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    x = tridiag.thomas(*(torch.from_numpy(a) for a in (L, D, U, R)))
    A = np.diag(D[:, 0]) + np.diag(L[1:, 0], -1) + np.diag(U[:-1, 0], 1)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, R), rtol=1e-13,
                               atol=1e-13)


def test_dft_matches_numpy():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 6, 65))
    ah = dft.rfft(torch.from_numpy(a))
    np.testing.assert_allclose(ah.numpy(), np.fft.rfft(a), atol=1e-12)
    np.testing.assert_allclose(dft.irfft(ah, 65).numpy(), a, atol=1e-13)
    c = np.fft.fft(np.fft.rfft(a), axis=-2)
    got = dft.fft(ah, dim=-2)
    np.testing.assert_allclose(got.numpy(), c, atol=1e-12)
    np.testing.assert_allclose(dft.ifft(got, dim=-2).numpy(), ah.numpy(),
                               atol=1e-13)


# -------------------------------------------------- geometry, test cases
def test_build3d_matches_jax():
    J = _jax()
    zint = np.linspace(0.0, 1500.0, 9) ** 1.1
    jg = _build3d(J, 7, 5, zint, 1000.0, 800.0)
    tg = _build3d(TORCH, 7, 5, zint, 1000.0, 800.0)
    for k in ("nx", "ny", "nz", "nens", "xlen", "ylen", "dx", "dy",
              "uniform_vertical"):
        assert getattr(jg, k) == getattr(tg, k), k
    for k in ("zint_d", "dz_d", "zint_p", "dz_p"):
        np.testing.assert_array_equal(getattr(jg, k), getattr(tg, k))
    for k in ("d_area_n1", "d_area_nm11", "d_area_nm11_y", "d_area_n0",
              "p_area_10", "p_area_01"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)()),
                                      np.asarray(getattr(tg, k)()))
    np.testing.assert_array_equal(tg.area_n1_t.numpy(), jg.d_area_n1())
    np.testing.assert_array_equal(tg.area_nm11_t.numpy(), jg.d_area_nm11())


@pytest.mark.parametrize("name", ("risingbubble", "moistrisingbubble",
                                  "supercell"))
def test_3d_testcases_equal_jax(name):
    """setup_testcase_3d / setup_supercell_3d (with its reference state)
    against pam_tpu, at 1e-12."""
    out = []
    for M in (_jax(), TORCH):
        tc, moist = M.tcs.testcase_from_string(name)
        geom = _build3d(M, 9, 7, np.linspace(0.0, tc.Lz, 11), tc.Lx,
                        getattr(tc, "Ly", tc.Lx))
        if name == "supercell":
            th = M.thermo.ConstantKappaVirtualPottemp(
                cst=tc.thermo_constants())
            vs = M.VarSet(variant="MCE_rho", tracer_names=("water_vapor",),
                          tracer_positive=(True,), geom=geom, thermo=th)
            out.append(M.tcs.setup_supercell_3d(tc, geom, th, vs))
        else:
            th = M.thermo.IdealGasPottemp()
            out.append(M.tcs.setup_testcase_3d(tc, geom, th))
    _close(out[0], out[1], TOL, name)
    assert out[1][0].shape[-2:] == (7, 9) and out[1][1].shape[0] == 2


def test_3d_diagnostics_equal_jax(pairs):
    """dens0, qhz (the 2-dof stack), qxy and compute_diagnostics' default
    selection (no slab-layout zeta in 3-D) against pam_tpu."""
    J = _jax()
    jt, tt, x = pairs("moist_tanh_cfv")
    jx, tx = _both(x[:3])
    ref = J.diag.compute_diagnostics(jt, *jx)
    got = tdiag.compute_diagnostics(tt, *tx)
    assert set(got) == {"total_dens", "densl", "QHZl", "QXYl"}
    _close(ref, got, TOL, "diagnostics")
    assert got["QHZl"].shape == (2, NENS, NZ + 1, NY, NX)
    assert got["QXYl"].shape == (NENS, NZ, NY, NX)


# --------------------------------------------------- dycore, conversions
@pytest.fixture(scope="module")
def coupled3d():
    """pam_tpu's and the port's coupled 3-D SPAM dycores of
    tests/golden/mmf_spam3d_small_init.npz, and that state."""
    from pam_tpu.driver.mmf import setup_supercell_mmf as jsetup
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf as tsetup
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import make_torch_golden_init as golden
    jdrv, _ = jsetup(**golden.SPAM3D_KW, dtype=_jax().dtype)
    tdrv, _ = tsetup(**golden.SPAM3D_KW, dtype=torch.float64, device="cpu")
    init = dict(np.load(golden.path("mmf_spam3d_small")))
    return jdrv.dycore, tdrv.dycore, init


def test_3d_coupler_conversions_match_jax(coupled3d):
    import jax.numpy as jnp
    jd, td, init = coupled3d
    assert td.ndims == 2 and isinstance(td.tend, Tendencies3D)
    assert isinstance(td.si_linsys,
                      tsi.CompressiblePressureGravityLinearSystem)
    assert td.compute_dt_dyn() == jd.compute_dt_dyn()
    jstate = {k: jnp.asarray(v) for k, v in init.items()}
    tstate = {k: torch.from_numpy(v) for k, v in init.items()}
    ref = jd.coupler_to_dynamics(jstate)
    got = td.coupler_to_dynamics(tstate)
    _close(ref, got, TOL, "coupler_to_dynamics")
    back_j = jd.dynamics_to_coupler(jstate, *ref)
    back_t = td.dynamics_to_coupler(tstate, *got)
    for k in ("density_dry", "temp", "uvel", "vvel", "wvel", "water_vapor"):
        _close(back_j[k], back_t[k], TOL, k)


def test_3d_with_si_takes_the_pressure_systems(coupled3d):
    """with_si in 3-D: the slab-only velocity system becomes
    pressure_gravity (as in pam_tpu), "pressure" builds the plain
    pressure system, an unknown name raises."""
    jd, td, init = coupled3d
    ref = tsi.build_coupled_reference_state(init, td.geom, td.thermo,
                                            td.varset, td.grav)
    assert isinstance(td.with_si(ref, 10.0, linear_system="velocity"
                                 ).si_linsys,
                      tsi.CompressiblePressureGravityLinearSystem)
    lin = td.with_si(ref, 10.0, linear_system="pressure").si_linsys
    assert type(lin) is tsi.CompressiblePressureLinearSystem
    assert lin.ndims == 2 and lin.dt == 10.0
    with pytest.raises(ValueError, match="unknown linear_system"):
        td.with_si(ref, 10.0, linear_system="anelastic")


# ------------------------------------------------------------ on the card
@pytest.mark.parametrize("axis", (extruded3d.AXX, extruded3d.AXY))
def test_plain_edges_h_is_the_cpu_route(axis):
    """weno_x.weno_edges_h_reference, the plain version the card-side B1
    route is held against (stencil rolls along the axis), equals
    Tendencies3D's CPU route (periodic halo on the view with the axis
    last) at 1e-12, f64."""
    rng = np.random.default_rng(11)
    f = torch.as_tensor(rng.standard_normal((3, 2, 7, 12, 10)))
    tb = weno.weno_tables(5, torch.float64)
    got = extruded3d._edge_recon_h(f, tb, axis)
    ref = weno_x.weno_edges_h_reference(f, tb, axis)
    _close([_np(r) for r in ref], [_np(g) for g in got], TOL, "edges")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_b1_along_y_matches_plain_on_card(dtype):
    """Tendencies3D's y reconstruction on the card: B1 on the view with y
    moved last, one launch, against the plain version (stencil rolls
    along y + weno_edges_list) at 1e-12 (f64) / 2e-5 (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    f = torch.as_tensor(rng.standard_normal((3, 2, 7, 12, 10)), dtype=dtype,
                        device="cuda")
    tb = weno.weno_tables(5, dtype)
    before = weno_x.weno_edges_x_cuda.launches
    got = extruded3d._edge_recon_h(f, tb, extruded3d.AXY)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches == before + 1
    ref = weno_x.weno_edges_h_reference(f, tb, extruded3d.AXY)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    _close([r.cpu() for r in ref], [g.cpu() for g in got], tol, "y")


@pytest.mark.gpu
def test_3d_ssprk3_step_on_card_matches_cpu():
    """One 3-D SSPRK3 step on the card (18 B1 launches) against the same
    step on the CPU, f64, at 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for device in ("cpu", "cuda"):
        tend, x, _ = oracle_case_3d(device)
        before = weno_x.weno_edges_x_cuda.launches
        out.append(tend.ssprk3_step(*(torch.as_tensor(a, device=device)
                                      for a in x), 0.5))
        launched = weno_x.weno_edges_x_cuda.launches - before
        assert launched == (18 if device == "cuda" else 0)
    _close([a for a in out[0]], [a.cpu() for a in out[1]], TOL, "step")

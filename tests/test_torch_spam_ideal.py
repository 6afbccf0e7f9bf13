"""The idealized x-z SPAM modules of the port against pam_tpu, module by
module, f64, on the same seeded numpy inputs.

Each test case is built on both sides at 16x12 cells, 2 members
(np.linspace levels, as run_idealized builds them); the dynamics state
is pam_tpu's initial state with seeded noise added, carried to both
sides as the same numpy arrays. Tolerance: 1e-12 of each output's
largest |value| (TOL); the numpy copies (reference states, initial
conditions, exact gravity-wave fields) must be equal.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pam_tpu.spam as jspam
import pam_tpu.spam.diagnostics as jdiag
import pam_tpu.spam.diffusion as jdiff
import pam_tpu.spam.dycore as jdyc
import pam_tpu.spam.operators as jop
import pam_tpu.spam.si as jsi
import pam_tpu.spam.testcases as jtcs
import pam_tpu.spam.thermo as jthermo
import pam_tpu.spam.timesteppers as jts
import pam_tpu.utils.gw_verification as jgw
from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
import pam_tpu_torch.spam.diagnostics as tdiag
import pam_tpu_torch.spam.diffusion as tdiff
import pam_tpu_torch.spam.dycore as tdyc
import pam_tpu_torch.spam.operators as top
import pam_tpu_torch.spam.si as tsi
import pam_tpu_torch.spam.testcases as ttcs
import pam_tpu_torch.spam.thermo as tthermo
import pam_tpu_torch.spam.timesteppers as tts
import pam_tpu_torch.utils.gw_verification as tgw
from pam_tpu_torch.spam.geometry import ExtrudedGeometry as TGeom
from pam_tpu_torch.spam.tendencies import SpamTendencies as TTend
from pam_tpu_torch.spam.varset import VariableSet as TVarSet
from pam_tpu_torch.driver.mmf import setup_supercell_mmf as torch_setup

torch.set_num_threads(1)

TOL = 1e-12
NX, NZ, NENS = 16, 12, 2
# each package's pieces, so that one builder serves both sides
J = types.SimpleNamespace(
    VarSet=jspam.VariableSet, Tend=jspam.SpamTendencies, tcs=jtcs,
    thermo=jthermo, si=jsi, T=jnp.asarray,
    build=lambda nx, zint, xlen: jspam.ExtrudedGeometry.build(
        nx, zint, xlen, NENS, jnp.float64))
T = types.SimpleNamespace(
    VarSet=TVarSet, Tend=TTend, tcs=ttcs, thermo=tthermo, si=tsi,
    T=lambda a: torch.as_tensor(np.asarray(a)),
    build=lambda nx, zint, xlen: TGeom.build(nx, zint, xlen, NENS,
                                             torch.float64, "cpu"))


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
    assert r.shape == g.shape or (r.size == 1 and g.size == 1), \
        (name, r.shape, g.shape)
    scale = max(float(np.abs(r).max()), 1e-300)
    err = float(np.abs(r - g).max()) / scale
    assert err <= tol, (name, err)


def _side(M, name, knobs=(), si=False, thermo=None):
    """Test case ``name`` on package M's side: tend (with the reference
    state when ``si``, the SI linear system at dt 10 then), geop, the
    initial state and the reference dict."""
    tc, moist = M.tcs.testcase_from_string(name)
    geom = M.build(NX, np.linspace(0.0, tc.Lz, NZ + 1), tc.Lx)
    th = M.thermo.thermo_from_string(
        thermo or ("constkappavirpottemp" if moist else "idealgaspottemp"))
    ref = None
    if moist:
        if getattr(tc, "needs_special_init", False):
            th = dataclasses.replace(th, cst=tc.thermo_constants())
        vs = M.VarSet(variant="MCE_rho", tracer_names=("water_vapor",),
                      tracer_positive=(True,), geom=geom, thermo=th)
        if getattr(tc, "needs_special_init", False):
            dens, v, w, geop, ref = M.tcs.setup_supercell(tc, geom, th, vs)
        else:
            dens, v, w, geop = M.tcs.setup_moist_testcase(tc, geom, th)
    else:
        vs = M.VarSet(variant="CE", geom=geom, thermo=th)
        dens, v, w, geop = M.tcs.setup_testcase(tc, geom, th)
    tend = M.Tend(geom=geom, varset=vs, thermo=th, grav=tc.g, **dict(knobs))
    lin = None
    if si:
        if ref is None:
            ref = M.si.build_reference_state(
                geom, th, vs, lambda z: tc.refrho_f(z, th),
                lambda z: tc.refentropicdensity_f(z, th),
                lambda z: np.asarray(tc.refnsq_f(z, th)), tc.g)
        tend = dataclasses.replace(
            tend, force_refstate_hydrostatic_balance=True,
            refdens=M.T(ref["dens"]), ref_rho_pi=M.T(ref["rho_pi"]),
            ref_q_pi=M.T(ref["q_pi"]), ref_rho_di=M.T(ref["rho_di"]),
            ref_q_di=M.T(ref["q_di"]), ref_B=M.T(ref["B"]))
        lin = M.si.CompressibleVelocityLinearSystem.build(
            geom, th, vs, ref, 10.0, grav=tc.g)
    return types.SimpleNamespace(tc=tc, geom=geom, thermo=th, vs=vs,
                                 tend=tend, lin=lin, geop=geop, ref=ref,
                                 x0=(dens, v, w))


def _noisy(side, seed):
    """side's initial state with seeded noise, numpy."""
    rng = np.random.default_rng(seed)
    dens, v, w = (np.array(_np(a)) for a in side.x0)
    g = side.geom
    dens[:2] *= 1.0 + 1e-3 * rng.standard_normal(dens[:2].shape)
    if dens.shape[0] > 2:
        dens[2:] *= 1.0 + 0.2 * rng.random(dens[2:].shape)
    v = v + 2.0 * g.dx * rng.standard_normal(v.shape)
    w = w + 0.5 * np.asarray(g.dz_p)[:, :, None] * \
        rng.standard_normal(w.shape)
    return dens, v, w


# (name, tend knobs, with the SI reference state)
CASES = {
    "dry": ("risingbubble", (), False),
    "dry_si": ("gravitywave", (), True),
    "tanh": ("densitycurrent", (("dual_upwind_type", "tanh"),
                                ("tanh_upwind_coeff", 50.0)), False),
    "diff_ord4": ("largerisingbubble", (("diff_ord", 4),), True),
    "diff_ord6": ("risingbubble", (("diff_ord", 6),), False),
    "moist": ("moistrisingbubble", (), False),
    "supercell": ("supercell", tuple(
        (k, c) for k, c in (
            ("scalar_horiz_diffusion_coeff", 1500.0),
            ("scalar_vert_diffusion_coeff", 1500.0),
            ("velocity_vort_horiz_diffusion_coeff", 500.0),
            ("velocity_vort_vert_diffusion_coeff", 500.0),
            ("velocity_div_horiz_diffusion_coeff", 500.0),
            ("velocity_div_vert_diffusion_coeff", 500.0))), True),
}


# the supercell's B_mass carries qv (Lvr + Lfr) ~ 5e6 J/kg (Lfr = 333.55e6,
# qv up to 0.014) beside terms that cancel in B[i] - B[i-1]; its f64
# rounding, ~1e-9 absolute, lands in vtend and wtend (largest |value|
# ~400): 2e-12 of them, the floor of both packages' arithmetic; every
# other output of the supercell holds 1e-12
CASE_TOL = {("supercell", "compute_rhs"): 1e-11}


@pytest.fixture(scope="module")
def pairs():
    """{case: (jax side, torch side, seeded state)} built on demand."""
    cache = {}

    def get(case):
        if case not in cache:
            name, knobs, si = CASES[case]
            js, ts = _side(J, name, knobs, si), _side(T, name, knobs, si)
            cache[case] = (js, ts, _noisy(js, seed=list(CASES).index(case) + 3))
        return cache[case]
    return get


def _x(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ---------------------------------------------------------------- thermo
THERMOS = ("IdealGasPottemp", "IdealGasEntropy",
           "ConstantKappaVirtualPottemp")
THERMO_METHODS = (
    "compute_U", "compute_dUdalpha", "compute_dUdentropic_var",
    "compute_dUdq", "compute_alpha", "compute_entropic_var_from_p_T",
    "compute_entropic_var_from_alpha_T", "solve_p", "compute_T_from_alpha",
    "compute_T_from_p", "compute_dpdentropic_var", "compute_soundspeed",
    "compute_H", "compute_dHdentropic_var", "compute_dHdq")


def _thermo_args(cls, method, rng):
    """Plausible atmospheric arguments of ``method`` (two leading
    arguments by its signature, then qd, qv, ql, qi)."""
    n = (3, 7)
    u = lambda lo, hi: lo + (hi - lo) * rng.random(n)
    entropy = cls == "IdealGasEntropy"
    ev = u(60.0, 130.0) if entropy else u(280.0, 340.0)
    first = {"compute_alpha": ("p", "T"),
             "compute_entropic_var_from_p_T": ("p", "T"),
             "compute_entropic_var_from_alpha_T": ("alpha", "T"),
             "solve_p": ("rho", "ev"), "compute_T_from_p": ("p", "ev"),
             "compute_H": ("p", "ev"), "compute_dHdentropic_var": ("p", "ev"),
             "compute_dHdq": ("p", "ev")}.get(method, ("alpha", "ev"))
    vals = {"p": u(3e4, 1e5), "T": u(220.0, 310.0), "alpha": u(0.8, 2.5),
            "rho": u(0.4, 1.25), "ev": ev}
    qv, ql, qi = u(0.0, 0.015), u(0.0, 2e-3), u(0.0, 1e-3)
    return [vals[k] for k in first] + [1.0 - qv - ql - qi, qv, ql, qi]


@pytest.mark.parametrize("cls", THERMOS)
@pytest.mark.parametrize("method", THERMO_METHODS)
def test_thermo_method_matches_jax(cls, method):
    args = _thermo_args(cls, method, np.random.default_rng(
        THERMO_METHODS.index(method)))
    ref = getattr(getattr(jthermo, cls)(), method)(
        *[jnp.asarray(a) for a in args])
    got = getattr(getattr(tthermo, cls)(), method)(
        *[torch.from_numpy(a) for a in args])
    # numpy in, numpy out (the setup path): the same numbers
    got_np = getattr(getattr(tthermo, cls)(), method)(*args)
    if method in ("compute_dUdq", "compute_dHdq"):
        full = lambda out: [np.broadcast_to(np.asarray(_np(o), np.float64),
                                            (3, 7)) for o in out]
        ref, got, got_np = full(ref), full(got), full(got_np)
    else:
        assert isinstance(got, torch.Tensor) and \
            isinstance(got_np, np.ndarray)
    _close(ref, got)
    _close(got, got_np)


def test_thermo_registry_and_stubs_match_jax():
    assert set(tthermo.THERMO_REGISTRY) == set(jthermo.THERMO_REGISTRY)
    for name in jthermo.THERMO_REGISTRY:
        j, t = jthermo.thermo_from_string(name), tthermo.thermo_from_string(
            name)
        assert type(j).__name__ == type(t).__name__
        assert j.cst == jthermo.ThermoConstants() and \
            dataclasses.asdict(t.cst) == dataclasses.asdict(j.cst)
        assert t.moist_species_decouple_from_dynamics == \
            j.moist_species_decouple_from_dynamics
    for name in ("constkappaentropy", "unapproxpottemp", "unapproxentropy"):
        for mod in (jthermo, tthermo):
            with pytest.raises(NotImplementedError, match="unimplemented"):
                mod.thermo_from_string(name).compute_U(1.0, 300.0)
    cst = tthermo.ThermoConstants(Cpd=1003.0)
    assert tthermo.thermo_from_string("IdealGasPottemp", cst).cst is cst


# --------------------------------------------------------------- varset
def test_variable_set_accessors_match_jax():
    rng = np.random.default_rng(5)
    names = ("water_vapor", "cloud_liquid", "precip_liquid", "ice")
    dens = 1.0 + rng.random((6, NENS, NZ, NX))
    dens[2:] *= 1e-3
    geom_j = J.build(NX, np.linspace(0, 1e4, NZ + 1), 2e4)
    geom_t = T.build(NX, np.linspace(0, 1e4, NZ + 1), 2e4)
    for variant, tracers in (("CE", ()), ("MCE_rho", names),
                             ("MCE_rho", names[:1])):
        d = dens[:2 + len(tracers)]
        kw = dict(variant=variant, tracer_names=tracers,
                  tracer_positive=(True,) * len(tracers))
        j = J.VarSet(geom=geom_j, **kw)
        t = T.VarSet(geom=geom_t, **kw)
        jd, td = jnp.asarray(d), torch.from_numpy(d)
        for prop in ("ndensity", "ndensity_dycore", "ntracers_physics",
                     "ndensity_active", "active_dens_ids", "liq_found",
                     "ice_found"):
            assert getattr(j, prop) == getattr(t, prop), (variant, prop)
        np.testing.assert_array_equal(j.dens_pos, t.dens_pos)
        acc = ["get_total_density", "get_entropic_var", "get_alpha",
               "get_qd", "get_dry_density", "moist_qs"]
        if tracers:
            acc.append("get_qv")
        if len(tracers) > 1:
            acc += ["get_ql", "get_qi"]
        for name in acc:
            _close(getattr(j, name)(jd), getattr(t, name)(td),
                   name=f"{variant}.{name}")


# ------------------------------------------------------------ operators
@pytest.mark.parametrize("ord", (2, 4, 6))
@pytest.mark.parametrize("op", ("H10_ho", "Hn1bar_ho"))
def test_high_order_hodge_star_matches_jax(pairs, op, ord):
    js, ts, (dens, v, w) = pairs("dry")
    arg = v if op == "H10_ho" else dens
    _close(getattr(jop, op)(jnp.asarray(arg), js.geom, ord),
           getattr(top, op)(torch.from_numpy(arg), ts.geom, ord))


def test_d0_x_and_bad_order():
    a = np.random.default_rng(2).standard_normal((2, NENS, NZ, NX))
    _close(jop.D0_x(jnp.asarray(a)), top.D0_x(torch.from_numpy(a)))
    with pytest.raises(ValueError, match="diff_ord"):
        top.H10_ho(torch.zeros(NENS, NZ, NX, dtype=torch.float64),
                   T.build(NX, np.linspace(0, 1, NZ + 1), 1.0), 3)


# ------------------------------------------- tendencies, by case and op
TEND_OPS = ("functional_derivatives", "recons", "compute_rhs", "energy",
            "statistics")


def _tend_op(side, op, x, geop):
    tend = side.tend
    dens, v, w = x
    if op == "recons":
        o = jop if side.tend.__module__.startswith("pam_tpu.") else top
        F, FW, _, _ = tend.functional_derivatives(dens, v, w, geop)
        qhz = tend.q_and_f(dens, v, w)
        return tend.recons(dens, qhz, F, FW, o.Wxz_u(FW), o.Wxz_w(F))
    if op in ("functional_derivatives", "energy", "statistics"):
        return getattr(tend, op)(dens, v, w, geop)
    return tend.compute_rhs(dens, v, w, geop, 2.0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", TEND_OPS)
def test_tendency_op_matches_jax(pairs, case, op):
    """The CE branch (dry cases), tanh upwinding, diff_ord 4 and 6, the
    moist MCE_rho cases and the supercell's six diffusion coefficients
    through compute_rhs, the energies and the statistics."""
    js, ts, x = pairs(case)
    jx, tx = _x(x)
    ref = _tend_op(js, op, jx, js.geop)
    got = _tend_op(ts, op, tx, ts.geop)
    _close(ref, got, CASE_TOL.get((case, op), TOL), name=f"{case}.{op}")


@pytest.mark.parametrize("fn", ("scalar", "velocity"))
def test_diffusion_matches_jax(pairs, fn):
    js, ts, (dens, v, w) = pairs("supercell")
    rng = np.random.default_rng(9)
    dt = rng.standard_normal(dens.shape) * 1e3
    vt = rng.standard_normal(v.shape)
    wt = rng.standard_normal(w.shape)
    if fn == "scalar":
        ref = jdiff.scalar_diffusion(js.tend, jnp.asarray(dens),
                                     jnp.asarray(dt), 1500.0, 700.0)
        got = tdiff.scalar_diffusion(ts.tend, torch.from_numpy(dens),
                                     torch.from_numpy(dt), 1500.0, 700.0)
    else:
        args = (500.0, 400.0, 300.0, 200.0)
        ref = jdiff.velocity_diffusion(js.tend, jnp.asarray(v),
                                       jnp.asarray(w), jnp.asarray(vt),
                                       jnp.asarray(wt), *args)
        got = tdiff.velocity_diffusion(ts.tend, torch.from_numpy(v),
                                       torch.from_numpy(w),
                                       torch.from_numpy(vt),
                                       torch.from_numpy(wt), *args)
    _close(ref, got)


STEPPERS = ("ssprk2", "ssprk3", "ssprk34", "kgrk4", "kgrk10", "lsrk5")


@pytest.mark.parametrize("name", STEPPERS)
def test_timestepper_matches_jax(pairs, name):
    """One step of each explicit integrator on compute_rhs (dry, CE)."""
    js, ts, x = pairs("dry")
    jx, tx = _x(x)
    dt = 0.05
    ref = jts.STEPPERS[name](
        lambda s: js.tend.compute_rhs(*s, js.geop, dt), tuple(jx), dt)
    got = tts.STEPPERS[name](
        lambda s: ts.tend.compute_rhs(*s, ts.geop, dt), tuple(tx), dt)
    _close(ref, got, name=name)
    assert set(tts.STEPPERS) == set(jts.STEPPERS)


def test_tendencies_ssprk3_step_matches_jax(pairs):
    js, ts, x = pairs("moist")
    jx, tx = _x(x)
    _close(js.tend.ssprk3_step(*jx, js.geop, 0.05),
           ts.tend.ssprk3_step(*tx, ts.geop, 0.05))


# ------------------------------------------------------------------- SI
@pytest.mark.parametrize("where", ("near", "away", "mixed"))
def test_gamma_avg_matches_jax(where):
    rng = np.random.default_rng(11)
    a = 250.0 + 100.0 * rng.random((4, 9))
    rel = {"near": 1e-7, "away": 0.2, "mixed": 0.0}[where]
    b = a * (1.0 + rel * rng.standard_normal(a.shape))
    if where == "mixed":
        b = np.where(rng.random(a.shape) < 0.5, a,
                     a * (1.0 + 0.1 * rng.standard_normal(a.shape)))
        b[0, 0] = a[0, 0]                 # a == b exactly: no NaN
    g = 1004.0 / 717.0
    ref = jsi.gamma_avg(jnp.asarray(a), jnp.asarray(b), g)
    got = tsi.gamma_avg(torch.from_numpy(a), torch.from_numpy(b), g)
    assert bool(torch.isfinite(got).all())
    _close(ref, got)


@pytest.mark.parametrize("case", ("dry_si", "supercell"))
def test_two_point_discrete_gradient_matches_jax(pairs, case):
    js, ts, x = pairs(case)
    x2 = _noisy(js, seed=17)
    jx, tx = _x(x)
    jx2, tx2 = _x(x2)
    _close(jsi.two_point_discrete_gradient(js.tend, jx, jx2, js.geop),
           tsi.two_point_discrete_gradient(ts.tend, tx, tx2, ts.geop))


def test_two_point_refuses_other_thermo():
    side = _side(T, "risingbubble", thermo="idealgasentropy")
    x = tuple(side.x0)
    with pytest.raises(NotImplementedError, match="two-point"):
        tsi.two_point_discrete_gradient(side.tend, x, x, side.geop)


@pytest.mark.parametrize("two_point", (False, True))
def test_si_step_matches_jax(pairs, two_point):
    js, ts, x = pairs("dry_si")
    jx, tx = _x(x)
    _close(jsi.si_step(js.tend, js.lin, *jx, js.geop, 10.0,
                       two_point=two_point),
           tsi.si_step(ts.tend, ts.lin, *tx, ts.geop, 10.0,
                       two_point=two_point), 1e-10)


def test_si_step_monitored_norms_match_jax(pairs):
    js, ts, x = pairs("supercell")
    jx, tx = _x(x)
    rx, rn = jsi.si_step_monitored(js.tend, js.lin, *jx, js.geop, 10.0,
                                   max_iters=4)
    gx, gn = tsi.si_step_monitored(ts.tend, ts.lin, *tx, ts.geop, 10.0,
                                   max_iters=4)
    assert gn.shape == (5,)
    _close(rn, gn, 1e-10)
    _close(rx, gx, 1e-10)


def test_si_fixed_step_matches_jax(pairs):
    js, ts, x = pairs("dry")
    jx, tx = _x(x)
    _close(jsi.si_fixed_step(js.tend, *jx, js.geop, 0.05),
           tsi.si_fixed_step(ts.tend, *tx, ts.geop, 0.05), 1e-10)


@pytest.mark.parametrize("name", ("risingbubble", "gravitywave",
                                  "largerisingbubble"))
def test_build_reference_state_equals_jax(name):
    js, ts = _side(J, name, si=True), _side(T, name, si=True)
    assert set(js.ref) == set(ts.ref)
    for k in js.ref:
        np.testing.assert_array_equal(ts.ref[k], np.asarray(js.ref[k]),
                                      err_msg=k)


def test_build_moist_reference_state_equals_jax():
    js, ts = _side(J, "supercell"), _side(T, "supercell")
    rng = np.random.default_rng(4)
    refdens = np.asarray(js.ref["dens"]) * (1 + 1e-3 * rng.random(
        js.ref["dens"].shape))
    ref = jsi.build_moist_reference_state(js.geom, js.thermo, js.vs, refdens,
                                          js.tc.refnsq_f, js.tc.g)
    got = tsi.build_moist_reference_state(ts.geom, ts.thermo, ts.vs, refdens,
                                          ts.tc.refnsq_f, ts.tc.g)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


# ------------------------------------------------------------ test cases
@pytest.mark.parametrize("name", sorted(jtcs.TESTCASE_REGISTRY))
def test_testcase_initial_state_equals_jax(name):
    """(dens, v, w, geop) of every registered x-z case, and the supercell's
    reference state, equal pam_tpu's (f64: no cast)."""
    assert set(ttcs.TESTCASE_REGISTRY) == set(jtcs.TESTCASE_REGISTRY)
    assert ttcs.TESTCASE_REGISTRY[name][1] == jtcs.TESTCASE_REGISTRY[name][1]
    js, ts = _side(J, name), _side(T, name)
    assert dataclasses.asdict(ts.tc) == dataclasses.asdict(js.tc)
    for a, b in zip(js.x0 + (js.geop,), ts.x0 + (ts.geop,)):
        assert b.dtype == torch.float64 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if js.ref is not None:
        for k in js.ref:
            np.testing.assert_array_equal(ts.ref[k], np.asarray(js.ref[k]))


def test_testcase_initial_state_f32_is_the_cast():
    tc = ttcs.RisingBubble()
    th = tthermo.IdealGasPottemp()
    zint = np.linspace(0.0, tc.Lz, NZ + 1)
    g64 = TGeom.build(NX, zint, tc.Lx, NENS, torch.float64, "cpu")
    g32 = TGeom.build(NX, zint, tc.Lx, NENS, torch.float32, "cpu")
    for a, b in zip(ttcs.setup_testcase(tc, g64, th),
                    ttcs.setup_testcase(tc, g32, th)):
        assert b.dtype == torch.float32
        assert torch.equal(a.to(torch.float32), b)


# ----------------------------------------------------------- diagnostics
def test_diagnostics_match_jax(pairs):
    js, ts, x = pairs("moist")
    jx, tx = _x(x)
    ref = jdiag.compute_diagnostics(js.tend, *jx)
    got = tdiag.compute_diagnostics(ts.tend, *tx)
    _close(ref, got)
    for mod, tend, xx in ((jdiag, js.tend, jx), (tdiag, ts.tend, tx)):
        with pytest.raises(ValueError, match="3-D"):
            mod.qxy(tend, *xx)


def test_gravity_wave_exact_equals_jax():
    js, ts = _side(J, "gravitywave"), _side(T, "gravitywave")
    ref = jdiag.gravity_wave_exact(js.tc, js.geom, js.thermo, 240.0)
    got = tdiag.gravity_wave_exact(ts.tc, ts.geom, ts.thermo, 240.0)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_gravity_wave_errors_match_jax(pairs):
    js, ts, (dens, v, w) = pairs("dry_si")
    ref = jgw.gravity_wave_errors(js.tc, js.geom, js.thermo, js.vs,
                                  jnp.asarray(dens), jnp.asarray(w), 60.0)
    got = tgw.gravity_wave_errors(ts.tc, ts.geom, ts.thermo, ts.vs,
                                  torch.from_numpy(dens),
                                  torch.from_numpy(w), 60.0)
    for var in ref:
        np.testing.assert_allclose(got[var], ref[var], rtol=1e-9, atol=0)


def test_gw_run_level_matches_jax():
    ref, _, _ = jgw.run_level(nx=12, nz=6, dt=20.0, timeend=60.0)
    got, _, _ = tgw.run_level(nx=12, nz=6, dt=20.0, timeend=60.0,
                              device="cpu")
    for var in ref:
        np.testing.assert_allclose(got[var][:2], ref[var][:2], rtol=1e-8,
                                   atol=0, err_msg=var)


# --------------------------------------------------------------- dycore
KW = dict(nx=15, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
          dt_crm_phys=20.0, dycore="spam")


@pytest.fixture(scope="module")
def coupled():
    """The coupled SPAM dycore of both packages at an odd nx, and
    pam_tpu's initial state with seeded winds and cloud (numpy)."""
    jdrv, jstate = jax_setup(**KW, dtype=jnp.float64)
    tdrv, _ = torch_setup(**KW, dtype=torch.float64, device="cpu")
    init = {k: np.array(v) for k, v in jstate.items()}
    rng = np.random.default_rng(21)
    init["uvel"] = init["uvel"] + rng.standard_normal(init["uvel"].shape)
    init["wvel"] = rng.standard_normal(init["wvel"].shape)
    init["cloud_liquid"] = 1e-5 * rng.random(init["cloud_liquid"].shape)
    return jdrv.dycore, tdrv.dycore, init


def test_compute_dt_dyn_matches_jax(coupled):
    jd, td, _ = coupled
    assert td.varset.variant == "MCE_rho"
    for cfl in (0.5, 0.3):
        assert td.compute_dt_dyn(cfl) == jd.compute_dt_dyn(cfl)


@pytest.mark.parametrize("n_substeps", (None, 2))
def test_explicit_timestep_matches_jax(coupled, n_substeps):
    """SSPRK3 substeps (no SI): by the acoustic CFL, or as many as asked,
    with the clip after each."""
    jd, td, init = coupled
    jd = dataclasses.replace(jd, si_linsys=None)
    td = dataclasses.replace(td, si_linsys=None)
    dt_phys = 20.0 if n_substeps is None else 4.0
    ref = jd.timestep({k: jnp.asarray(v) for k, v in init.items()}, dt_phys,
                      n_substeps)
    got = td.timestep({k: torch.from_numpy(v) for k, v in init.items()},
                      dt_phys, n_substeps)
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor",
              "cloud_liquid"):
        _close(ref[k], got[k], 1e-10, k)


def test_exact_inverse_wind_conversion_matches_jax(coupled):
    jd, td, init = coupled
    jd = dataclasses.replace(jd, couple_wind_exact_inverse=True)
    td = dataclasses.replace(td, couple_wind_exact_inverse=True)
    ref = jd.coupler_to_dynamics({k: jnp.asarray(v) for k, v in init.items()})
    got = td.coupler_to_dynamics({k: torch.from_numpy(v)
                                  for k, v in init.items()})
    _close(ref, got)
    # the inverse: averaging its winds back gives the coupler's winds
    back = td.dynamics_to_coupler({k: torch.from_numpy(v)
                                   for k, v in init.items()}, *got)
    _close(init["uvel"], back["uvel"], 1e-11)
    rng = np.random.default_rng(8)
    u = rng.standard_normal((3, 5, 9))
    for axis in (-1, 1):
        _close(jdyc.exact_inverse_avg(jnp.asarray(u), axis),
               tdyc.exact_inverse_avg(torch.from_numpy(u), axis))
    with pytest.raises(ValueError, match="odd"):
        tdyc.exact_inverse_avg(torch.zeros(3, 8, dtype=torch.float64))


def test_two_point_si_timestep_matches_jax(coupled):
    jd, td, init = coupled
    refstate = jsi.build_coupled_reference_state(
        {k: jnp.asarray(v) for k, v in init.items()}, jd.geom, jd.thermo,
        jd.varset, jd.grav)
    jd = jd.with_si(refstate, 20.0, two_point=True)
    td = td.with_si(refstate, 20.0, two_point=True)
    assert td.si_two_point
    ref = jd.timestep({k: jnp.asarray(v) for k, v in init.items()}, 20.0)
    got = td.timestep({k: torch.from_numpy(v) for k, v in init.items()},
                      20.0)
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor"):
        _close(ref[k], got[k], 1e-10, k)
    # the slab's other linear systems: the pressure systems build, an
    # unknown name is refused
    assert type(td.with_si(refstate, 20.0, linear_system="pressure")
                .si_linsys) is tsi.CompressiblePressureLinearSystem
    with pytest.raises(ValueError, match="unknown linear_system"):
        td.with_si(refstate, 20.0, linear_system="anelastic")

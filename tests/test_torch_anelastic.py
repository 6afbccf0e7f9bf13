"""The anelastic SPAM models of the port (spam/anelastic.py and the hamil
an | man branch of driver/standalone.py) against pam_tpu and against the
numpy oracle tests/spam_oracle.py, f64, on the same seeded numpy inputs
(tests/torch_anelastic_case.py, 10x8 cells, 2 members):

* the pressure solver's arrays and its projection, the AN and MAN
  functional derivatives and compute_rhs, function by function;
* si.py's post_symplectic hook on a stub tendencies class, and
  si_fixed_step with the projection after every evaluation;
* run_idealized on configs/input_risingbubble_an.yaml and on the moist
  rising bubble with hamil man, cut to 16x12 cells and 2 members
  (tools/make_torch_golden_init.py::AN_LAYER), against pam_tpu's run and
  the golden files; the si_fixed and si integrators on the AN model;
* pam_tpu's own checks of tests/test_anelastic.py, mirrored on the port;
* on the card: B1 at the anelastic shapes, one AN step against the CPU.

Tolerances: 1e-12 of each output's largest |value| against pam_tpu for
the module functions (TOL), 1e-10 for si_fixed_step, whose five
evaluations each solve a Poisson problem (SI_TOL), 1e-9 for the runs
(RUN_TOL), 1e-10 of max(1, |value|) against the oracle (its tolerance in
tests/test_anelastic_oracle.py). JAX is imported inside the fixtures and
tests that use it, so that the card-side cases run where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_anelastic.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from pam_tpu_torch.driver import standalone as tstandalone
from pam_tpu_torch.ops import weno, weno_x
from pam_tpu_torch.spam import operators as top, si as tsi
from pam_tpu_torch.spam.anelastic import project_initial
from pam_tpu_torch.spam.tendencies import SpamTendencies

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
import spam_oracle as orc  # noqa: E402
from torch_anelastic_case import an_case  # noqa: E402
import make_torch_golden_init as golden  # noqa: E402

TOL = 1e-12
SI_TOL = 1e-10
RUN_TOL = 1e-9
ORACLE_TOL = 1e-10
AN_RUNS = ("risingbubble_an", "moistrisingbubble_man")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _rel(ref, got):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _close(ref, got, tol=TOL, name=""):
    for i, (r, g) in enumerate(zip(ref, got)):
        err = _rel(r, g)
        assert err < tol, (name, i, err)


def _oracle_close(got, want, name):
    got = _np(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err < ORACLE_TOL, (name, err)


def _jax_case(hamil, geom):
    """pam_tpu's tendencies of an_case's model on ``geom``'s grid, built by
    pam_tpu from the same test case."""
    import jax.numpy as jnp
    from pam_tpu.spam import si as jsi, testcases as jtcs
    from pam_tpu.spam.anelastic import (AnelasticPressureSolver,
                                        AnelasticTendencies, ManTendencies)
    from pam_tpu.spam.geometry import ExtrudedGeometry
    from pam_tpu.spam.thermo import (ConstantKappaVirtualPottemp,
                                     IdealGasPottemp)
    from pam_tpu.spam.varset import VariableSet
    moist = hamil == "man"
    tc = jtcs.MoistRisingBubble() if moist else jtcs.RisingBubble()
    thermo = ConstantKappaVirtualPottemp() if moist else IdealGasPottemp()
    nens, nz, nx = geom.nens, geom.nz, geom.nx
    geom = ExtrudedGeometry.build(nx, np.linspace(0.0, tc.Lz, nz + 1),
                                  tc.Lx, nens=nens, dtype=jnp.float64)
    tracers = ("water_vapor",) if moist else ()
    vs = VariableSet(variant="MCE_rho" if moist else "CE",
                     tracer_names=tracers,
                     tracer_positive=(True,) * len(tracers), geom=geom,
                     thermo=thermo)
    jref = jsi.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: tc.refnsq_f(z, thermo), tc.g)
    psolver = AnelasticPressureSolver.build(geom, jref["rho_pi"],
                                            jref["rho_di"])
    J = jnp.asarray
    cls = ManTendencies if moist else AnelasticTendencies
    tend = cls(geom=geom, varset=vs, thermo=thermo, grav=tc.g,
               force_refstate_hydrostatic_balance=True,
               refdens=J(jref["dens"]), ref_rho_pi=J(jref["rho_pi"]),
               ref_q_pi=J(jref["q_pi"]), ref_rho_di=J(jref["rho_di"]),
               ref_q_di=J(jref["q_di"]), ref_B=J(jref["B"]),
               psolver=psolver)
    return tend, jref


@pytest.fixture(scope="module")
def pairs():
    """{hamil: (port's tend, pam_tpu's tend, numpy (dens, v, w, geop),
    oracle kwargs, port's reference state, pam_tpu's)} built on demand."""
    cache = {}

    def get(hamil):
        if hamil not in cache:
            tend, x, oracle, ref = an_case("cpu", hamil)
            jtend, jref = _jax_case(hamil, tend.geom)
            cache[hamil] = (tend, jtend, x, oracle, ref, jref)
        return cache[hamil]
    return get


def _t(x):
    return [torch.as_tensor(a) for a in x]


def _j(x):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in x]


def _constraint(tend, v, w):
    """max |div(rho_ref u)| of (v, w) (tests/test_anelastic.py)."""
    g, ps = tend.geom, tend.psolver
    F = top.H10(v, g) * ps.rho_pi[:, :, None]
    FW_in = w * (g.dx / g.dz_p_t[:, :, None]) * ps.rho_di[:, 1:g.nz, None]
    zr = torch.zeros_like(FW_in[:, :1])
    FW = torch.cat([zr, FW_in, zr], dim=1)
    mf = (top.rollm(F, 1) - F) + (FW[:, 1:] - FW[:, :-1])
    return float(mf.abs().max())


# ------------------------------------------------------------ the modules
@pytest.mark.parametrize("hamil", ("an", "man"))
def test_reference_and_solver_arrays_equal_jax(pairs, hamil):
    """The reference state (numpy on both sides) and the solver's
    coefficients, cast once to float64: equal to pam_tpu's."""
    tend, jtend, _, _, ref, jref = pairs(hamil)
    for k in ("dens", "rho_pi", "q_pi", "rho_di", "q_di", "B"):
        np.testing.assert_array_equal(ref[k], np.asarray(jref[k]), k)
    ps, jps = tend.psolver, jtend.psolver
    assert ps.kfix == jps.kfix == tend.geom.nz // 2
    for k in ("rho_pi", "rho_di", "tri_l", "tri_d", "tri_u"):
        got = getattr(ps, k)
        assert got.dtype == torch.float64, k
        np.testing.assert_array_equal(_np(got), np.asarray(getattr(jps, k)),
                                      k)


def test_project_matches_jax_and_oracle(pairs):
    """AnelasticPressureSolver.project at 1e-12 of pam_tpu's and 1e-10 of
    the oracle's FFT + pinned Thomas Poisson solve."""
    tend, jtend, (_, v, w, _), oracle, _, _ = pairs("an")
    got = tend.psolver.project(*_t((v, w)))
    ref = jtend.psolver.project(*_j((v, w)))
    _close(ref, got, TOL, "project")
    dvo, dwo = orc.anelastic_project_oracle(
        v, w, oracle["dz_d"], oracle["dz_p"], oracle["dx"], oracle["ref"])
    _oracle_close(got[0], dvo, "dv")
    _oracle_close(got[1], dwo, "dw")


def test_projection_enforces_constraint(pairs):
    """(tests/test_anelastic.py) the projected winds satisfy the
    anelastic constraint to round-off; projecting twice changes
    nothing."""
    tend, _, (_, v, w, _), _, _, _ = pairs("an")
    v, w = _t((v, w))
    scale0 = _constraint(tend, v, w)
    v2, w2 = project_initial(tend.psolver, v, w)
    assert _constraint(tend, v2, w2) < 1e-10 * scale0
    v3, _ = project_initial(tend.psolver, v2, w2)
    assert float((v3 - v2).abs().max()) < 1e-10


@pytest.mark.parametrize("hamil", ("an", "man"))
def test_functional_derivatives_match_jax(pairs, hamil):
    """F, FW, K and B (the enthalpy at the reference pressure; MAN with
    the reference vapour and the chemical potentials)."""
    tend, jtend, x, _, _, _ = pairs(hamil)
    _close(jtend.functional_derivatives(*_j(x)),
           tend.functional_derivatives(*_t(x)), TOL, hamil)


@pytest.mark.parametrize("hamil", ("an", "man"))
def test_compute_rhs_matches_jax(pairs, hamil):
    """The whole AN / MAN compute_rhs: the mass row's reconstruction
    identically 1, its tendency 0, the tendency projected."""
    tend, jtend, x, _, _, _ = pairs(hamil)
    got = tend.compute_rhs(*_t(x), 5.0)
    _close(jtend.compute_rhs(*_j(x), 5.0), got, TOL, hamil)
    assert float(got[0][0].abs().max()) == 0.0


def test_an_functional_derivatives_and_rhs_match_oracle(pairs):
    """AN functional derivatives (anelastic.h:83-115) and the full AN
    compute_rhs against tests/spam_oracle.py at 1e-10."""
    tend, _, (dens, v, w, geop), oracle, _, _ = pairs("an")
    o = oracle
    F, FW, _, B = tend.functional_derivatives(*_t((dens, v, w, geop)))
    Fo, FWo, _, Bo = orc.fd_an_oracle(dens, v, w, geop, o["dz_d"],
                                      o["dz_p"], o["dx"], o["dy"], o["cst"],
                                      o["ref"])
    for name, g, r in (("F", F, Fo), ("FW", FW, FWo), ("B", B, Bo)):
        _oracle_close(g, r, name)
    got = tend.compute_rhs(*_t((dens, v, w, geop)), 5.0)
    want = orc.anelastic_rhs_oracle(dens, v, w, geop, 5.0, **oracle)
    for name, g, r in zip(("dens", "v", "w"), got, want):
        _oracle_close(g, r, name)


def test_tendency_is_divergence_free(pairs):
    """(tests/test_anelastic.py) the AN tendency satisfies the anelastic
    constraint; the mass density has none."""
    tend, _, x, _, _, _ = pairs("an")
    fd, fv, fw = tend.compute_rhs(*_t(x), 1.0)
    assert _constraint(tend, -fv, -fw) < 1e-10
    assert float(fd[0].abs().max()) == 0.0


# ----------------------------------------------- the SI integrators' hook
def _stub_classes():
    """A CE tendencies class with a post_symplectic hook that scales the
    three tendencies and counts its calls, on both sides."""
    from pam_tpu.spam.tendencies import SpamTendencies as JSpamTendencies

    def hook(self, fd, fv, fw):
        self.calls.append(1)
        return 0.5 * fd, -fv, 2.0 * fw

    classes = []
    for base in (SpamTendencies, JSpamTendencies):
        cls = dataclasses.dataclass(frozen=True, eq=False)(type(
            "Stub", (base,), {"__annotations__": {"calls": list},
                              "calls": dataclasses.field(
                                  default_factory=list),
                              "post_symplectic": hook}))
        classes.append(cls)
    return classes


def test_apply_symplectic_full_calls_post_symplectic(pairs):
    """si._apply_symplectic_full applies the tendencies' post_symplectic
    as pam_tpu/spam/si.py:653-655 does: on a stub with the hook, the SI
    integrators' evaluations and si_fixed_step equal pam_tpu's with the
    same stub at 1e-12, with as many calls of the hook."""
    import jax.numpy as jnp
    import pam_tpu.spam.si as jsi
    tend, jtend, x, _, _, _ = pairs("an")
    Stub, JStub = _stub_classes()
    keep = {f.name: getattr(tend, f.name)
            for f in dataclasses.fields(SpamTendencies)}
    jkeep = {f.name: getattr(jtend, f.name)
             for f in dataclasses.fields(type(jtend))
             if f.name in keep}
    stub, jstub = Stub(**keep), JStub(**jkeep)
    xt, xj = _t(x[:3]), _j(x[:3])
    geop_t, geop_j = torch.as_tensor(x[3]), jnp.asarray(x[3])
    Fa = tend.functional_derivatives(*xt, geop_t)
    jFa = jtend.functional_derivatives(*xj, geop_j)
    got = tsi._apply_symplectic_full(stub, xt, Fa[0], Fa[1], Fa[3], 5.0)
    ref = jsi._apply_symplectic_full(jstub, xj, jFa[0], jFa[1], jFa[3], 5.0)
    _close(ref, got, TOL, "apply_symplectic_full")
    assert len(stub.calls) == len(jstub.calls) == 1
    plain = tsi._apply_symplectic_full(SpamTendencies(**keep), xt, Fa[0],
                                       Fa[1], Fa[3], 5.0)
    _close([0.5 * plain[0], -plain[1], 2.0 * plain[2]], got, TOL, "hook")
    got = tsi.si_fixed_step(stub, *xt, geop_t, 0.5, 3)
    ref = jsi.si_fixed_step(jstub, *xj, geop_j, 0.5, 3)
    _close(ref, got, SI_TOL, "si_fixed_step")
    assert len(stub.calls) == len(jstub.calls) == 3


def test_si_fixed_step_projects_and_matches_jax(pairs):
    """si_fixed_step on the AN model (five evaluations, each projected)
    at 1e-10 of pam_tpu's; the new winds satisfy the constraint."""
    import pam_tpu.spam.si as jsi
    tend, jtend, x, _, _, _ = pairs("an")
    got = tsi.si_fixed_step(tend, *_t(x), 2.0)
    ref = jsi.si_fixed_step(jtend, *_j(x), 2.0)
    _close(ref, got, SI_TOL, "si_fixed_step")
    v, w = _t(x[1:3])
    scale0 = _constraint(tend, v, w)
    v, w = project_initial(tend.psolver, v, w)
    d, v, w = tsi.si_fixed_step(tend, torch.as_tensor(x[0]), v, w,
                                torch.as_tensor(x[3]), 2.0)
    assert _constraint(tend, v, w) < 1e-10 * scale0


# --------------------------------------------------------------- the runs
@pytest.fixture(scope="module")
def runs():
    """{name: (pam_tpu's final (dens, v, w), the port's, the port's
    setup)} of the AN_RUNS cuts, built on demand."""
    import pam_tpu.driver.standalone as jstandalone
    cache = {}

    def get(name):
        if name not in cache:
            cfg = golden.ideal_small_config(name)
            ref = jstandalone.run_idealized(dict(cfg), verbose=False)
            setup = tstandalone.idealized_setup(dict(cfg), "cpu")
            got = tstandalone.run_idealized(dict(cfg), verbose=False,
                                            device="cpu")
            cache[name] = ([np.asarray(a) for a in ref], got, setup)
        return cache[name]
    return get


@pytest.mark.parametrize("name", AN_RUNS)
def test_run_idealized_matches_jax(runs, name):
    """The 10-step AN and MAN cuts at 1e-9 of pam_tpu's run; rho stays
    the reference profile and the winds satisfy the constraint."""
    ref, got, (tend, _, x0, _, _, nsteps) = runs(name)
    assert nsteps == 10 and type(tend).__name__ == (
        "ManTendencies" if name.endswith("man") else "AnelasticTendencies")
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert _rel(r, g) < RUN_TOL, (name, field, _rel(r, g))
    assert float((got[0][0] - x0[0][0]).abs().max()) < \
        1e-12 * float(x0[0][0].abs().max())
    assert _constraint(tend, got[1], got[2]) < \
        1e-9 * float(got[1].abs().max())


@pytest.mark.parametrize("name", AN_RUNS)
def test_an_golden_file_is_current(runs, name):
    ref, got, _ = runs(name)
    gold = np.load(golden.ideal_path(name))
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert _rel(gold[field], r) < 1e-12, (name, field)
        assert _rel(gold[field], g) < RUN_TOL, (name, field)


def test_the_cut_keeps_the_configs_model():
    """What the cuts keep: input_risingbubble_an.yaml's hamil an, SSPRK3
    and 2 s step; the moist bubble with hamil man at its file's 1 s."""
    cfg = golden.ideal_small_config("risingbubble_an")
    assert cfg["hamil"] == "an" and cfg.get("tstype", "ssprk3") == "ssprk3"
    assert tstandalone.idealized_dt(cfg) == 2.0
    cfg = golden.ideal_small_config("moistrisingbubble_man")
    assert cfg["hamil"] == "man" and cfg["init_data"] == "moistrisingbubble"
    assert tstandalone.idealized_dt(cfg) == 1.0


@pytest.mark.parametrize("tstype", ("si_fixed", "si"))
def test_an_integrators_match_jax(tstype):
    """The AN model under the fixed-point SI (projected after each of its
    evaluations) and under the quasi-Newton SI with the velocity linear
    system, one step of 5 s at 1e-9 of pam_tpu's run."""
    import pam_tpu.driver.standalone as jstandalone
    cfg = golden.ideal_small_config("risingbubble_an", nsteps=1)
    cfg.update(tstype=tstype, dtcrm=5.0, sim_time=4.5)
    ref = jstandalone.run_idealized(dict(cfg), verbose=False)
    got = tstandalone.run_idealized(dict(cfg), verbose=False, device="cpu")
    for field, r, g in zip(("dens", "v", "w"), ref, got):
        assert _rel(r, g) < RUN_TOL, (tstype, field, _rel(r, g))


def test_refusals_match_jax():
    """hamil man on a dry case and hamil an on a case without a reference
    state raise ValueError in both packages."""
    import pam_tpu.driver.standalone as jstandalone
    dry = golden.ideal_small_config("risingbubble_an", nsteps=1)
    nores = golden.ideal_small_config("densitycurrent", nsteps=1)
    for cfg, why in ((dict(dry, hamil="man"), "moist init_data"),
                     (dict(nores, hamil="an"), "no reference state")):
        for run in (lambda c: jstandalone.run_idealized(c, verbose=False),
                    lambda c: tstandalone.run_idealized(c, verbose=False,
                                                        device="cpu")):
            with pytest.raises(ValueError, match=why):
                run(dict(cfg))


def test_anelastic_bubble_rises_beyond_acoustic_cfl():
    """(tests/test_anelastic.py) dt = 2 s, ~50x the compressible acoustic
    limit, 100 SSPRK3 steps at 32x24: the bubble rises, S is conserved
    to 1e-12, rho stays pinned and the winds satisfy the constraint."""
    cfg = dict(init_data="risingbubble", hamil="an", crm_nx=32, crm_nz=24,
               dtcrm=2.0, sim_time=199.0)
    tend, step, (d0, v, w), geop, dt, nsteps = \
        tstandalone.idealized_setup(cfg, "cpu")
    assert nsteps == 100
    d = d0
    for _ in range(nsteps):
        d, v, w = step(d, v, w)
    assert bool(torch.isfinite(d).all())
    s0 = float(d0[1].sum())
    assert abs(float(d[1].sum()) - s0) / s0 < 1e-12
    assert float((d[0] - d0[0]).abs().max()) < 1e-9
    assert _constraint(tend, v, w) < 1e-10
    g = tend.geom
    assert 0.3 < float(w.abs().max()) / float(g.dz_p.mean()) < 5.0
    q_pi = tend.ref_q_pi[1][0][:, None]
    zmid = 0.5 * (g.zint_d[0, 1:] + g.zint_d[0, :-1])
    com = []
    for dens in (d0, d):
        sp = torch.clamp(dens[1] / dens[0] - q_pi, min=0.0)[0].numpy()
        com.append((sp.sum(1) * zmid).sum() / sp.sum())
    assert com[1] > com[0] + 30.0


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_b1_at_an_shapes_matches_plain_on_card(dtype):
    """B1 at input_risingbubble_an.yaml's shapes (the two densities and
    the PV of 40x30 cells, one member) against the plain version at
    1e-12 (f64) / 2e-5 (f32), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    tb = weno.weno_tables(5, dtype)
    for shape in ((2, 1, 30, 40), (1, 29, 40)):
        f = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device="cuda")
        before = weno_x.weno_edges_x_cuda.launches
        got = weno_x.weno_edges_x(f, tb)
        torch.cuda.synchronize()
        assert weno_x.weno_edges_x_cuda.launches == before + 1
        ref = weno_x.weno_edges_x_reference(f, tb)
        _close(ref, got, 1e-12 if dtype == torch.float64 else 2e-5, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("hamil", ("an", "man"))
def test_anelastic_step_on_card_matches_cpu(hamil):
    """One SSPRK3 step of the AN / MAN model on the card (6 B1 launches)
    against the same step on the CPU, f64, at 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for device in ("cpu", "cuda"):
        tend, x, _, _ = an_case(device, hamil)
        x = [torch.as_tensor(a, device=device) for a in x]
        before = weno_x.weno_edges_x_cuda.launches
        out.append(tend.ssprk3_step(*x, 2.0))
        launched = weno_x.weno_edges_x_cuda.launches - before
        assert launched == (6 if device == "cuda" else 0)
    _close(out[0], out[1], TOL, "step")

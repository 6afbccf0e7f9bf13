"""The port's tridiagonal solves (pam_tpu_torch/ops/tridiag.py) against
pam_tpu's (pam_tpu/ops/tridiag.py), f64 on small shapes:

* ``pcr`` against pam_tpu's ``pcr``, real and complex, 64- and 32-bit,
  n of 12, 49 and 50, and L/D/U with a trailing dim of 1 against a
  stacked R (SHOC's layout): 1e-12 relative in 64-bit, 1e-5 in 32-bit
  (complex division may round otherwise in torch than in XLA);
* the port's PCR against its Thomas recurrences at tests/test_si.py's
  rtol 1e-10, atol 1e-12;
* ``use_pcr`` under each mode, and ``PAM_TRIDIAG`` read at import;
* the four call sites (the velocity SI system, the pressure systems
  through ``si._tridiag_real``, the anelastic projection, SHOC's
  implicit diffusion): on a tensor off the CPU they take PCR, on the CPU
  Thomas; on the PCR branch (``_TRIDIAG_MODE = "pcr"`` on both packages,
  as tests/test_shoc.py switches pam_tpu's) they match pam_tpu at 1e-12;
* the SPAM+SI Kessler and P3+SHOC trajectories under PCR against
  pam_tpu's (tests/golden/*_pcr*.npz, rebuilt here by
  tests/torch_jax_refs.py) at 1e-9 per field.

JAX is imported inside the tests and fixtures that use it, so the
``gpu`` cases run on the card without it:

    python -m pytest --noconftest -m gpu tests/test_torch_tridiag.py
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
from pam_tpu_torch.driver.mmf import setup_supercell_mmf as torch_setup
from pam_tpu_torch.ops import tridiag as ttri
from pam_tpu_torch.physics.sgs.shoc import main as tshoc
from pam_tpu_torch.spam import anelastic as tan, si as tsi

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_refs import (PCR_TRAJECTORIES, pcr_path,  # noqa: E402
                            pcr_trajectory, tridiag_mode)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TOL = {64: 1e-12, 32: 1e-5}
DTYPES = {"float64": (np.float64, 64), "float32": (np.float32, 32),
          "complex128": (np.complex128, 64), "complex64": (np.complex64, 32)}
KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0, dycore="spam")
PHYSICS = {"kessler_spam_si": dict(micro="kessler", sgs="none"),
           "p3_shoc_spam_si": dict(micro="p3", sgs="shoc")}


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                 1e-300)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def system(n, dtype, stacked=False, seed=0):
    """A seeded diagonally dominant system along axis 0 (L[0] = U[n-1] =
    0): (n, 3, 4) coefficients and rhs, or (n, 6, 1) coefficients against
    a stacked (n, 6, 5) rhs."""
    rng = np.random.default_rng(seed + n)
    cshape, rshape = ((n, 6, 1), (n, 6, 5)) if stacked else ((n, 3, 4),) * 2

    def draw(shape):
        a = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            a = a + 1j * rng.standard_normal(shape)
        return a

    L, U = draw(cshape), draw(cshape)
    L[0] = 0.0
    U[-1] = 0.0
    D = (3.0 + np.abs(L) + np.abs(U)) * np.exp(1j * rng.random(cshape)) \
        if np.issubdtype(dtype, np.complexfloating) else \
        3.0 + np.abs(L) + np.abs(U) + rng.random(cshape)
    return tuple(np.asarray(a, dtype) for a in (L, D, U, draw(rshape)))


# ------------------------------------------------------------ the solvers
@pytest.mark.parametrize("stacked", (False, True), ids=("plain", "stacked"))
@pytest.mark.parametrize("n", (12, 49, 50))
@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_pcr_matches_pam_tpu(dtype, n, stacked):
    import jax.numpy as jnp
    from pam_tpu.ops import tridiag as jtri
    npdt, bits = DTYPES[dtype]
    args = system(n, npdt, stacked)
    ref = jtri.pcr(*(jnp.asarray(a) for a in args))
    got = ttri.pcr(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.from_numpy(args[3]).dtype
    assert _rel(ref, got) < TOL[bits]


def _real_coefficients(n):
    """Real coefficients with a complex rhs, the pressure systems' case."""
    L, D, U, _ = system(n, np.float64)
    R = system(n, np.complex128, seed=1)[3]
    return L, D, U, R


# (name, the system, the Thomas recurrence the call site runs on the CPU)
THOMAS_CASES = {
    "real": (lambda n: system(n, np.float64), ttri.thomas),
    "complex": (lambda n: system(n, np.complex128), ttri.thomas),
    "real L/D/U, complex R": (_real_coefficients, ttri.thomas),
    "stacked (SHOC)": (lambda n: system(n, np.float64, stacked=True),
                       tshoc._thomas_batched)}


@pytest.mark.parametrize("n", (12, 49, 50))
@pytest.mark.parametrize("case", tuple(THOMAS_CASES))
def test_pcr_matches_thomas(case, n):
    make, thomas = THOMAS_CASES[case]
    L, D, U, R = (torch.from_numpy(a) for a in make(n))
    want = thomas(L, D, U, R)
    got = ttri.pcr(*(a.to(R.dtype) for a in (L, D, U)), R)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("mode,cpu,meta", [("auto", False, True),
                                           ("thomas", False, False),
                                           ("pcr", True, True)])
def test_use_pcr_by_mode_and_device(monkeypatch, mode, cpu, meta):
    """auto: PCR for a tensor off the CPU (a meta tensor stands in for a
    card's here), Thomas on the CPU; thomas and pcr: wherever it lies."""
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", mode)
    assert ttri.use_pcr(torch.zeros(3)) is cpu
    assert ttri.use_pcr(torch.zeros(3, device="meta")) is meta


@pytest.mark.parametrize("env", (None, "auto", "thomas", "pcr"))
def test_mode_is_read_from_the_environment(env):
    """PAM_TRIDIAG at import, auto where it is unset, as pam_tpu reads it."""
    e = {k: v for k, v in os.environ.items() if k != "PAM_TRIDIAG"}
    if env is not None:
        e["PAM_TRIDIAG"] = env
    out = subprocess.run(
        [sys.executable, "-c", "from pam_tpu_torch.ops import tridiag; "
         "print(tridiag._TRIDIAG_MODE)"], cwd=ROOT, env=e,
        capture_output=True, text=True, check=True).stdout.split()
    assert out == [env or "auto"]


# ---------------------------------------------------------- the call sites
def _call_sites(device):
    """{call site: a thunk that runs it} on seeded tensors on ``device``:
    the velocity system's complex solve, the pressure systems' real
    coefficients with a complex rhs, the anelastic solver's, SHOC's
    stacked solve."""
    n, nens, nx = 12, 2, 9
    L, D, U, _ = (torch.as_tensor(a, device=device)
                  for a in system(n, np.complex128))
    mv = lambda a: a.reshape(n, nens, -1)[..., :nx].movedim(0, 1)
    vel = types.SimpleNamespace(tri_l=mv(L), tri_d=mv(D), tri_u=mv(U))
    rl, rd, ru, rr = (torch.as_tensor(a, device=device).reshape(
        n, nens, -1).movedim(0, 1) for a in _real_coefficients(n))
    an = types.SimpleNamespace(tri_l=rl, tri_d=rd, tri_u=ru)
    sl, sd, su, sr = (torch.as_tensor(a, device=device)
                      for a in system(n, np.float64, stacked=True))
    return {
        "velocity": lambda: tsi.CompressibleVelocityLinearSystem._tridiag(
            vel, mv(L)),
        "pressure": lambda: tsi._tridiag_real(rl, rd, ru, rr),
        "anelastic": lambda: tan.AnelasticPressureSolver._tridiag(an, rr),
        "shoc": lambda: tshoc._solve_shared(su[..., 0], sl[..., 0],
                                            sd[..., 0], [sr[..., 0]],
                                            sr[..., 1:])}


def _spy(monkeypatch):
    """Record which solver each call site reaches."""
    taken = []

    def spy(name, fn):
        def run(*a):
            taken.append(name)
            return fn(*a)
        return run
    for mod, name, kind in ((tsi, "pcr", "pcr"), (tsi, "thomas", "thomas"),
                            (ttri, "pcr", "pcr"),
                            (tshoc, "_thomas_batched", "thomas")):
        monkeypatch.setattr(mod, name, spy(kind, getattr(mod, name)))
    return taken


@pytest.mark.parametrize("site", ("velocity", "pressure", "anelastic",
                                  "shoc"))
@pytest.mark.parametrize("device", ("cpu", "meta"))
def test_call_site_route_follows_the_device(monkeypatch, site, device):
    """With PAM_TRIDIAG at auto, a call site takes Thomas on a CPU tensor
    and PCR on a tensor off the CPU (meta here; the card in
    test_call_sites_take_pcr_on_card)."""
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", "auto")
    run = _call_sites(device)[site]
    taken = _spy(monkeypatch)
    run()
    assert taken == ["thomas" if device == "cpu" else "pcr"]


@pytest.fixture(scope="module")
def velocity_pair():
    """Both packages' SPAM+SI Kessler drivers at the golden size and a
    seeded right-hand side made from pam_tpu's start state."""
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
    jdrv, jstate = jax_setup(**KW, **PHYSICS["kessler_spam_si"],
                             dtype=jnp.float64)
    tdrv, _ = torch_setup(**KW, **PHYSICS["kessler_spam_si"],
                          dtype=torch.float64, device="cpu")
    dens, v, w = (np.asarray(a) for a in
                  jdrv.dycore.coupler_to_dynamics(jstate))
    rng = np.random.default_rng(4)
    x = (dens * 1e-3 * (1.0 + rng.standard_normal(dens.shape)),
         v * 1e-2 + rng.standard_normal(v.shape),
         w * 1e-2 + rng.standard_normal(w.shape))
    return jdrv.dycore.si_linsys, tdrv.dycore.si_linsys, x


def _pressure_pair(cls, ny, nx=8, nz=10, nens=2, dt=3.0):
    """Both packages' pressure system ``cls`` of the rising bubble, the
    slab (ny 1) or the 3-D layout."""
    import jax.numpy as jnp
    from pam_tpu.spam import geometry as jgeo, si as jsi, \
        testcases as jtcs, thermo as jthermo, varset as jvs
    from pam_tpu_torch.spam import geometry as tgeo, testcases as ttcs, \
        thermo as tthermo, varset as tvs
    out = []
    for geo, si, tcs, thermo, vs, dtype, dev in (
            (jgeo, jsi, jtcs, jthermo, jvs, jnp.float64, ()),
            (tgeo, tsi, ttcs, tthermo, tvs, torch.float64, ("cpu",))):
        tc = tcs.RisingBubble()
        zint = np.linspace(0.0, tc.Lz, nz + 1)
        G = geo.ExtrudedGeometry
        geom = G.build3d(nx, ny, zint, tc.Lx, 700.0, nens, dtype, *dev) \
            if ny > 1 else G.build(nx, zint, tc.Lx, nens, dtype, *dev)
        th = thermo.IdealGasPottemp()
        varset = vs.VariableSet(variant="CE", geom=geom, thermo=th)
        ref = si.build_reference_state(
            geom, th, varset, lambda z: tc.refrho_f(z, th),
            lambda z: tc.refentropicdensity_f(z, th),
            lambda z: np.asarray(tc.refnsq_f(z, th)), tc.g)
        out.append(getattr(si, cls).build(geom, th, varset, ref, dt))
    rng = np.random.default_rng(ny)
    h = (ny, nx) if ny > 1 else (nx,)
    x = (rng.standard_normal((2, nens, nz) + h),
         rng.standard_normal(((2,) if ny > 1 else ()) + (nens, nz) + h),
         rng.standard_normal((nens, nz - 1) + h))
    return out[0], out[1], x


def _anelastic_pair():
    """The anelastic solver of tests/torch_anelastic_case.py (the rising
    bubble at 40x30, the configs' grid), pam_tpu's ``_tridiag`` on the same
    coefficients, and a seeded complex rhs."""
    from pam_tpu.spam import anelastic as jan
    from torch_anelastic_case import an_case
    ps = an_case("cpu", "an", nx=40, nz=30)[0].psolver
    coef = types.SimpleNamespace(tri_l=_np(ps.tri_l), tri_d=_np(ps.tri_d),
                                 tri_u=_np(ps.tri_u))
    jps = types.SimpleNamespace(
        _tridiag=lambda r: jan.AnelasticPressureSolver._tridiag(coef, r))
    rng = np.random.default_rng(2)
    r = rng.standard_normal(ps.tri_d.shape) + \
        1j * rng.standard_normal(ps.tri_d.shape)
    return jps, ps, (r,)


def _shoc_pair():
    """SHOC's stacked solve of both packages on a seeded implicit
    diffusion matrix (tests/test_shoc.py's), three fields and three
    tracers."""
    from pam_tpu.physics.sgs.shoc import main as jshoc
    rng = np.random.default_rng(1)
    ncol, n = 65, 50
    du = -0.2 * rng.random((n, ncol))
    dl = -0.2 * rng.random((n, ncol))
    du[-1] = 0.0
    dl[0] = 0.0
    x = (du, dl, 1.0 - du - dl, rng.standard_normal((3, n, ncol)),
         rng.standard_normal((n, ncol, 3)))
    solve = lambda du, dl, d0, r, tr: jshoc._solve_shared(du, dl, d0,
                                                          list(r), tr)
    tsolve = lambda du, dl, d0, r, tr: tshoc._solve_shared(
        du, dl, d0, list(r.unbind(0)), tr)
    return (types.SimpleNamespace(solve=solve),
            types.SimpleNamespace(solve=tsolve), x)


SITES = {"velocity system": ("solve", None),
         "pressure system, slab": ("solve", ("CompressiblePressureLinearSystem",
                                             1)),
         "pressure-gravity system, 3-D": (
             "solve", ("CompressiblePressureGravityLinearSystem", 6)),
         "anelastic projection": ("_tridiag", None),
         "SHOC implicit diffusion": ("solve", None)}


@pytest.mark.parametrize("site", tuple(SITES))
def test_call_site_on_pcr_matches_pam_tpu(monkeypatch, velocity_pair, site):
    """Each call site with both packages on the PCR branch: pam_tpu's
    result at 1e-12 (SHOC's held at 1e-7 in tests/test_shoc.py; its
    systems here are solved as well as the others)."""
    import jax.numpy as jnp
    from pam_tpu.ops import tridiag as jtri
    monkeypatch.setattr(jtri, "_TRIDIAG_MODE", "pcr")
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", "pcr")
    method, pressure = SITES[site]
    if site == "velocity system":
        jl, tl, x = velocity_pair
    elif pressure is not None:
        jl, tl, x = _pressure_pair(*pressure)
    elif site == "anelastic projection":
        jl, tl, x = _anelastic_pair()
    else:
        jl, tl, x = _shoc_pair()
    ref = getattr(jl, method)(*(jnp.asarray(a) for a in x))
    got = getattr(tl, method)(*(torch.from_numpy(np.array(a)) for a in x))
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert _rel(r, _np(g)) < 1e-12, site


# ------------------------------------------------------- the trajectories
@pytest.fixture(scope="module")
def fresh_pcr_references():
    """pam_tpu's PCR trajectories, rebuilt (tests/torch_jax_refs.py)."""
    return {stem: pcr_trajectory(name, nsteps, opbyop)
            for name, nsteps, opbyop, stem in PCR_TRAJECTORIES}


@pytest.mark.parametrize("stem", [t[3] for t in PCR_TRAJECTORIES])
def test_pcr_reference_file_is_current(fresh_pcr_references, stem):
    """tests/golden/<stem>.npz is what pam_tpu computes on the PCR branch
    today, at 1e-12 per field (tests/test_torch_spam3d_runs.py's bar for a
    rebuilt trajectory)."""
    gold = np.load(pcr_path(stem))
    fresh = fresh_pcr_references[stem]
    assert sorted(gold.files) == sorted(fresh)
    for k in gold.files:
        assert _rel(gold[k], fresh[k]) < 1e-12, k


@pytest.mark.parametrize("name,nsteps,opbyop,stem", PCR_TRAJECTORIES)
def test_trajectory_on_pcr_matches_pam_tpu(monkeypatch, name, nsteps, opbyop,
                                           stem):
    """The port's driver on PCR from the golden start state, ``nsteps``
    steps: every field of pam_tpu's PCR run at 1e-9 (the Thomas files' bar
    in tests/test_torch_mmf.py)."""
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", "pcr")
    drv, _ = torch_setup(**KW, **PHYSICS[name], dtype=torch.float64,
                         device="cpu")
    state = state_from_numpy(dict(np.load(os.path.join(
        GOLDEN, f"{name}_init.npz"))), "cpu", torch.float64)
    for _ in range(nsteps):
        state = drv.crm_phys_step(state)
    out = state_to_numpy(state)
    gold = np.load(pcr_path(stem))
    for k in gold.files:
        assert _rel(gold[k], out[k]) < 1e-9, k


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("stacked", (False, True), ids=("plain", "stacked"))
@pytest.mark.parametrize("n", (12, 49, 50))
@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_pcr_on_card_matches_cpu(cuda, dtype, n, stacked):
    """PCR on the card against PCR on the CPU, 1e-12 (64-bit) / 1e-5."""
    npdt, bits = DTYPES[dtype]
    args = system(n, npdt, stacked)
    want = ttri.pcr(*(torch.from_numpy(a) for a in args))
    got = ttri.pcr(*(torch.from_numpy(a).to(cuda) for a in args))
    assert got.is_cuda
    assert _rel(want.numpy(), _np(got)) < TOL[bits]


@pytest.mark.gpu
@pytest.mark.parametrize("site", ("velocity", "pressure", "anelastic",
                                  "shoc"))
def test_call_sites_take_pcr_on_card(monkeypatch, cuda, site):
    """With PAM_TRIDIAG at auto every call site takes PCR on the card, and
    its result is the CPU's PCR at 1e-12."""
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", "auto")
    want = _call_sites("cpu")[site]
    run = _call_sites(cuda)[site]
    taken = _spy(monkeypatch)
    got = run()
    assert taken == ["pcr"]
    monkeypatch.setattr(ttri, "_TRIDIAG_MODE", "pcr")
    want = want()
    for r, g in zip(*(a if isinstance(a, list) else [a]
                      for a in (want, got))):
        assert g.is_cuda and _rel(_np(r), _np(g)) < 1e-12, site

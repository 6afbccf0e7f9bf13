"""The shallow-water layer models of the port (spam/layer.py and
driver/standalone.py::run_layer) against pam_tpu, f64, on the same seeded
numpy inputs:

* _edge_recon along x and along y at 1e-13 (B1's function; its plain
  version on the CPU);
* q0f0, functional_derivatives, recons, compute_rhs and statistics of the
  swe and tswe models at 1e-12, on the double vortex with seeded noise
  (16x12 cells, 2 members), and both test cases' initial states;
* run_layer on configs/input_doublevortex.yaml, its model tswe form and
  configs/input_bickleyjet.yaml, cut to 16x16 cells and 2 members
  (tools/make_torch_golden_init.py::AN_LAYER), at 1e-9 of pam_tpu's run
  and of the golden files;
* pam_tpu's conservation checks of tests/test_layer.py, mirrored on the
  port; main() on a layer file; the unknown model refused by both;
* on the card: B1 at the layer shapes, one layer step against the CPU.

JAX is imported inside the fixtures and tests that use it, so that the
card-side cases run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_layer.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from pam_tpu_torch.driver import standalone as tstandalone
from pam_tpu_torch.ops import weno, weno_x
from pam_tpu_torch.spam import layer as tlayer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
import make_torch_golden_init as golden  # noqa: E402

ROOT = os.path.dirname(HERE)
TOL = 1e-12
EDGE_TOL = 1e-13
RUN_TOL = 1e-9
LAYER_RUNS = ("doublevortex", "doublevortex_tswe", "bickleyjet")
FUNCTIONS = ("q0f0", "functional_derivatives", "recons", "compute_rhs",
             "statistics")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _rel(ref, got):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _close(ref, got, tol=TOL, name=""):
    """Every array of ``ref`` (array, tuple, list or dict) within tol of
    its largest |value| in ``got``."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), name
        for k in ref:
            _close(ref[k], got[k], tol, f"{name}.{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), name
        for i, (r, g) in enumerate(zip(ref, got)):
            _close(r, g, tol, f"{name}[{i}]")
    else:
        err = _rel(ref, got)
        assert err < tol, (name, err)


def _models(variant, nx=16, ny=12, nens=2, device="cpu"):
    """The port's and pam_tpu's LayerModel of the double vortex."""
    tc = tlayer.DoubleVortex()
    kw = dict(nx=nx, ny=ny, nens=nens, Lx=tc.Lx, Ly=tc.Ly, g=tc.g,
              variant=variant, ndens=2 if variant == "tswe" else 1)
    from pam_tpu.spam import layer as jlayer
    return (tlayer.LayerModel(**kw, dtype=torch.float64, device=device),
            jlayer.LayerModel(**kw), tc)


@pytest.fixture(scope="module")
def pairs():
    """{variant: (port's model, pam_tpu's, numpy (dens, v, hs, coriolis),
    numpy (q0, f0, F, he))}: the double vortex with seeded noise on h
    (and S), v and hs."""
    cache = {}

    def get(variant):
        if variant not in cache:
            m, jm, tc = _models(variant)
            dens, v, hs, cor = (_np(a) for a in
                                tlayer.setup_double_vortex(m, tc))
            rng = np.random.default_rng(7)
            dens = dens * (1.0 + 1e-2 * rng.standard_normal(dens.shape))
            v = v * (1.0 + 0.1 * rng.standard_normal(v.shape))
            hs = 0.05 * dens[0] * rng.random(hs.shape)
            x = (dens, v, hs, cor)
            F, _, he, _ = m.functional_derivatives(*_t((dens, v, hs)))
            q0, f0, _, _ = m.q0f0(*_t((dens, v, cor)))
            cache[variant] = (m, jm, x, tuple(_np(a) for a in
                                               (q0, f0, F, he)))
        return cache[variant]
    return get


def _t(x):
    return [torch.as_tensor(a) for a in x]


def _j(x):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in x]


# ------------------------------------------------------------ the modules
@pytest.mark.parametrize("axis", (-1, -2))
def test_edge_recon_matches_jax(axis):
    """Periodic WENO edge values along x (-1) and y (-2) at 1e-13 of
    pam_tpu's stencil rolls + weno_coefs_list."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    from pam_tpu.spam import layer as jlayer
    rng = np.random.default_rng(3)
    f = rng.standard_normal((3, 2, 12, 10))
    f[..., 4:7] += 2.0          # a jump, so that the limiter's weights move
    got = tlayer._edge_recon(torch.as_tensor(f), weno.weno_tables(5), axis)
    ref = jlayer._edge_recon(jnp.asarray(f), jweno.weno_tables(5), axis)
    _close(list(ref), list(got), EDGE_TOL, f"axis {axis}")


def test_shift_matches_jax():
    import jax.numpy as jnp
    from pam_tpu.spam import layer as jlayer
    a = np.arange(2 * 5 * 7.0).reshape(2, 5, 7)
    for dj, di in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, -1), (-1, 1)):
        np.testing.assert_array_equal(
            _np(tlayer.shift(torch.as_tensor(a), dj, di)),
            np.asarray(jlayer.shift(jnp.asarray(a), dj, di)))


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("variant", ("swe", "tswe"))
def test_layer_model_matches_jax(pairs, variant, fn):
    m, jm, (dens, v, hs, cor), (q0, f0, F, he) = pairs(variant)
    args = {"q0f0": (dens, v, cor),
            "functional_derivatives": (dens, v, hs),
            "recons": (dens, q0, f0, F, he),
            "compute_rhs": (dens, v, hs, cor),
            "statistics": (dens, v, hs, cor)}[fn]
    got = getattr(m, fn)(*_t(args))
    ref = getattr(jm, fn)(*_j(args))
    _close(ref, got, TOL, f"{variant}.{fn}")


@pytest.mark.parametrize("name", LAYER_RUNS)
def test_initial_states_equal_jax(name):
    """setup_double_vortex of both test cases, swe and tswe: the numpy
    quadratures cast once, equal to pam_tpu's."""
    import jax.numpy as jnp
    from pam_tpu.spam import layer as jlayer
    cfg = golden.ideal_small_config(name)
    m, _, _, _, _, _ = tstandalone.layer_setup(cfg, "cpu")
    tc = tlayer.LAYER_TESTCASES[cfg["init_data"]]()
    jtc = {"doublevortex": jlayer.DoubleVortex,
           "bickleyjet": jlayer.BickleyJet}[cfg["init_data"]]()
    jm = jlayer.LayerModel(nx=m.nx, ny=m.ny, nens=m.nens, Lx=m.Lx, Ly=m.Ly,
                           g=m.g, variant=m.variant, ndens=m.ndens,
                           dtype=jnp.float64)
    got = tlayer.setup_double_vortex(m, tc)
    ref = jlayer.setup_double_vortex(jm, jtc)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(_np(g), np.asarray(r))


# --------------------------------------------------------------- the runs
@pytest.fixture(scope="module")
def runs():
    """{name: (pam_tpu's final (dens, v), the port's)} of the LAYER_RUNS
    cuts, built on demand."""
    import pam_tpu.driver.standalone as jstandalone
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


@pytest.mark.parametrize("name", LAYER_RUNS)
def test_run_layer_matches_jax(runs, name):
    ref, got = runs(name)
    assert len(got) == 2
    for field, r, g in zip(("dens", "v"), ref, got):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert _rel(r, g) < RUN_TOL, (name, field, _rel(r, g))


@pytest.mark.parametrize("name", LAYER_RUNS)
def test_layer_golden_file_is_current(runs, name):
    ref, got = runs(name)
    gold = np.load(golden.ideal_path(name))
    assert set(gold.files) == {"dens", "v"}
    for field, r, g in zip(("dens", "v"), ref, got):
        assert _rel(gold[field], r) < 1e-12, (name, field)
        assert _rel(gold[field], g) < RUN_TOL, (name, field)


def test_the_cut_keeps_each_config_s_model():
    """The files' models, steps and dtype: doublevortex SWE at 120 s,
    its tswe form with two densities, bickleyjet SWE at 0.02 s, all f64;
    10 steps of the file's step."""
    for name, variant, dt in (("doublevortex", "swe", 120.0),
                              ("doublevortex_tswe", "tswe", 120.0),
                              ("bickleyjet", "swe", 0.02)):
        cfg = golden.ideal_small_config(name)
        m, _, (dens, _), _, got_dt, nsteps = tstandalone.layer_setup(cfg,
                                                                     "cpu")
        assert (m.variant, got_dt, nsteps, m.dtype) == \
            (variant, dt, 10, torch.float64)
        assert dens.shape == (m.ndens, 2, 16, 16)
    cfg = tstandalone.load_config(os.path.join(ROOT, "configs",
                                               "input_doublevortex.yaml"))
    m, _, _, _, _, nsteps = tstandalone.layer_setup(
        dict(cfg, crm_nx=8, crm_ny=8, f64=False), "cpu")
    assert m.dtype == torch.float32 and nsteps == 720


def test_unknown_model_is_refused_by_both():
    import pam_tpu.driver.standalone as jstandalone
    cfg = golden.ideal_small_config("bickleyjet", nsteps=1)
    cfg["model"] = "mlswe"
    for run in (lambda c: jstandalone.run_idealized(c, verbose=False),
                lambda c: tstandalone.run_idealized(c, verbose=False,
                                                    device="cpu")):
        with pytest.raises(ValueError, match="unknown layer model"):
            run(dict(cfg))
    with pytest.raises(ValueError, match="layer model"):
        tstandalone.idealized_setup(dict(cfg, model="swe"), "cpu")


# ------------------------------------------- tests/test_layer.py, mirrored
def _run(variant, ndens, nx=32, steps=50, dt=120.0):
    tc = tlayer.DoubleVortex()
    m = tlayer.LayerModel(nx=nx, ny=nx, nens=1, Lx=tc.Lx, Ly=tc.Ly, g=tc.g,
                          variant=variant, ndens=ndens, device="cpu")
    dens, v, hs, cor = tlayer.setup_double_vortex(m, tc)
    st0 = m.statistics(dens, v, hs, cor)
    d_, v_ = dens, v
    for _ in range(steps):
        d_, v_ = m.ssprk3_step(d_, v_, hs, cor, dt)
    st1 = m.statistics(d_, v_, hs, cor)
    return m, (dens, v), (d_, v_), st0, st1


def test_swe_conservation_and_stability():
    """Mass and circulation conserved to 1e-12, energy to 1e-6, the
    height within the H0 +- dh envelope."""
    m, x0, x1, st0, st1 = _run("swe", 1)
    assert abs(float(st1["mass"][0, 0] - st0["mass"][0, 0])) / \
        float(st0["mass"][0, 0]) < 1e-12
    assert abs(float(st1["pv"][0] - st0["pv"][0])) / \
        abs(float(st0["pv"][0])) < 1e-12
    assert abs(float(st1["E"][0] - st0["E"][0])) / \
        float(st0["E"][0]) < 1e-6
    h = m.H2bar(x1[0])[0, 0]
    assert bool(torch.isfinite(h).all())
    assert 500.0 < float(h.min()) and float(h.max()) < 1000.0


def test_swe_vortices_rotate():
    """The vortex pair stays coherent and keeps rotating: KE within 10%,
    the height field moved."""
    m, x0, x1, st0, st1 = _run("swe", 1, nx=48, steps=200)
    assert 0.9 < float(st1["KE"][0]) / float(st0["KE"][0]) < 1.1
    h0 = m.H2bar(x0[0])[0, 0]
    h1 = m.H2bar(x1[0])[0, 0]
    assert float((h1 - h0).abs().max()) > 1.0


def test_tswe_conservation():
    """Both densities (h and S) conserved to 1e-12, energy to 1e-6.
    (tests/test_layer.py indexes st["mass"], which is (ndens, nens), as
    [0, k]: with one member JAX clamps k = 1 to 0 and checks h twice;
    here [k, 0] checks h and S.)"""
    m, x0, x1, st0, st1 = _run("tswe", 2)
    assert st0["mass"].shape == (2, 1)
    for k in range(2):
        assert abs(float(st1["mass"][k, 0] - st0["mass"][k, 0])) / \
            abs(float(st0["mass"][k, 0])) < 1e-12
    assert abs(float(st1["E"][0] - st0["E"][0])) / \
        abs(float(st0["E"][0])) < 1e-6
    assert bool(torch.isfinite(x1[0]).all())


def test_main_runs_a_layer_file(tmp_path, monkeypatch, capsys):
    """python -m pam_tpu_torch.driver.standalone <layer config>: main()
    takes run_idealized, which runs run_layer and prints pam_tpu's
    statistics lines and Run Time:."""
    real = tstandalone.run_layer
    seen = []
    monkeypatch.setattr(tstandalone, "run_layer",
                        lambda c, verbose, device: seen.append(c) or
                        real(c, verbose, device="cpu"))
    cfg = golden.ideal_small_config("doublevortex", nsteps=4)
    cfg.update(crm_nx=8, crm_ny=8, nens=1, stat_freq=2 * cfg["dtcrm"])
    path = tmp_path / "dv.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    assert tstandalone.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert [c["init_data"] for c in seen] == ["doublevortex"]
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and " E=" in steps[0] and " mass=" in steps[0]
    assert "Run Time:" in out


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("axis", (-1, -2))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_b1_at_layer_shapes_matches_plain_on_card(axis, dtype):
    """B1 at the doublevortex shapes (the density, q0 and f0 stacked, 64x64
    cells, one member) along x and along y (on a view with y moved last),
    one launch, against the plain version at 1e-12 (f64) / 2e-5 (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    f = torch.as_tensor(rng.standard_normal((3, 1, 64, 64)), dtype=dtype,
                        device="cuda")
    tb = weno.weno_tables(5, dtype)
    before = weno_x.weno_edges_x_cuda.launches
    got = tlayer._edge_recon(f, tb, axis)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches == before + 1
    ref = weno_x.weno_edges_h_reference(f, tb, axis)
    _close(list(ref), list(got), 1e-12 if dtype == torch.float64 else 2e-5,
           f"axis {axis}")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("swe", "tswe"))
def test_layer_step_on_card_matches_cpu(variant):
    """One SSPRK3 step of the double vortex on the card (6 B1 launches)
    against the same step on the CPU, f64, at 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for device in ("cpu", "cuda"):
        tc = tlayer.DoubleVortex()
        m = tlayer.LayerModel(nx=32, ny=24, nens=2, Lx=tc.Lx, Ly=tc.Ly,
                              g=tc.g, variant=variant,
                              ndens=2 if variant == "tswe" else 1,
                              device=device)
        dens, v, hs, cor = tlayer.setup_double_vortex(m, tc)
        before = weno_x.weno_edges_x_cuda.launches
        out.append(m.ssprk3_step(dens, v, hs, cor, 120.0))
        launched = weno_x.weno_edges_x_cuda.launches - before
        assert launched == (6 if device == "cuda" else 0)
    _close([a for a in out[0]], [a.cpu() for a in out[1]], TOL, "step")

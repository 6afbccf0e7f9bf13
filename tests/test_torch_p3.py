"""P3 microphysics: the port (pam_tpu_torch.physics.p3) against pam_tpu on
the same numpy-seeded inputs, float64 on the CPU, and kernel B4
(csrc/p3_part2.cu) against its plain version on the card.

Tolerances, relative to each field's largest |value|:
* tables: exactly equal (the port's copy of the file has pam_tpu's
  sha256, and the same numpy code reads it);
* the lookups as gathers (``access_*_table_gather``, the arithmetic of
  csrc/p3_tables.cuh): 1e-13 against the port's and pam_tpu's hat-weight
  contractions (the same two nonzero terms per axis; a contraction may
  fuse its multiply-adds);
* part 2, its pointwise core (``_part2_core``) and its plain version
  (``p3_part2_reference``: table stage + core): 1e-12 against the JAX
  XLA path and against the Pallas kernel in interpret mode (both compute
  the same expressions; they differ only in rounding);
* whole steps (p3_main, sedimentation, P3Micro.timestep): 1e-11;
* the fused vs single-species sedimentation loops of the port: 1e-14, as
  tests/test_p3.py::test_combined_sedimentation_divergent_substeps holds
  pam_tpu's.

JAX is imported inside the tests that use it, so that the card-side case
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_p3.py
"""

import os

import numpy as np
import pytest
import torch

from pam_tpu_torch.ops import p3_part2
from pam_tpu_torch.physics.p3 import main as tmain
from pam_tpu_torch.physics.p3 import sedimentation as tsed
from pam_tpu_torch.physics.p3 import tables as ttbl

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_dict(d):
    import jax.numpy as jnp
    return {k: (tuple(jnp.asarray(_np(v)) for v in d[k]) if k == "inc"
                else jnp.asarray(_np(d[k]))) for k in d}


_outputs = p3_part2.outputs


# ---------------------------------------------------------------- tables
def test_tables_equal_pam_tpu():
    from pam_tpu.physics.p3 import tables as jtbl
    for a, b in zip(jtbl.load_ice_tables(), ttbl.load_ice_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jtbl.build_rain_tables(), ttbl.build_rain_tables()):
        np.testing.assert_array_equal(a, b)


def test_lookup_table_file_is_the_ports_own_copy():
    """The port reads no file of pam_tpu: TABLE_FILE lies inside
    pam_tpu_torch/ and is byte for byte pam_tpu's table."""
    import hashlib
    import pam_tpu_torch
    from pam_tpu.physics.p3 import tables as jtbl
    pkg = os.path.dirname(os.path.abspath(pam_tpu_torch.__file__))
    assert os.path.commonpath([pkg, str(ttbl.TABLE_FILE)]) == pkg
    assert os.path.realpath(ttbl.TABLE_FILE).startswith(
        os.path.realpath(pkg) + os.sep)
    sha = lambda f: hashlib.sha256(open(f, "rb").read()).hexdigest()
    assert sha(ttbl.TABLE_FILE) == sha(jtbl._TABLE_FILE)


def test_index_walks_and_interpolation_match_jax():
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import tables as jtbl
    rng = np.random.default_rng(5)
    n = 400
    qi = 10.0 ** rng.uniform(-10, -2.5, n)
    ni = 10.0 ** rng.uniform(2, 7, n)
    qm = qi * rng.random(n)
    rhop = rng.uniform(0.0, 1000.0, n)
    qr = np.where(rng.random(n) < 0.8, 10.0 ** rng.uniform(-12, -2, n), 0.0)
    nr = 10.0 ** rng.uniform(1, 6, n)
    lamr = 10.0 ** rng.uniform(2.5, 5.5, n)
    J, T = jnp.asarray, torch.as_tensor
    ja = jtbl.indices_1a(J(qi), J(ni), J(qm), J(rhop))
    ta = ttbl.indices_1a(T(qi), T(ni), T(qm), T(rhop))
    jb = jtbl.indices_1b(J(qr), J(nr))
    tb = ttbl.indices_1b(T(qr), T(nr))
    j3 = jtbl.indices_3(J(np.ones(n)), J(lamr))
    t3 = ttbl.indices_3(T(np.ones(n)), T(lamr))
    for a, b in zip(ja + jb + j3, ta + tb + t3):
        assert _rel(a, _np(b)) < 1e-13
    jice, jcoll = (J(a) for a in jtbl.load_ice_tables())
    tice, tcoll, vn, vm, revap = ttbl.device_tables(torch.device("cpu"),
                                                    torch.float64)
    ref = jtbl.access_ice_table_multi(jice, (0, 1, 6, 7), *ja[3:])
    got = ttbl.access_ice_table_multi(tice, (0, 1, 6, 7), *ta[3:])
    ref += jtbl.access_collect_table_multi(jcoll, (0, 1), ja[3], jb[1],
                                           ja[4], ja[5])
    got += ttbl.access_collect_table_multi(tcoll, (0, 1), ta[3], tb[1],
                                           ta[4], ta[5])
    rt = [J(a) for a in jtbl.build_rain_tables()]
    ref += jtbl.access_rain_table_multi(rt[:2], j3[2], j3[3])
    got += ttbl.access_rain_table_multi((vn, vm), t3[2], t3[3])
    ref += (jtbl.access_rain_table(rt[2], *j3),)
    got += (ttbl.access_rain_table(revap, *t3),)
    for a, b in zip(ref, got):
        assert _rel(a, _np(b)) < 1e-13


def test_murphy_koop_and_saturation_adjustment_match_jax():
    import jax.numpy as jnp
    from pam_tpu.modules import saturation as jsat
    from pam_tpu.physics.p3 import main as jmain
    from pam_tpu_torch.modules import saturation as tsat
    rng = np.random.default_rng(6)
    t = rng.uniform(190.0, 310.0, 300)
    p = rng.uniform(2e4, 1e5, 300)
    for ice in (False, True):
        assert _rel(jmain.qv_sat(jnp.asarray(t), jnp.asarray(p), ice),
                    _np(tmain.qv_sat(torch.as_tensor(t),
                                     torch.as_tensor(p), ice))) < 1e-14
    rho_d = rng.uniform(0.3, 1.2, 300)
    rho_v = rho_d * rng.uniform(0.0, 0.03, 300)
    rho_c = np.where(rng.random(300) < 0.5, rho_d * 1e-3 * rng.random(300),
                     0.0)
    args = (rho_d + rho_v, rho_d, rho_v, rho_c, t, 461.505, 1004.64, 1859.0,
            4188.0)
    ref = jsat.compute_adjusted_state(*(jnp.asarray(a) for a in args[:5]),
                                      *args[5:])
    got = tsat.compute_adjusted_state(*(torch.as_tensor(a)
                                        for a in args[:5]), *args[5:])
    for a, b in zip(ref, got):
        assert _rel(a, _np(b)) < 1e-13


# ------------------------------------------- the lookups as gathers (B4)
def _lookup_positions():
    """Zero-based fractional table positions (size, rime, density, rain
    size; rain-table size, mu): 300 seeded ones inside each axis, then
    its edges: 0, n - 1 exactly, integers, just under an integer, and
    position 0 of the rain-size axis (indices_1b's inactive branch)."""
    rng = np.random.default_rng(12)
    n = 300

    def axis(size):
        edges = [0.0, size - 1.0, 1.0, size - 2.0, size - 1.0 - 1e-13,
                 2.0 - 1e-13, 0.5, 0.0]
        return np.concatenate([rng.uniform(0.0, size - 1.0, n), edges])
    return tuple(axis(s) for s in (50, 4, 5, 30, 300, 10))


@pytest.mark.parametrize("table", ["ice", "collect", "rain"])
def test_gather_lookups_match_hat_contractions_and_jax(table):
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import tables as jtbl
    d1, d4, d5, d3, ri, rj = _lookup_positions()
    J, T = jnp.asarray, torch.as_tensor
    tice, tcoll, vn, vm, revap = ttbl.device_tables(torch.device("cpu"),
                                                    torch.float64)
    if table == "ice":
        jice = J(jtbl.load_ice_tables()[0])
        for idx in ((1, 2, 3, 4, 6, 7, 9), (1, 5, 6, 7, 8, 10, 11)):
            got = ttbl.access_ice_table_gather(tice, idx, T(d1), T(d4),
                                               T(d5))
            hat = ttbl.access_ice_table_multi(tice, idx, T(d1), T(d4), T(d5))
            ref = jtbl.access_ice_table_multi(jice, idx, J(d1), J(d4), J(d5))
            assert len(got) == len(idx)
            for g, h, r in zip(got, hat, ref):
                assert _rel(_np(h), _np(g)) < 1e-13
                assert _rel(r, _np(g)) < 1e-13
    elif table == "collect":
        jcoll = J(jtbl.load_ice_tables()[1])
        got = ttbl.access_collect_table_gather(tcoll, (0, 1), T(d1), T(d3),
                                               T(d4), T(d5))
        hat = ttbl.access_collect_table_multi(tcoll, (0, 1), T(d1), T(d3),
                                              T(d4), T(d5))
        ref = jtbl.access_collect_table_multi(jcoll, (0, 1), J(d1), J(d3),
                                              J(d4), J(d5))
        for g, h, r in zip(got, hat, ref):
            assert _rel(_np(h), _np(g)) < 1e-13
            assert _rel(r, _np(g)) < 1e-13
    else:
        rt = [J(a) for a in jtbl.build_rain_tables()]
        got = ttbl.access_rain_table_gather((vn, vm, revap), T(ri), T(rj))
        hat = ttbl.access_rain_table_multi((vn, vm, revap), T(ri), T(rj))
        ref = jtbl.access_rain_table_multi(rt, J(ri), J(rj))
        one = jtbl.access_rain_table(rt[2], None, None, J(ri), J(rj))
        assert _rel(one, _np(got[2])) < 1e-13
        for g, h, r in zip(got, hat, ref):
            assert _rel(_np(h), _np(g)) < 1e-13
            assert _rel(r, _np(g)) < 1e-13


def test_gather_lookups_at_the_index_walks_edges():
    """The walks' own edge cases through both forms: sizes that clamp at
    either end of the ice table, no rime and all rime, rime densities at
    the bounds and at the 650 kg/m3 kink, rain too sparse for the
    collection table (indices_1b inactive: position 0), and lamr on both
    branches of indices_3, at their joint (mean size 195e-6 m) and
    clamped at either end."""
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import tables as jtbl
    J, T = jnp.asarray, torch.as_tensor
    qi = np.array([1e-14, 1e-9, 1e-6, 1e-3, 5e-3, 1e-4, 1e-4, 1e-4])
    ni = np.array([1e9, 1e5, 1e4, 1e2, 1e-16, 1e5, 1e5, 1e5])
    qm = qi * np.array([0.0, 1.0, 0.5, 1.0 / 3.0, 2.0 / 3.0, 1.0, 0.0, 0.1])
    rhop = np.array([0.0, 50.0, 650.0, 900.0, 1200.0, 649.999, 650.001,
                     400.0])
    qr = np.array([0.0, 1e-15, 1e-14, 1e-9, 1e-4, 1e-2, 1e-6, 1e-6])
    nr = np.array([1e3, 1e3, 0.0, 1e2, 1e4, 1e-16, 1e9, 1e3])
    mean_size = np.array([1e-7, 5e-6, 1e-4, 195e-6, 195e-6 * (1 + 1e-15),
                          196e-6, 1e-3, 1e-1])
    lamr = 2.0 / mean_size
    ta = ttbl.indices_1a(T(qi), T(ni), T(qm), T(rhop))
    tb = ttbl.indices_1b(T(qr), T(nr))
    t3 = ttbl.indices_3(T(np.ones(8)), T(lamr))
    ja = jtbl.indices_1a(J(qi), J(ni), J(qm), J(rhop))
    jb = jtbl.indices_1b(J(qr), J(nr))
    j3 = jtbl.indices_3(J(np.ones(8)), J(lamr))
    # the corners the gather form finds are the walks' integer indices
    for n, k, x in ((50, ta[0], ta[3]), (4, ta[2], ta[4]), (5, ta[1], ta[5]),
                    (30, tb[0], tb[1]), (300, t3[0], t3[2]),
                    (10, t3[1], t3[3])):
        kc, w0, w1 = ttbl._corner(n, x)
        at_k = (kc == k) | ((kc == k - 1) & (w0 == 0.0))   # x = n - 1
        assert bool(at_k.all()), (n, k, kc)
        assert bool(((w0 >= 0) & (w1 >= 0) & (w0 + w1 == 1.0)).all())
    assert float(tb[1][0]) == 0.0 and float(tb[1][2]) == 0.0   # inactive
    assert float(t3[2].min()) == 0.0 and float(t3[2].max()) == 299.0
    jice, jcoll = (J(a) for a in jtbl.load_ice_tables())
    tice, tcoll, _, _, revap = ttbl.device_tables(torch.device("cpu"),
                                                  torch.float64)
    idx = (1, 2, 3, 4, 6, 7, 9)
    got = ttbl.access_ice_table_gather(tice, idx, *ta[3:])
    got += ttbl.access_collect_table_gather(tcoll, (0, 1), ta[3], tb[1],
                                            ta[4], ta[5])
    got += ttbl.access_rain_table_gather((revap,), t3[2], t3[3])
    ref = jtbl.access_ice_table_multi(jice, idx, *ja[3:])
    ref += jtbl.access_collect_table_multi(jcoll, (0, 1), ja[3], jb[1],
                                           ja[4], ja[5])
    ref += (jtbl.access_rain_table(J(jtbl.build_rain_tables()[2]), *j3),)
    for g, r in zip(got, ref):
        assert _rel(r, _np(g)) < 1e-13


# ------------------------------------------------------------ part 2 (B4)
@pytest.fixture(scope="module")
def part2_inputs():
    """Seeded (30, 8) float64 columns through the port's part 1; the same
    values as numpy for JAX."""
    return p3_part2.sample_inputs((30, 8), torch.float64, "cpu", seed=3)


@pytest.mark.parametrize("ccn_mode", ["prescribed", "const"])
def test_part2_core_matches_jax_xla(part2_inputs, ccn_mode):
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import main as jmain
    args = part2_inputs
    tv = tmain._part2_tables(args[11])
    o, d = tmain._part2_core(*args, tv, ccn_mode)
    jo, jd = jmain._part2_core(args[0], *(jnp.asarray(_np(a))
                                          for a in args[1:11]),
                               _jax_dict(args[11]), _jax_dict(tv), ccn_mode)
    got, ref = _outputs(o, d), _outputs(jo, jd)
    # every process of the chain is active somewhere in these inputs
    assert all(np.count_nonzero(_np(d[k])) > 20 for k in d)
    for k in ref:
        assert _rel(ref[k], _np(got[k])) < 1e-12, k


@pytest.mark.parametrize("present", [0.5, 0.02])
@pytest.mark.parametrize("ccn_mode", ["prescribed", "const"])
def test_part2_reference_matches_jax_part2(ccn_mode, present):
    """The kernel's plain version (table stage + core, what a CPU tensor
    gets from ``p3_part2``) against pam_tpu's whole part 2, with the
    species common and rare."""
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import main as jmain
    args = p3_part2.sample_inputs((30, 40), torch.float64, "cpu", seed=8,
                                  present=present)
    frac = float((args[11]["inc"][2] > 0).double().mean())
    assert abs(frac - present) < 0.25 * present + 0.01
    o, d = p3_part2.p3_part2(*args, ccn_mode=ccn_mode)
    o2, d2 = p3_part2.p3_part2_reference(*args, ccn_mode=ccn_mode)
    j = [jnp.asarray(_np(a)) for a in args[1:11]]
    jo, jd = jmain.p3_main_part2(args[0], *j[:8], None, None, j[8], j[9],
                                 _jax_dict(args[11]), ccn_mode=ccn_mode)
    got, same, ref = _outputs(o, d), _outputs(o2, d2), _outputs(jo, jd)
    assert sorted(got) == sorted(ref) and len(got) == p3_part2.N_OUT
    for k in ref:
        assert torch.equal(got[k], same[k]), k
        assert _rel(ref[k], _np(got[k])) < 1e-12, k
    assert float(o["mu_r"].min()) == float(o["mu_r"].max()) == 1.0


@pytest.mark.parametrize("present", [0.5, 0.02])
def test_part2_tables_gather_form_matches_contractions(present):
    """The table stage with its lookups as gathers (the kernel's stage A,
    in plain PyTorch) against the contractions the plain version uses:
    every table value, and part 2's results from either."""
    args = p3_part2.sample_inputs((30, 40), torch.float64, "cpu", seed=8,
                                  present=present)
    tv = tmain._part2_tables(args[11])
    tg = tmain._part2_tables(args[11], gather=True)
    assert sorted(tv) == sorted(tmain._PART2_TV_NAMES) == sorted(tg)
    used = sum(int(np.count_nonzero(_np(tv[k]))) for k in tv
               if k.startswith("tv_"))
    assert used > (200 if present == 0.5 else 5)
    for k in tv:
        assert _rel(_np(tv[k]), _np(tg[k])) < 1e-13, k
    got = _outputs(*tmain._part2_core(*args, tg))
    ref = _outputs(*tmain._part2_core(*args, tv))
    for k in ref:
        assert _rel(_np(ref[k]), _np(got[k])) < 1e-12, k


def test_part2_core_matches_pallas_kernel_interpret(part2_inputs):
    """The TPU kernel B4 itself, run by Pallas's interpreter on the CPU."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from pam_tpu.physics.p3 import main as jmain
    args = part2_inputs
    o, d = tmain.p3_main_part2(*args[:9], None, None, args[9], args[10],
                               args[11])
    assert len(args) == 12 and torch.equal(o["lamr"], tmain._part2_tables(
        args[11])["lamr"])
    j = [jnp.asarray(_np(a)) for a in args[1:11]]
    with pltpu.force_tpu_interpret_mode():
        jo, jd = jmain.p3_main_part2(args[0], *j[:8], None, None, j[8],
                                     j[9], _jax_dict(args[11]),
                                     use_pallas=True)
    got, ref = _outputs(o, d), _outputs(jo, jd)
    for k in ref:
        assert _rel(ref[k], _np(got[k])) < 1e-12, k


def test_part2_cuda_wrapper_refuses_cpu_tensors(part2_inputs):
    with pytest.raises(ValueError, match="CUDA"):
        p3_part2.p3_part2_cuda(*part2_inputs)
    with pytest.raises(ValueError, match="no route"):
        p3_part2.p3_part2(part2_inputs[0], part2_inputs[1].to("meta"),
                          *part2_inputs[2:])
    assert p3_part2.N_IN == 36 and p3_part2.N_OUT == 28
    assert p3_part2.N_TABLES == 4 and len(p3_part2._constants()) == 50
    tabs = p3_part2.kernel_tables(torch.device("cpu"), torch.float64)
    assert [t.numel() for t in tabs] == [12000, 60000, 3000, 7]
    assert all(t.is_contiguous() for t in tabs)
    np.testing.assert_allclose(
        _np(tabs[3]), [2.0, 24.0, 5040.0, np.log(24.0), np.log(5040.0),
                       np.log(273.15), np.tanh(0.0415 * (273.15 - 218.8))],
        rtol=1e-14)


def _beyond(ref, got, tol):
    """Points per field with |got - ref| > tol * max|ref|."""
    return {k: int(((ref[k] - got[k]).abs() >
                    tol * max(float(ref[k].abs().max()), 1e-300)).sum())
            for k in ref}


@pytest.mark.gpu
@pytest.mark.parametrize("present", [0.5, 0.02])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(50, 65, 128), (1000003,), (12, 16, 2)])
def test_cuda_kernel_matches_plain_version(dtype, shape, present):
    """On the card, with chip_smoke.py's tolerances: in f64 every field
    within 1e-12 of its largest |value|; in f32 the kernel and the plain
    version are held against the plain version in f64 at 1e-5, and the
    kernel may miss at no more points than 2x the plain version (+10):
    where a limiter drains a species to rounding noise, the final
    q < QSMALL clip goes either way in f32. With the species common
    (every warp mixed) and rare (most warps skip a process group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = p3_part2.cast_inputs(p3_part2.sample_inputs(
        shape, torch.float64, "cuda", seed=4, present=present), dtype)
    before = p3_part2.p3_part2_cuda.launches
    got = _outputs(*p3_part2.p3_part2_cuda(*args))
    torch.cuda.synchronize()
    assert p3_part2.p3_part2_cuda.launches == before + 1
    ref = _outputs(*p3_part2.p3_part2_reference(*args))
    if dtype == torch.float64:
        assert not any(_beyond(ref, got, 1e-12).values())
        return
    truth = _outputs(*p3_part2.p3_part2_reference(
        *p3_part2.cast_inputs(args, torch.float64)))
    truth = {k: v.to(dtype) for k, v in truth.items()}
    k_bad, p_bad = _beyond(truth, got, 1e-5), _beyond(truth, ref, 1e-5)
    for k in truth:
        assert k_bad[k] <= 2 * p_bad[k] + 10, (k, k_bad[k], p_bad[k])


# ------------------------------------------------------------ whole steps
def _column_inputs(ncol=3, nz=30, seed=0):
    """tests/test_p3.py's column case with seeded per-column scatter."""
    rng = np.random.default_rng(seed)
    zmid = np.linspace(14750, 250, nz)[:, None]
    T = np.maximum(300.0 - 6.5e-3 * zmid, 200.0) + rng.uniform(-1, 1,
                                                               (nz, ncol))
    p = 1e5 * np.exp(-zmid / 8500.0) * np.ones((nz, ncol))
    rho = p / (287.042 * T)
    dz = np.full((nz, ncol), 500.0)
    exner = (p / 1e5) ** (287.042 / 1004.64)
    s = rng.uniform(0.5, 1.5, (nz, ncol))
    qv = 0.017 * np.exp(-zmid / 2500.0) * s
    qc = np.where((zmid > 1000) & (zmid < 4000), 1.2e-3 * s, 0.0)
    qr = np.where(zmid < 2000, 4e-4 * s, 0.0)
    qi = np.where((zmid > 6000) & (zmid < 10000), 6e-4 * s, 0.0)
    ones = np.ones((nz, ncol))
    return dict(
        qc=qc, nc=1e8 / rho, qr=qr, nr=1e5 / rho, qv=qv, th=T / exner,
        qi=qi, qm=0.1 * qi, ni=1e5 / rho, bm=0.1 * qi / 400.0, pres=p, dz=dz,
        nc_nuceat_tend=0 * ones, ni_activated=0 * ones, inv_qc_relvar=ones,
        dt=60.0, dpres=rho * 9.80616 * dz, inv_exner=1.0 / exner,
        qv_prev=qv * 0.99, t_prev=T - 0.2, cld_frac_i=ones,
        cld_frac_l=ones, cld_frac_r=ones, nccn_prescribed=0 * ones)


def test_p3_main_matches_jax():
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import main as jmain
    kw = _column_inputs()
    js, jd = jmain.p3_main(**{k: v if k == "dt" else jnp.asarray(v)
                              for k, v in kw.items()})
    ts, td = tmain.p3_main(**{k: v if k == "dt" else torch.as_tensor(v)
                              for k, v in kw.items()})
    assert float(ts["precip_liq_surf"].min()) > 0
    for k in js:
        assert _rel(js[k], _np(ts[k])) < 1e-11, k
    for k in jd:
        assert _rel(jd[k], _np(td[k])) < 1e-11, k


def _sed_inputs(divergent):
    """tests/test_p3.py's sedimentation cases: unit cloud fractions, or
    the divergent-substep case (:237) with thin layers, dt 120 s and
    partial cloud fractions."""
    rng = np.random.default_rng(7 if divergent else 3)
    ncol, nz = 16, 40

    def f(s=1.0):
        return s * rng.random((nz, ncol))
    qc, nc, qr, nr = f(1e-3), f(1e8), f(4e-3), f(1e6)
    qi, ni, qm, bm = f(2e-3), f(1e5), f(5e-4), f(1e-6)
    rho = 1.2 + f(0.2)
    if divergent:
        cl, cr, ci = (0.3 + 0.7 * f() for _ in range(3))
    else:
        cl = cr = ci = np.ones((nz, ncol))
    acn, rhofacr, rhofaci = f(1e-2), 1.0 + f(0.3), 1.0 + f(0.3)
    inv_dz = 1.0 / ((20.0 + f(30.0)) if divergent else (200.0 + f(300.0)))
    dt = 120.0 if divergent else 20.0
    return (qc, nc, qr, nr, qi, ni, qm, bm, rho, 1.0 / rho, cl, cr, ci, acn,
            rhofacr, rhofaci, inv_dz), dt


@pytest.mark.parametrize("divergent", [False, True])
def test_sedimentation_matches_jax(divergent):
    import jax.numpy as jnp
    from pam_tpu.physics.p3 import sedimentation as jsed
    arrs, dt = _sed_inputs(divergent)
    ref = jsed.combined_sedimentation(*(jnp.asarray(a) for a in arrs), dt,
                                      do_predict_nc=True)
    t = [torch.as_tensor(a) for a in arrs]
    rounds = tsed.combined_sedimentation.rounds
    got = tsed.combined_sedimentation(*t, dt, do_predict_nc=True)
    assert tsed.combined_sedimentation.rounds > rounds + (2 if divergent
                                                          else 0)
    for a, b in zip(ref, got):
        assert _rel(a, _np(b)) < 1e-11
    # the single-species loops agree with the fused one (the divergent
    # case: species finish after different substep counts)
    (qc, nc, qr, nr, qi, ni, qm, bm, rho, inv_rho, cl, cr, ci, acn,
     rhofacr, rhofaci, inv_dz) = t
    sep = (tsed.cloud_sedimentation(qc, nc, rho, inv_rho, cl, acn, inv_dz,
                                    dt, do_predict_nc=True)
           + tsed.rain_sedimentation(qr, nr, rho, inv_rho, rhofacr, cr,
                                     inv_dz, dt)
           + tsed.ice_sedimentation(qi, ni, qm, bm, rho, inv_rho, rhofaci,
                                    ci, inv_dz, dt))
    for a, b in zip(sep, got):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-14, atol=0)
    jsep = jsed.rain_sedimentation(*(jnp.asarray(_np(a)) for a in
                                     (qr, nr, rho, inv_rho, rhofacr, cr,
                                      inv_dz)), dt)
    for a, b in zip(jsep, sep[3:6]):
        assert _rel(a, _np(b)) < 1e-11


@pytest.mark.parametrize("sgs_shoc", [True, False])
def test_p3micro_timestep_matches_jax(sgs_shoc):
    """P3Micro.timestep on the golden start state with cloud and rain
    seeded into it; without SHOC it runs the saturation adjustment."""
    import jax.numpy as jnp
    from pam_tpu.core import Coupler as JCoupler
    from pam_tpu.physics import p3 as jp3
    from pam_tpu_torch.core.coupler import Coupler as TCoupler
    from pam_tpu_torch.physics import p3 as tp3
    state = dict(np.load(os.path.join(GOLDEN, "p3_shoc_spam_si_init.npz")))
    rng = np.random.default_rng(9)
    rho = state["density_dry"]
    shape = rho.shape
    state["cloud_water"] = rho * np.where(rng.random(shape) < 0.4,
                                          2e-3 * rng.random(shape), 0.0)
    state["rain"] = rho * np.where(rng.random(shape) < 0.4,
                                   1e-3 * rng.random(shape), 0.0)
    state["ice"] = rho * np.where(rng.random(shape) < 0.3,
                                  1e-3 * rng.random(shape), 0.0)
    state["cloud_water_num"] = rho * 1e8
    state["rain_num"] = rho * 1e5
    state["ice_num"] = rho * 1e5
    state["water_vapor"] = state["water_vapor"] * rng.uniform(0.8, 1.3,
                                                              shape)
    dims = dict(nz=12, ny=1, nx=16, nens=2, xlen=32000.0, ylen=64000.0)
    jm = jp3.P3Micro(jp3.register(JCoupler(**dims, dtype=jnp.float64)),
                     sgs_shoc=sgs_shoc)
    tm = tp3.P3Micro(tp3.register(TCoupler(**dims, dtype=torch.float64,
                                           device=torch.device("cpu"))),
                     sgs_shoc=sgs_shoc)
    ref = jm.timestep({k: jnp.asarray(v) for k, v in state.items()}, 20.0)
    got = tm.timestep({k: torch.as_tensor(v) for k, v in state.items()},
                      20.0)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert _rel(ref[k], _np(got[k])) < 1e-11, k

"""Periodic-x WENO edge reconstruction: the port's plain version against
pam_tpu (the XLA path of spam/tendencies._edge_recon_x and both Pallas
kernels in interpret mode), and the CUDA kernel against the plain version
on the card.

Tolerance, relative to the largest |edge value|: 1e-12 in float64 and
2e-5 in float32. The Pallas kernels compute the coefficient form of the
limiter and the port the reassociated edge form (ops/weno.py:144-147),
and the CUDA kernel evaluates the limiter of csrc/weno5.cuh (constants
merged on the host, one reciprocal per normalisation, multiply-adds), so
the sides agree to rounding, not bitwise. ops/weno5.py::cell_limiter, the
numpy transcription of that header, is held against the plain version
and against pam_tpu here on the CPU at 1e-13 (float64).

JAX is imported inside the tests that use it, so that the card-side case
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_weno.py
"""

import re

import numpy as np
import pytest
import torch

from pam_tpu_torch import _cuda
from pam_tpu_torch.ops import recon_matrices as rm, weno, weno5, weno_x
from pam_tpu_torch.spam import tendencies as ttend

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 2e-5}
TDT = {"float64": torch.float64, "float32": torch.float32}


def _field(rows, nx, dtype, seed=0):
    """A rough field: smooth waves plus jumps, so the limiter's weights
    move away from their ideal values."""
    rng = np.random.default_rng(seed)
    x = np.arange(nx) / nx
    f = np.sin(2 * np.pi * (x[None, :] + rng.random((rows, 1))))
    f += np.where(rng.random((rows, nx)) < 0.15,
                  rng.standard_normal((rows, nx)), 0.0)
    return f.astype(dtype)


def _check(ref, got, dtype):
    for r, g in zip(ref, got):
        r, g = np.asarray(r), np.asarray(g)
        assert r.shape == g.shape
        scale = max(float(np.abs(r).max()), 1e-300)
        assert float(np.abs(r - g).max()) / scale < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_jax_edge_recon_x(dtype, nx):
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    from pam_tpu.spam import tendencies as jtend
    f = _field(37, nx, dtype)
    jt = jweno.weno_tables(5, dtype=jnp.dtype(dtype))
    ref = jtend._edge_recon_x(jnp.asarray(f), jt)
    tt = weno.weno_tables(5, TDT[dtype])
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f), tt)
    assert got[0].dtype == TDT[dtype]
    _check(ref, got, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_pallas_edge_recon_x_pallas(dtype, nx):
    """B1: pam_tpu/ops/weno_x_pallas.py on a periodically padded field."""
    import jax.numpy as jnp
    from pam_tpu.ops.weno_x_pallas import edge_recon_x_pallas
    f = _field(37, nx, dtype, seed=1)
    pad = np.concatenate([f[:, -2:], f, f[:, :2]], axis=-1)
    ref = edge_recon_x_pallas(jnp.asarray(pad), ord=5, interpret=True)
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f),
                                        weno.weno_tables(5, TDT[dtype]))
    _check(ref, got, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_pallas_weno_pallas(dtype, nx):
    """B2: pam_tpu/ops/weno_pallas.py (pads x and rows in its wrapper)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from pam_tpu.ops import weno_pallas
    f = _field(37, nx, dtype, seed=2).reshape(37, 1, nx)
    with pltpu.force_tpu_interpret_mode():
        ref = weno_pallas.edge_recon_x(jnp.asarray(f), ord=5)
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f),
                                        weno.weno_tables(5, TDT[dtype]))
    _check(ref, got, dtype)


@pytest.mark.parametrize("recon_type", ["cfv", "wenofunc"])
def test_tendencies_edge_recons_match_jax(recon_type):
    """The port's _edge_recon_x and _edge_recon_z (z stays plain torch on
    every device) against pam_tpu's, limited and centred (CFV)."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    from pam_tpu.spam import tendencies as jtend
    f = _field(3 * 2 * 9, 16, "float64", seed=3).reshape(3, 2, 9, 16)
    jt = jweno.weno_tables(5, dtype=jnp.float64)
    tt = weno.weno_tables(5, torch.float64)
    _check(jtend._edge_recon_x(jnp.asarray(f), jt, recon_type),
           ttend._edge_recon_x(torch.from_numpy(f), tt, recon_type),
           "float64")
    _check(jtend._edge_recon_z(jnp.asarray(f), jt, 5, recon_type),
           ttend._edge_recon_z(torch.from_numpy(f), tt, 5, recon_type),
           "float64")


def test_tendencies_route_cpu_tensor_to_plain_version():
    """On a CPU tensor the port's _edge_recon_x is the plain version,
    bit for bit, and launches no kernel."""
    f = torch.from_numpy(_field(3 * 2 * 5, 16, "float64").reshape(3, 2, 5,
                                                                  16))
    tb = weno.weno_tables(5, torch.float64)
    before = weno_x.weno_edges_x_cuda.launches
    got = ttend._edge_recon_x(f, tb)
    ref = weno_x.weno_edges_x_reference(f, tb)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert weno_x.weno_edges_x_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensor():
    f = torch.from_numpy(_field(4, 16, "float64"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        weno_x.weno_edges_x_cuda(f, weno.weno_tables(5, torch.float64))


def test_packed_tables_match_kernel_layout():
    """The kernels read weno5::NTAB = 87 constants in the order of
    csrc/weno5.cuh::Tables: the stencil matrices (bridge 25, wrl 27), the
    smoothness forms' 2 + 6 merged entries, g 5, idl 4, the map's 4 x 4,
    sigma, 1/3; the header and ops/weno5.py state the same sizes."""
    tb = weno.weno_tables(5, torch.float32)
    packed = weno5.prepare_tables(tb)
    assert packed.shape == (weno5.NTAB,) == (87,)
    assert packed.dtype == np.float64
    assert weno5.prepared_tables(tb) is weno5.prepared_tables(tb)
    np.testing.assert_array_equal(weno5.prepared_tables(tb), packed)
    assert packed[25] == tb[1][0, 0, 0] and packed[25 + 26] == tb[1][2, 2, 2]
    assert packed[-2] == np.float32(tb[6]) and packed[-1] == 1.0 / 3.0
    src = (_cuda.CSRC / "weno5.cuh").read_text()
    const = lambda name: eval(re.search(
        rf"constexpr int {name} = ([^;]+);", src).group(1),
        {"ORD": 5, "HS": 3, "NMAT": weno5.NMAT})
    assert const("NMAT") == weno5.NMAT == 52
    assert const("NTAB") == weno5.NTAB
    fields = re.search(r"struct Tables \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"T (\w+)", fields)
    assert names == [n for n, _ in (
        ("mat", 0), ("tvl", 0), ("tvh", 0), ("g", 0), ("idl", 0),
        ("map_a", 0), ("map_b", 0), ("map_c", 0), ("map_d", 0), ("sigma", 0),
        ("third", 0))] == list(weno5._split(packed))
    with pytest.raises(ValueError, match="order"):
        weno5.prepare_tables(weno.weno_tables(3, torch.float32))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_prepared_tables_match_numpy_formulas(dtype):
    """Every constant of csrc/weno5.cuh against its formula from
    weno.weno_tables(5, dtype): the bridge matrix reproduces (a_hi -
    sum_i idl_i a_lo_i) / idl_hi on random stencils, the merged triangles
    are M[c][d] + M[d][c] summed in the table's dtype with every skipped
    entry zero, g the monomials at +1/2 with those at -1/2 their
    alternating-sign mirror, the map's constants formed in double."""
    tb = weno.weno_tables(5, TDT[dtype])
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tb
    t = weno5._split(weno5.prepare_tables(tb))
    rng = np.random.default_rng(0)
    u = rng.standard_normal((5, 1000))
    s64, w64, i64 = (np.asarray(a, np.float64) for a in (s2c, wrl, idl))
    a_hi = s64 @ u
    a_lo = np.stack([np.einsum("sc,sn->cn", w64[i], u[i:i + 3])
                     for i in range(3)])
    want = a_hi.copy()
    want[:3] -= np.einsum("i,icn->cn", i64[:3], a_lo)
    want /= i64[3]
    got = t["mat"][:25].reshape(5, 5) @ u
    assert np.abs(got - want).max() < 1e-13 * np.abs(want).max()
    np.testing.assert_array_equal(t["mat"][25:].reshape(3, 3, 3), w64)
    for M, terms, vals in ((tvl, weno5.TVL_TERMS, t["tvl"]),
                           (tvh, weno5.TVH_TERMS, t["tvh"])):
        n = M.shape[0]
        merged = {(c, d): (M[c, c] if c == d else M[c, d] + M[d, c])
                  for c in range(n) for d in range(c, n)}
        assert [float(merged[k]) for k in terms] == list(vals)
        assert all(v == 0 for k, v in merged.items() if k not in terms)
        assert merged[terms[0]].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(t["g"], 0.5 ** np.arange(5))
    np.testing.assert_array_equal(c2g[:, 1], t["g"])
    np.testing.assert_array_equal(c2g[:, 0], (-1.0) ** np.arange(5) * t["g"])
    np.testing.assert_array_equal(t["idl"], i64)
    np.testing.assert_array_equal(t["map_a"], i64 + i64 ** 2)
    np.testing.assert_array_equal(t["map_b"], 3.0 * i64)
    np.testing.assert_array_equal(t["map_c"], i64 ** 2)
    np.testing.assert_array_equal(t["map_d"], 1.0 - 2.0 * i64)
    assert t["sigma"][0] == np.asarray(sigma, dtype) and t["third"][0] == 1 / 3
    # a form that couples coefficients the header skips is refused
    bad = np.array(tvl, copy=True)
    bad[1, 2] = 0.5
    with pytest.raises(ValueError, match="skips that term"):
        weno5.prepare_tables((s2c, wrl, tvh, bad, c2g, idl, sigma))


def _limiter_field(kind, dtype, seed):
    """Stencil data for the limiter: a rough field, the same on a large
    offset (theta-like: the candidates' differences cancel), tiny
    positive values (tracer-like), and a constant (every tv zero)."""
    f = _field(37, 65, "float64", seed)
    f = {"rough": f, "offset": 300.0 + 3.0 * f, "tiny": 1e-3 * np.abs(f),
         "constant": np.full_like(f, 2.5)}[kind]
    pad = np.concatenate([f[:, -2:], f, f[:, :2]], axis=-1).astype(dtype)
    return [np.ascontiguousarray(pad[:, s:s + 65]) for s in range(5)]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-13), ("float32", 2e-6)])
@pytest.mark.parametrize("kind", ["rough", "offset", "tiny", "constant"])
def test_cell_limiter_transcription_matches_plain_and_jax(kind, dtype, tol):
    """ops/weno5.py::cell_limiter + edges, csrc/weno5.cuh's order of
    operations in numpy (merged bridge matrix, one reciprocal per
    normalisation, both edges from one set of weights), against the
    port's weno_edges_list and pam_tpu's on the same stencils: 1e-13 of
    the largest edge value in float64 (2e-6 in float32), so the kernels'
    reordering stays far inside the card-side tolerance."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    u = _limiter_field(kind, dtype, seed=5)
    tb = weno.weno_tables(5, TDT[dtype])
    p = weno5.prepare_tables(tb).astype(dtype)
    a = weno5.cell_limiter(u, p)
    got = weno5.edges(a, p)
    assert got[0].dtype == np.dtype(dtype)
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tb
    ref = weno.weno_edges_list([torch.from_numpy(x) for x in u], s2c, wrl,
                               tvh, tvl, idl, sigma, c2g)
    js2c, jwrl, jtvh, jtvl, jc2g, jidl, jsigma = jweno.weno_tables(
        5, dtype=jnp.dtype(dtype))
    jref = jweno.weno_edges_list([jnp.asarray(x) for x in u], js2c, jwrl,
                                 jtvh, jtvl, jidl, jsigma, jc2g)
    for side in (ref, jref):
        for r, g in zip(side, got):
            r = np.asarray(r)
            assert np.abs(r - g).max() <= tol * np.abs(r).max()
    # one edge, selected: the upwind form of csrc/awfl_flux.cu
    upw = np.arange(65) % 2 == 0
    one = weno5.edge(a, p, upw)
    np.testing.assert_array_equal(one, np.where(upw, got[1], got[0]))


def test_cell_limiter_transcription_with_level_matrices():
    """The per-level form: ops/weno5.py::pack_matrices of a stretched
    grid's matrices through cell_limiter against weno_coefs_list with
    per-level tensors, 1e-13 of the largest coefficient."""
    nlev = 9
    dz = 300.0 * (1.0 + 0.35 * np.sin(np.arange(nlev - 2)))
    s2c, wrl = rm.vertical_recon_matrices(dz, 5)         # (nlev, 5, 5), ...
    tb = weno.weno_tables(5, torch.float64)
    p = weno5.prepare_tables(tb)
    rng = np.random.default_rng(7)
    u = [rng.standard_normal((nlev, 11)) + 2.0 for _ in range(5)]
    mat = np.moveaxis(weno5.pack_matrices(s2c, wrl, tb[5]), -1, 0)[..., None]
    assert mat.shape == (52, nlev, 1)
    got = weno5.cell_limiter(u, p, mat)
    lead = lambda a, k: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a, tuple(range(1, 1 + k)), tuple(range(k)))))[..., None]
    ref = weno.weno_coefs_list([torch.from_numpy(x) for x in u],
                               lead(s2c, 2), lead(wrl, 3), *tb[2:4], tb[5],
                               tb[6])
    scale = max(float(r.abs().max()) for r in ref)
    for r, g in zip(ref, got):
        assert np.abs(r.numpy() - g).max() < 1e-13 * scale
    # on a uniform grid the packed level matrices are the uniform tables'
    s2c_u, wrl_u = rm.vertical_recon_matrices(np.full(5, 400.0), 5)
    np.testing.assert_allclose(weno5.pack_matrices(s2c_u, wrl_u, tb[5])[3],
                               p[:52], rtol=0, atol=1e-14)


def test_weno_x_work_at_the_main_path_shape():
    """The yardstick stays the plain version's count whatever the kernel
    shares: (32000, 65) in float32 is 24.96 MB and 0.58 Gflop (277
    operations per cell)."""
    tb = weno.weno_tables(5, torch.float32)
    nbytes, flops = weno_x.weno_x_work(32000, 65, 4, tb)
    assert nbytes == 24_960_000
    assert flops == 32000 * 65 * 277 == 576_160_000
    assert weno_x.weno_x_work(32000, 65, 8, weno.weno_tables(
        5, torch.float64)) == (49_920_000, 576_160_000)


@pytest.mark.parametrize("rows,nx", [(32000, 65), (6272, 65), (37, 16),
                                     (9, 5), (7, 6), (3, 128), (5, 257),
                                     (2, 4604), (2, 5000), (1, 3)])
def test_tiling_fits_the_tile_and_fills_warps(rows, nx):
    """ops/weno_x.py::tiling: whole rows with their halos fit the
    kernel's tile, a row wider than the tile is cut into segments of one
    row per block, and among the row counts allowed none fills the
    block's last warp better."""
    rb, seg = weno_x.tiling(rows, nx)
    assert 1 <= rb <= max(1, min(rows, weno_x.MAX_ROWS))
    assert rb * (seg + 4) <= weno_x.TILE and 1 <= seg <= nx
    if nx + 4 > weno_x.TILE:
        assert (rb, seg) == (1, weno_x.TILE - 4)
    else:
        assert seg == nx
        use = lambda r: r * nx / (32 * -(-r * nx // 32))
        fit = min(weno_x.TILE // (nx + 4), weno_x.MAX_ROWS, rows)
        assert use(rb) == max(use(r) for r in range(1, fit + 1))
    src = (_cuda.CSRC / "weno_x.cu").read_text()
    assert f"constexpr int TILE = {weno_x.TILE};" in src


def test_build_key_changes_with_a_header(tmp_path):
    """_cuda.source_key hashes the source, every *.cuh beside it and the
    flags, so an edited csrc/weno5.cuh rebuilds both kernels that include
    it (no nvcc needed: the hash function alone, on a temporary csrc)."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "h.cuh").write_text("// one\n")
    a0, b0 = (_cuda.source_key(tmp_path / n) for n in ("a.cu", "b.cu"))
    assert a0 != b0 and a0 == _cuda.source_key(tmp_path / "a.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    a1, b1 = (_cuda.source_key(tmp_path / n) for n in ("a.cu", "b.cu"))
    assert a1 != a0 and b1 != b0
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _cuda.source_key(tmp_path / "a.cu") == a0
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _cuda.source_key(tmp_path / "a.cu") != a0
    # a source's own flags are part of its key
    assert "-fmad=false" in _cuda.SOURCE_FLAGS["p3_part2.cu"]
    assert "-fmad=false" not in _cuda.NVCC_FLAGS
    (tmp_path / "p3_part2.cu").write_text('#include "h.cuh"\n')
    with_flag = _cuda.source_key(tmp_path / "p3_part2.cu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_cuda, "SOURCE_FLAGS", {})
        assert _cuda.source_key(tmp_path / "p3_part2.cu") != with_flag
    # the package's own sources: the headers are hashed, and passed with -I
    assert sorted(f.name for f in _cuda.CSRC.glob("*.cuh")) == [
        "p3_tables.cuh", "weno5.cuh"]
    assert {s.name for s in _cuda._sources()} == {
        "awfl_flux.cu", "graph_while.cu", "p3_part2.cu", "weno_x.cu"}
    for name in ("awfl_flux.cu", "weno_x.cu"):
        assert '#include "weno5.cuh"' in (_cuda.CSRC / name).read_text()
    assert '#include "p3_tables.cuh"' in (
        _cuda.CSRC / "p3_part2.cu").read_text()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rows,nx", [(32000, 65), (6272, 65), (37, 16),
                                     (9, 5), (7, 6), (3, 128), (5, 257),
                                     (3, 5000), (1, 3)])
def test_cuda_kernel_matches_plain_version(dtype, rows, nx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.from_numpy(_field(rows, nx, dtype, seed=4)).cuda()
    tb = weno.weno_tables(5, TDT[dtype])
    before = weno_x.weno_edges_x_cuda.launches
    got = weno_x.weno_edges_x_cuda(f, tb)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches == before + 1
    ref = weno_x.weno_edges_x_reference(f, tb)
    _check([r.cpu() for r in ref], [g.cpu() for g in got], dtype)

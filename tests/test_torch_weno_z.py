"""Vertical WENO edge reconstruction of the SPAM slab
(``spam/tendencies.py::_edge_recon_z``): the packed per-level matrices
that ``csrc/weno_z.cu`` reads, the CPU route, the numpy transcription of
the kernel's arithmetic against the plain version on the CPU, and the
kernel against the plain version on the card.

Tolerance on the card, relative to the largest |edge value|, as B1's
(tests/test_torch_weno.py): 1e-12 in float64 and 2e-5 in float32. JAX is
not imported, so that the card-side cases run where it is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_weno_z.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pam_tpu_torch.driver import mmf
from pam_tpu_torch.driver.standalone import build_zint
from pam_tpu_torch.modules import gcm_forcing
from pam_tpu_torch.ops import recon_matrices as rm, weno, weno5, weno_z
from pam_tpu_torch.spam import tendencies as ttend
from pam_tpu_torch.spam.geometry import ExtrudedGeometry
from pam_tpu_torch.spam.operators import mirror_iface

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# the configs' vertical grid: 50 levels of build_zint over 20 km, whose
# first and last cells are half cells (not uniform: the per-level route)
ZINT = build_zint({"crm_nz": 50, "zlen": 20000.0})


def _tendencies(nens, dtype, device="cpu", zint=ZINT):
    g = ExtrudedGeometry.build(65, zint, 128000.0, nens, dtype, device)
    return ttend.SpamTendencies(geom=g, varset=None, thermo=None)


def _field(shape, dtype, device="cpu", seed=0):
    """A rough field: smooth waves along z plus jumps, so the limiter's
    weights move away from their ideal values."""
    rng = np.random.default_rng(seed)
    nz = shape[-2]
    z = np.arange(nz)[:, None] / nz
    f = np.sin(2 * np.pi * (z + rng.random(shape[:-2] + (1, shape[-1]))))
    f = f + np.where(rng.random(shape) < 0.15, rng.standard_normal(shape),
                     0.0)
    return torch.as_tensor(f, dtype=dtype, device=device)


def _check(ref, got, dtype, tol=None):
    for r, g in zip(ref, got):
        r, g = r.double().cpu(), g.double().cpu()
        assert r.shape == g.shape
        scale = max(float(r.abs().max()), 1e-300)
        assert float((r - g).abs().max()) / scale < (tol or TOL[dtype])


def _unpacked(per_level):
    """(members, nlev, NMAT) float64 from per-level tensors (5, 5, nens,
    nlev, 1) and (3, 3, 3, nens, nlev, 1): per level the bridge matrix
    that weno5.bridge_matrix merges from level_matrices' values, then
    wrl."""
    s2c, wrl = (t.double().numpy()[..., 0] for t in per_level)
    s2c = np.moveaxis(s2c, (0, 1), (2, 3))
    wrl = np.moveaxis(wrl, (0, 1, 2), (2, 3, 4))
    br = weno5.bridge_matrix(s2c, wrl, rm.weno_ideal_weights(5)[0])
    lead = br.shape[:2]
    return np.concatenate([br.reshape(lead + (25,)),
                           wrl.reshape(lead + (27,))], axis=-1)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["d", "q"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_packed_level_matrices_match_level_matrices_and_bridge(which, dtype):
    """At the configs' geometry (every member on one column) the packed
    matrices are one set, (1, nlev, 52): per level level_matrices' values
    with the bridge merged by weno5.bridge_matrix in float64, then rounded
    to the run's dtype."""
    tend = _tendencies(3, dtype)
    ref64 = _tendencies(3, torch.float64)
    nlev, dz = {"d": (50, "dz_d"), "q": (49, "dz_p")}[which]
    packed = ttend.packed_level_matrices(tend.geom, getattr(tend.geom, dz))
    assert tuple(packed.shape) == (1, nlev, weno_z.NMAT)
    assert packed.dtype == dtype and packed.is_contiguous()
    want = _unpacked(getattr(ref64, "per_level_" + which))
    for e in range(3):
        assert torch.equal(packed[0], torch.as_tensor(want[e]).to(dtype))


def test_packed_level_matrices_one_set_per_member_where_columns_differ():
    """Members on columns of their own get a set each, in member order."""
    zint = np.stack([ZINT, ZINT * 1.1, ZINT])
    tend = _tendencies(3, torch.float64, zint=zint)
    for which, nlev, dz in (("d", 50, "dz_d"), ("q", 49, "dz_p")):
        packed = ttend.packed_level_matrices(tend.geom,
                                             getattr(tend.geom, dz))
        assert tuple(packed.shape) == (3, nlev, weno_z.NMAT)
        want = _unpacked(getattr(tend, "per_level_" + which))
        assert torch.equal(packed, torch.as_tensor(want))
        assert torch.equal(packed[0], packed[2])
        assert not torch.equal(packed[0], packed[1])


def test_uniform_grid_packs_nothing():
    zint = np.linspace(0.0, 20000.0, 51)
    tend = _tendencies(2, torch.float64, zint=zint)
    assert tend.per_level_d is None and tend.packed_d is None
    assert tend.packed_q is None


def test_cpu_tendencies_carry_no_packed_matrices():
    """Only the CUDA route reads the packed form: on the CPU a stretched
    grid carries its per-level matrices alone."""
    tend = _tendencies(2, torch.float64)
    assert tend.per_level_d is not None and tend.per_level_q is not None
    assert tend.packed_d is None and tend.packed_q is None


@pytest.mark.parametrize("grid", ["uniform", "per_level"])
def test_tendencies_route_cpu_tensor_to_plain_version_in_z(grid):
    """On a CPU tensor the port's _edge_recon_z is weno_edges_list on the
    five stencil views, bit for bit, and launches no kernel."""
    tend = _tendencies(2, torch.float64)
    f = _field((3, 2, 54, 65), torch.float64, seed=1)
    tb = weno.weno_tables(5, torch.float64)
    pl = tend.per_level_d if grid == "per_level" else None
    before = weno_z.weno_edges_z_cuda.launches
    got = ttend._edge_recon_z(f, tb, 50, per_level=pl)
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tb
    if pl is not None:
        s2c, wrl = pl
    sten = [f[..., s:s + 50, :] for s in range(5)]
    ref = weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert weno_z.weno_edges_z_cuda.launches == before


def test_a_cpu_step_launches_no_z_kernel():
    """A SPAM+SI MMF step on CPU tensors over the stretched levels takes
    the plain route in z: the kernel's counter does not move."""
    drv, st = mmf.setup_supercell_mmf(
        nx=16, nz=12, nens=2, xlen=32000.0, dycore="spam", micro="kessler",
        zint=build_zint({"crm_nz": 12, "zlen": 20000.0}),
        dtype=torch.float64, device="cpu")
    assert drv.dycore.tend.per_level_d is not None
    st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st,
                                                    drv.dt_gcm)
    before = weno_z.weno_edges_z_cuda.launches
    drv._crm_phys_step_single(st)
    assert weno_z.weno_edges_z_cuda.launches == before


def test_weno_z_work_at_the_production_call():
    """The yardstick of the density call of production (12 densities x
    128 members, 50 levels padded to 54, nx 65, float32): 61.5 MB and
    1.38 Gflop, the plain version's 277 operations a cell."""
    tb = weno.weno_tables(5, torch.float32)
    nbytes, flops = weno_z.weno_z_work(1536, 50, 65, 4, tb)
    assert nbytes == 1536 * (54 + 2 * 50) * 65 * 4 == 61_501_440
    assert flops == 1536 * 50 * 65 * 277 == 1_382_784_000


def test_cuda_wrapper_refuses_cpu_tensor():
    f = _field((4, 14, 16), torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        weno_z.weno_edges_z_cuda(f, weno.weno_tables(5, torch.float64), 10)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("which", ["d", "q"])
def test_kernel_transcription_with_packed_matrices_matches_plain(which, dtype,
                                                                 tol):
    """The kernel's arithmetic at the configs' geometry: ops/weno5.py::
    cell_limiter and edges (csrc/weno5.cuh's order of operations in numpy)
    on the packed matrices, merged in float64 and rounded once, against
    the CPU route with the per-level tensors, both in the run's dtype:
    1e-13 of the largest edge value in float64 (2e-6 in float32), far
    inside the card-side tolerance."""
    tend = _tendencies(2, dtype)
    nlev, dz = {"d": (50, "dz_d"), "q": (49, "dz_p")}[which]
    f = _field((3, 2, nlev + 4, 65), dtype, seed=2)
    tb = weno.weno_tables(5, dtype)
    ref = ttend._edge_recon_z(f, tb, nlev,
                              per_level=getattr(tend, "per_level_" + which))
    p = weno5.prepare_tables(tb).astype(ref[0].numpy().dtype)
    packed = ttend.packed_level_matrices(tend.geom, getattr(tend.geom, dz))
    mat = np.moveaxis(packed.numpy()[0], -1, 0)
    u = [f[..., s:s + nlev, :].numpy() for s in range(5)]
    got = weno5.edges(weno5.cell_limiter(u, p, mat[..., None]), p)
    assert got[0].dtype == ref[0].numpy().dtype
    _check(ref, [torch.from_numpy(g) for g in got], dtype, tol)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# both cells' calls: densities (ndens * nens, nz + 4, nx) and PV (nens,
# nz + 3, nx), production in float32, Kessler in float64
SHAPES = {"production.dens": (12 * 128, 50, torch.float32),
          "production.pv": (128, 49, torch.float32),
          "kessler.dens": (5 * 128, 50, torch.float64),
          "kessler.pv": (128, 49, torch.float64)}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["uniform", "per_level"])
@pytest.mark.parametrize("call", list(SHAPES))
def test_cuda_kernel_matches_plain_version(call, grid):
    _cuda()
    rows, nlev, dtype = SHAPES[call]
    tend = _tendencies(128, dtype, "cuda")
    which = "d" if nlev == 50 else "q"
    pl, packed = ((getattr(tend, "per_level_" + which),
                   getattr(tend, "packed_" + which))
                  if grid == "per_level" else (None, None))
    f = _field((rows // 128, 128, nlev + 4, 65), dtype, "cuda", seed=3)
    tb = weno.weno_tables(5, dtype)
    before = weno_z.weno_edges_z_cuda.launches
    got = ttend._edge_recon_z(f, tb, nlev, per_level=pl, packed=packed)
    torch.cuda.synchronize()
    assert weno_z.weno_edges_z_cuda.launches == before + 1
    ref = weno_z.weno_edges_z_reference(f, tb, nlev, pl)
    _check(ref, got, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_on_strided_rows_and_member_sets(dtype):
    """The PV call's input, a z slice of a mirror-padded field (rows
    strided), and members on columns of their own (a matrix set each)."""
    _cuda()
    zint = np.stack([ZINT * (1.0 + 0.05 * e) for e in range(6)])
    tend = _tendencies(6, dtype, "cuda", zint=zint)
    assert tend.packed_q.shape[0] == 6
    qhz = _field((6, 51, 65), dtype, "cuda", seed=5)
    pad = mirror_iface(qhz, 2)[..., 1:50 + 4, :]
    assert not pad.is_contiguous()
    tb = weno.weno_tables(5, dtype)
    got = ttend._edge_recon_z(pad, tb, 49, per_level=tend.per_level_q,
                              packed=tend.packed_q)
    ref = weno_z.weno_edges_z_reference(pad, tb, 49, tend.per_level_q)
    _check(ref, got, dtype)
    with pytest.raises(ValueError, match="packed"):
        ttend._edge_recon_z(pad, tb, 49, per_level=tend.per_level_q)


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no result line in:\n{out[-2000:]}")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pamc_kessler.nens128",
                                  "production.nens512"])
def test_benchmark_cell_reads_correct(cell):
    """A short run of each benchmark cell (``benchmark/run.py``, 3 s)
    checks the steps it took against the plain float64 reference:
    ``correct`` is true, with the kernel on the dycore's path."""
    _cuda()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281829", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = _last_json(proc.stdout)
    assert result["correct"] is True, result

"""The port's sharding over torch.distributed, on ranks spawned on the CPU
with gloo, against pam_tpu's explicit sharding and the port's unsharded
steps (the cases of pam_tpu's tests/test_halo.py and tests/test_sharding.py
at their tolerances: bit for bit for the data movement and the sums of
integer-valued data, 1e-11 (rtol = atol) for the steps).

The rank workers are tests/torch_sharding_case.py (no JAX); each fixture
spawns one set of 8 ranks (``pam_tpu_torch.parallel.mesh.spawn_ranks``,
a rendezvous file under the test's temporary directory, a short time
limit) and every test reads its results. Run alone:

    python -m pytest tests/test_torch_sharding.py -q

The B1 padded-mode cases need the card, and the NCCL case four of them
(it skips on fewer):

    python -m pytest --noconftest -m gpu tests/test_torch_sharding.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from pam_tpu_torch.ops import weno, weno_x
from pam_tpu_torch.parallel import comm, mesh as tmesh
from pam_tpu_torch.parallel.sharded_step import ens_block, state_specs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharding_case as case  # noqa: E402

torch.set_num_threads(1)

WORLD = 8
EXACT = ("proll", "halo_pad", "psum_h", "pmean_h", "pmax_h", "pmin_h",
         "transpose_to_x_local", "local_ens_xblock", "local_xslice",
         "halo_pad_multihop", "proll_all_x", "proll_y", "psum_h_yx",
         "halo_pad_y_view")
# the transforms sum in another order than torch.fft (f64 rounding)
ROUNDED = ("transpose_round_trip", "fft_sh", "ifft_real_sh", "rfft_sh",
           "irfft_sh")


def _compare(ref, out, keys=case.KEYS):
    for k in keys:
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]),
                                   rtol=1e-11, atol=1e-11, err_msg=k)


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# fixtures: pam_tpu's run, the port's unsharded steps, the spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_kessler():
    """pam_tpu's SPAM+SI Kessler start state at 16x1x12 nens 8 and its
    explicit sharded step on mesh (ens 2, x 4), as numpy."""
    import jax
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    from pam_tpu.parallel.mesh import make_mesh
    from pam_tpu.parallel.sharded_step import sharded_crm_step
    drv, state = setup_supercell_mmf(**case.SMALL, micro="kessler",
                                     dycore="spam")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    step, place = sharded_crm_step(drv, make_mesh(n_ens_shards=2,
                                                  n_x_shards=4))
    out = step(place(state))
    jax.block_until_ready(out)
    return ({k: np.asarray(v) for k, v in state.items()},
            {k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def ranks(jax_kessler, tmp_path_factory):
    """Every sharded step of tests/torch_sharding_case.py::steps."""
    return tmesh.spawn_ranks(
        case.steps, WORLD, args=(jax_kessler[0],), timeout=480,
        rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


@pytest.fixture(scope="module")
def prims(tmp_path_factory):
    return tmesh.spawn_ranks(
        case.primitives, WORLD, timeout=240,
        rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


@pytest.fixture(scope="module")
def kessler(jax_kessler):
    """The port's driver and pam_tpu's start state on the CPU."""
    return case.setup(state=jax_kessler[0])


# ---------------------------------------------------------------------------
# the comm primitives (tests/test_halo.py's first cases and more)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", EXACT)
def test_primitive_is_bit_exact(prims, check):
    assert max(r["err"][check] for r in prims) == 0.0


@pytest.mark.parametrize("check", ROUNDED)
def test_transform_matches_whole_axis(prims, check):
    assert max(r["err"][check] for r in prims) < 1e-14


def test_primitive_counts(prims):
    """One p2p per ring shift, one all_reduce per reduction and per
    forward transform (re and im stacked), one all_to_all per
    transpose on mesh (2, 1, 4): 2 in the two shifts, 2 in halo_pad."""
    assert prims[0]["counts"] == {"p2p": 4, "all_reduce": 6,
                                  "all_gather": 0, "all_to_all": 2}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def test_crm_step_spam_si_matches_pam_tpu_sharded(ranks, jax_kessler):
    """mesh (2, 4), SPAM+SI Kessler: the port's gathered output against
    pam_tpu's shard_map step from the same start state."""
    _compare(jax_kessler[1], ranks[0]["out"]["spam_kessler"])


def test_crm_step_spam_si_matches_unsharded(ranks, kessler):
    drv, st = kessler
    _compare(_np(drv.crm_phys_step(st)), ranks[0]["out"]["spam_kessler"])


def test_crm_step_p3_shoc_matches_unsharded(ranks):
    drv, st = case.setup(micro="p3", sgs="shoc")
    _compare(_np(drv.crm_phys_step(st)), ranks[0]["out"]["p3_shoc"],
             keys=("temp", "water_vapor", "cloud_water", "rain", "ice",
                   "tke"))


def test_crm_step_awfl_matches_unsharded(ranks):
    """AWFL+Kessler on (2, 4): the sub-cycle count is the pmin_h over the
    x ranks, so every rank runs as many exchanges as the unsharded step
    runs sub-cycles."""
    from pam_tpu_torch.dycore.awfl import AwflDycore
    drv, st = case.setup(dycore="awfl")
    c0 = AwflDycore.timestep.cycles
    ref = drv.crm_phys_step(st)
    cycles = AwflDycore.timestep.cycles - c0
    _compare(_np(ref), ranks[0]["out"]["awfl"])
    assert {r["counts"]["awfl_cycles"] for r in ranks} == {cycles}


def test_dycore_step_matches_unsharded(ranks, kessler):
    """sharded_dycore_step on mesh (4, 2)."""
    drv, st = kessler
    _compare(_np(drv.dycore.timestep(st, 20.0)), ranks[0]["out"]["dycore"])


def test_rainsplit_min_spans_x_shards(ranks, kessler):
    """One rainy x column: a shard-local min would give the rainy and
    the dry shards different sub-step counts."""
    drv, st = kessler
    st = case.rain_in_x(st)
    assert float(st["precip_liquid"].max()) > 0
    _compare(_np(drv.crm_phys_step(st)), ranks[0]["out"]["rain_x"],
             keys=("temp", "water_vapor", "cloud_liquid", "precip_liquid",
                   "precl"))


def test_rainsplit_is_per_ensemble_block(ranks, jax_kessler):
    """Rain in the first half of the members only: each ensemble block
    takes its own rainsplit count (pam_tpu/physics/kessler.py:86-91), so
    the 2-way ensemble-sharded step equals two unsharded half-ensemble
    steps (pam_tpu holds it against ens_chunk, which the port has not)."""
    drv, st = case.setup(state=jax_kessler[0])
    st = case.rain_in_first_half(st)
    halves = []
    for lo in (0, 4):
        drv_h, _ = case.setup(nens=4)
        halves.append(drv_h.crm_phys_step(
            {k: v[lo:lo + 4] for k, v in st.items()}))
    ref = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    _compare(_np(ref), ranks[0]["out"]["rain_ens"],
             keys=("temp", "water_vapor", "cloud_liquid", "precip_liquid",
                   "precl"))


def test_ens_only_step_is_collective_free(ranks, kessler):
    """Ensemble sharding over 8 ranks makes no collective at all."""
    assert all(r["counts"]["ens_only"] == {"p2p": 0, "all_reduce": 0,
                                           "all_gather": 0, "all_to_all": 0}
               for r in ranks)
    drv, st = kessler
    _compare(_np(drv.crm_phys_step(st)), ranks[0]["out"]["ens_only"])


def test_x_sharded_step_collective_profile(ranks):
    """Only the collectives the port chose: point-to-point halos and
    all_reduces (the psum-DFT, the means and the rainsplit min), no
    all_gather and no all_to_all."""
    for r in ranks:
        c = r["counts"]["x4"]
        assert c["p2p"] > 0 and c["all_reduce"] > 0, c
        assert c["all_gather"] == 0 and c["all_to_all"] == 0, c


def test_collective_count_flat_in_shards(ranks):
    """The per-step count does not grow over 2, 4 and 8 x shards."""
    c = ranks[0]["counts"]
    for kind in ("p2p", "all_reduce", "all_gather", "all_to_all"):
        vals = [c[f"x{n}"][kind] for n in (2, 4, 8)]
        assert vals[0] >= vals[1] >= vals[2], (kind, vals)


def test_tendencies3d_compute_rhs_on_y2_x2(ranks):
    """Tendencies3D.compute_rhs on mesh (ens 2, y 2, x 2), B1's route
    along both axes, against the unsharded call."""
    from torch_spam3d_case import oracle_case_3d
    tend, x3, _ = oracle_case_3d("cpu", nx=8, ny=8, nz=6)
    ref = tend.compute_rhs(*[torch.as_tensor(a) for a in x3], 0.5)
    seen = set()
    for r in ranks:
        y, x = r["counts"]["coords"]
        seen.add((y, x))
        for got, want in zip(r["counts"]["compute_rhs"], ref):
            want = want.numpy()[..., 4 * y:4 * y + 4, 4 * x:4 * x + 4]
            np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_layer_compute_rhs_on_y2_x2(ranks):
    """The SWE layer model's tendencies (B1's route along x and y) on
    mesh (ens 2, y 2, x 2)."""
    m, x = case.layer_case()
    ref = m.compute_rhs(*x)
    for r in ranks:
        y, xc = r["counts"]["coords"]
        for got, want in zip(r["counts"]["layer_rhs"], ref):
            want = want.numpy()[..., 4 * y:4 * y + 4, 4 * xc:4 * xc + 4]
            np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("what", ["an_rhs", "an_project"])
def test_anelastic_on_x2(ranks, what):
    """The anelastic model's tendencies (with the pressure projection
    after the evaluation) and the projection alone, psum-DFT, on mesh
    (ens 4, x 2)."""
    from torch_anelastic_case import an_case
    tend, xa, _, _ = an_case("cpu", "an", nx=8)
    x = [torch.as_tensor(a) for a in xa]
    ref = (tend.compute_rhs(*x, 0.5) if what == "an_rhs"
           else tend.psolver.project(*x[1:3]))
    for r in ranks:
        xc = r["counts"]["x_coord42"]
        for got, want in zip(r["counts"][what], ref):
            want = want.numpy()[..., 4 * xc:4 * xc + 4]
            scale = max(float(np.abs(want).max()), 1.0)
            assert float(np.abs(got - want).max()) <= 1e-11 * scale


def test_coupled_3d_step_on_x2(ranks):
    """The coupled 3-D SPAM+Kessler step (pressure-gravity SI) on mesh
    (ens 4, x 2)."""
    drv, st = case.setup(nx=8, ny=4, nz=8, nens=4, xlen=16000.0,
                         ylen=8000.0, zlen=16000.0)
    _compare(_np(drv.crm_phys_step(st)), ranks[0]["out"]["spam3d_x2"],
             keys=case.KEYS + ("vvel",))


def test_explicit_3d_dycore_on_y2_x2(ranks):
    """The 3-D SPAM dycore without SI (SSPRK3) on mesh (ens 2, y 2, x 2):
    the wind conversions and Tendencies3D with both axes sharded."""
    drv, st = case.setup(nx=8, ny=4, nz=8, nens=4, xlen=16000.0,
                         ylen=8000.0, zlen=16000.0)
    ref = case.explicit_3d(drv.dycore).timestep(st, 20.0)
    _compare(_np(ref), ranks[0]["out"]["dycore3d_y2x2"],
             keys=case.KEYS + ("vvel",))


# ---------------------------------------------------------------------------
# refusals, in both packages
# ---------------------------------------------------------------------------

def test_port_refuses_exact_inverse_and_y_sharded_si(ranks):
    for r in ranks:
        c = r["counts"]
        assert "couple_wind_exact_inverse" in c["exact_inverse_refusal"]
        assert "y sharded" in c["y_si_refusal"]


def test_pam_tpu_refuses_exact_inverse_under_x_sharding():
    import jax.numpy as jnp
    from pam_tpu.parallel import comm as jcomm
    from pam_tpu.spam.dycore import exact_inverse_avg
    with jcomm.axis_ctx(x_axis="x"):
        with pytest.raises(NotImplementedError, match="x unsharded"):
            exact_inverse_avg(jnp.ones((2, 3, 5)))


def test_pam_tpu_cannot_run_a_y_sharded_si_step():
    """pam_tpu's explicit path has no y-sharded SI solve either: its
    coupled 3-D step on a (2, 2, 2) mesh with y manual fails (a
    global-y table meets a y block)."""
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    from pam_tpu.parallel.mesh import make_mesh
    from pam_tpu.parallel.sharded_step import sharded_crm_step
    drv, st = setup_supercell_mmf(nx=8, ny=4, nz=8, nens=4, xlen=16000.0,
                                  ylen=8000.0, zlen=16000.0, dt_gcm=80.0,
                                  dt_crm_phys=20.0, micro="kessler",
                                  dycore="spam")
    st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st, 80.0)
    step, place = sharded_crm_step(drv, make_mesh(n_ens_shards=2,
                                                  n_x_shards=2,
                                                  n_y_shards=2),
                                   y_axis="y")
    with pytest.raises(TypeError, match="incompatible shapes"):
        step(place(st))


# ---------------------------------------------------------------------------
# one process: the mesh, the blocks, the launcher
# ---------------------------------------------------------------------------

def test_one_rank_mesh_makes_no_process_group():
    import torch.distributed as dist
    m = tmesh.make_mesh(1, 1, 1, device="cpu")
    assert m.world == 1 and m.backend == "none" and not m.groups
    assert not dist.is_initialized()


def test_mesh_layout_is_row_major():
    m = tmesh.Mesh(2, 3, 4, rank=17, backend="gloo",
                   device=torch.device("cpu"))
    assert (m.e, m.y, m.x) == (1, 1, 1)
    assert m.rank_of(1, 1, 1) == 17
    assert m.rank_along("x", 3) == 19 and m.rank_along("y", 0) == 13
    assert m.rank_along("ens", 0) == 5


def test_shard_state_cuts_ens_y_x_blocks():
    st = {"a": torch.arange(4 * 2 * 4 * 6.0).reshape(4, 2, 4, 6),
          "s": torch.arange(4 * 4 * 6.0).reshape(4, 4, 6),
          "c": torch.arange(4 * 3.0).reshape(4, 3), "z": torch.tensor(1.0)}
    m = tmesh.Mesh(2, 2, 3, rank=7, backend="gloo",
                   device=torch.device("cpu"))
    blk = tmesh.shard_state(m, st)      # rank 7: e 1, y 0, x 1
    assert torch.equal(blk["a"], st["a"][2:4, :, 0:2, 2:4])
    assert torch.equal(blk["s"], st["s"][2:4, 0:2, 2:4])
    assert torch.equal(blk["c"], st["c"][2:4]) and blk["z"] == 1.0
    assert state_specs(st) == {"a": ("ens", None, None, "x"),
                               "s": ("ens", None, "x"),
                               "c": ("ens", None), "z": ()}
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_state(tmesh.Mesh(3, 1, 1, 0, "gloo",
                                     torch.device("cpu")), st)


def test_nccl_ranks_sharing_a_card_are_refused():
    with pytest.raises(ValueError, match="card of its own"):
        tmesh._backend_for(torch.device("cuda"), 4, "nccl")
    assert tmesh._backend_for(torch.device("cpu"), 4, None) == "gloo"


def test_ens_block_cuts_every_per_member_table():
    """Members 2-3 of a 4-member driver on a stretched grid (per-level
    matrices in every member) take the same step as the whole driver."""
    zint = np.concatenate([[0.0], np.cumsum(np.linspace(500, 2500, 12))])
    zint *= 20000.0 / zint[-1]
    for kw in (dict(zint=zint), dict(micro="p3", sgs="shoc"),
               dict(dycore="awfl"),
               dict(nx=8, ny=4, nz=8, xlen=16000.0, ylen=8000.0,
                    zlen=16000.0)):
        drv, st = case.setup(**dict(dict(nens=4), **kw))
        ref = drv.crm_phys_step(st)
        loc = ens_block(drv, 2, 2, 4)
        assert loc.coupler.nens == 2 and drv.coupler.nens == 4
        out = loc.crm_phys_step({k: v[2:4] for k, v in st.items()})
        for k in out:
            assert torch.equal(out[k], ref[k][2:4]), (kw.keys(), k)


def test_spawn_ranks_fails_fast_when_a_rank_raises(tmp_path):
    """A rank that raises while the others wait in a collective fails the
    call at once, and no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 of 4 failed"):
        tmesh.spawn_ranks(case.raise_on_rank_one, 4, timeout=60,
                          rendezvous_dir=str(tmp_path))


def test_padded_reference_equals_wrapping_reference():
    rng = np.random.default_rng(3)
    f = torch.as_tensor(rng.standard_normal((7, 9)))
    tb = weno.weno_tables(5, torch.float64)
    pad = comm.halo_pad(f, 2)
    for a, b in zip(weno_x.weno_edges_padded_reference(pad, tb),
                    weno_x.weno_edges_x_reference(f, tb)):
        assert torch.equal(a, b)
    rows, _ = weno_x.weno_x_work(7, 9, 8, tb, padded=True)
    assert rows == 7 * (13 + 18) * 8


# ---------------------------------------------------------------------------
# B1's padded mode on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (32000, 65) unsharded; the slab's rows at nx 64 over 2 x shards; the
# 3-D 32x32x50 over 4 shards (nens 4: 3 densities, 4 members, 50 levels,
# 32 y rows)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,nx", [(32000, 65), (5 * 8 * 50, 32),
                                     (3 * 4 * 50 * 32, 8), (9, 3)])
def test_padded_kernel_matches_plain_version(cuda, dtype, rows, nx):
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.standard_normal((rows, nx)) +
                        np.sign(rng.standard_normal((rows, nx))),
                        dtype=dtype, device=cuda)
    tb = weno.weno_tables(5, dtype)
    pad = comm.halo_pad(f, 2).contiguous()
    n0 = weno_x.weno_edges_x_cuda.launches_padded
    got = weno_x.weno_edges_x_cuda(pad, tb, padded=True)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches_padded == n0 + 1
    ref = weno_x.weno_edges_padded_reference(pad, tb)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= tol * scale
    # the wrapping mode reads the same values: the same bits
    for g, w in zip(got, weno_x.weno_edges_x_cuda(f, tb)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# NCCL: a rank on each of four cards
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_chip_phase_17_over_nccl_on_four_cards(cuda):
    """chip_smoke.py's phase 17 with a card for each rank: the mesh takes
    NCCL, and 17b-d hold as they do over host-staged gloo on one card
    (p2p pairs by order on two shards, all_reduce on the row groups,
    all_gather in gather_state)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices, one for each rank")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from pam_tpu_torch import _cuda
    from pam_tpu_torch.driver import standalone
    _cuda.library()
    got = chip_smoke.phase_17(standalone, weno, weno_x)
    assert got["backend"] == "nccl"
    assert got["weno_x"] > 0 and got["p3_part2"] > 0 and got["awfl_flux"] > 0

"""The port's ensemble micro-batching (driver/mmf.py: pick_ens_chunk, the
chunked routes of MmfDriver, run_mmf's ens_chunk) against pam_tpu's.

* pick_ens_chunk equals pam_tpu's over a grid of shapes, dtypes and
  totals;
* SPAM+SI Kessler at 8x1x12 (zlen 2 km, so that rain sub-cycles), nens 4
  as 2 chunks of 2, rain in the first chunk only, so the chunks take
  different rainsplit counts: the automatic route,
  crm_phys_step_microbatched, crm_phys_step_hostchunked and run in both
  mb_modes (one GCM step of 80 s) match pam_tpu's same routes within
  1e-12 of each field's scale (wvel's of the wind's, a forcing
  tendency's of its source's over dt_gcm: SOURCE), and equal each other
  bit for bit; the unchunked step differs in the rain (one global
  count); run takes a list of chunks over (run_mmf's hand-over) with the
  same result;
* chunks of one member equal a loop over the members;
* a non-multiple ensemble is refused with pam_tpu's message, and an
  unknown mb_mode by name;
* P3+SHOC stepped in chunks equals the whole-ensemble step within 1e-12
  (no coupling across members);
* run_mmf with ens_chunk 2 of nens 4 matches pam_tpu's run_mmf on the
  same file within 1e-10, and both write the same records of the full
  ensemble;
* on the card (``gpu``): the chunked route launches B1 and B4 once a
  chunk and matches the chunks stepped alone bit for bit.

JAX and pam_tpu are imported inside the tests that use them, so that the
card-side case runs without them:

    python -m pytest --noconftest -m gpu tests/test_torch_microbatch.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import pam_tpu_torch.driver.mmf as tmmf
import pam_tpu_torch.driver.standalone as tstandalone
from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
from pam_tpu_torch.modules import gcm_forcing as tforcing
from pam_tpu_torch.ops import p3_part2, weno_x
from pam_tpu_torch.physics import kessler as tkessler

torch.set_num_threads(1)

# 8x1x12 over 2 km: 167 m levels, so 4e-3 kg/kg of rain falls fast enough
# to sub-cycle a 20 s step (over 20 km no rain does)
KW = dict(nx=8, ny=1, nz=12, xlen=16000.0, ylen=64000.0, zlen=2000.0,
          micro="kessler", dt_gcm=80.0, dt_crm_phys=20.0, dycore="spam")
NENS, CHUNK = 4, 2
ROUTES = ("auto", "microbatched", "hostchunked", "run_host",
          "run_unrolled")
TOL = 1e-12


def _rel(a, b, scale=0.0):
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), scale,
                                            1e-300)


# the field whose scale bounds another's: wvel carries the rounding of the
# wind; a forcing tendency, (gcm - mean(crm)) / dt_gcm, that of its
# source's mean over dt_gcm (the temperature, the wind, or the dry
# density for the densities and mixing ratios; most tendencies here are
# differences of equal columns, ~1e-18 or less)
SOURCE = {"wvel": "uvel", "gcm_forcing_tend_temp": "temp",
          "gcm_forcing_tend_uvel": "uvel", "gcm_forcing_tend_vvel": "uvel"}


def _err(k, a, b, start):
    """Field k's error relative to its own scale, or to that of the field
    it derives from (SOURCE) in the start state, if larger."""
    src = SOURCE.get(k, "density_dry" if k.startswith("gcm_forcing_tend_")
                     else None)
    scale = 0.0 if src is None else float(np.abs(start[src]).max())
    if k.startswith("gcm_forcing_tend_"):
        scale /= KW["dt_gcm"]
    return _rel(a, b, scale)


def rain_in_first_chunk(state, xp):
    """Heavy rain in one x column of levels 2-7 of the first chunk's
    members, light rain there in the others'."""
    rho = np.asarray(state["density_dry"])
    pr = np.zeros(rho.shape)
    pr[:CHUNK, 2:8, :, 3] = 4e-3 * rho[:CHUNK, 2:8, :, 3]
    pr[CHUNK:, 2:8, :, 3] = 1e-4 * rho[CHUNK:, 2:8, :, 3]
    return dict(state, precip_liquid=xp(pr))


@pytest.fixture(scope="module")
def jax_routes():
    """pam_tpu's start state (nens 4, forced, rain in the first chunk) and
    its chunk driver's routes from it, as numpy."""
    import jax
    import jax.numpy as jnp
    import pam_tpu.driver.mmf as jmmf
    from pam_tpu.modules import gcm_forcing as jforcing
    jchunk, _ = jmmf.setup_supercell_mmf(nens=CHUNK, **KW)
    jfull, js = jmmf.setup_supercell_mmf(nens=NENS, **KW)
    js = jforcing.compute_gcm_forcing_tendencies(jfull.coupler, js,
                                                 jfull.dt_gcm)
    js = rain_in_first_chunk(js, jnp.asarray)
    out = {
        "auto": jax.jit(jchunk.crm_phys_step)(js),
        "microbatched": jax.jit(
            lambda s: jchunk.crm_phys_step_microbatched(s, NENS // CHUNK))(
                js),
        "hostchunked": jchunk.crm_phys_step_hostchunked(js),
        "run_host": jchunk.run(js, KW["dt_gcm"]),
        "run_unrolled": dataclasses.replace(jchunk, mb_mode="unrolled").run(
            js, KW["dt_gcm"]),
    }
    return ({k: np.asarray(v) for k, v in js.items()},
            {r: {k: np.asarray(v) for k, v in s.items()}
             for r, s in out.items()}, jchunk)


@pytest.fixture(scope="module")
def torch_case(jax_routes):
    """The port's chunk driver and pam_tpu's start state."""
    drv, _ = tmmf.setup_supercell_mmf(nens=CHUNK, **KW, dtype=torch.float64,
                                      device="cpu")
    return drv, state_from_numpy(jax_routes[0], "cpu", torch.float64)


def torch_route(drv, state, route):
    if route == "auto":
        return drv.crm_phys_step(state)
    if route == "microbatched":
        return drv.crm_phys_step_microbatched(state, NENS // CHUNK)
    if route == "hostchunked":
        return drv.crm_phys_step_hostchunked(state)
    mode = route[len("run_"):]
    return dataclasses.replace(drv, mb_mode=mode).run(state, KW["dt_gcm"])


@pytest.fixture(scope="module")
def torch_routes(torch_case):
    drv, st = torch_case
    return {r: state_to_numpy(torch_route(drv, st, r)) for r in ROUTES}


# ---------------------------------------------------------------------------
# pick_ens_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grid", [(65, 1, 50), (16, 1, 12), (8, 1, 12),
                                  (32, 32, 50), (100, 1, 75), (7, 3, 5),
                                  (1, 1, 1), (513, 1, 100)])
def test_pick_ens_chunk_matches_pam_tpu(grid, dtype):
    import jax.numpy as jnp
    import pam_tpu.driver.mmf as jmmf
    for total in (None, 1, 2, 3, 6, 12, 96, 100, 127, 128, 384, 512, 1000,
                  1024, 4096, 8192, 10000):
        want = jmmf.pick_ens_chunk(*grid, getattr(jnp, dtype), total)
        got = tmmf.pick_ens_chunk(*grid, getattr(torch, dtype), total)
        assert got == want, (grid, dtype, total)
        if total is not None:
            assert total % got == 0


def test_pick_ens_chunk_of_the_bench_rows():
    """bench.py's rows 2-4 (65x1x50 f32 at 512 and 1024 members) take
    chunks of 128; the production config in f32 too."""
    assert tmmf.pick_ens_chunk(65, 1, 50, torch.float32, 512) == 128
    assert tmmf.pick_ens_chunk(65, 1, 50, torch.float32, 1024) == 128
    assert tmmf.pick_ens_chunk(65, 1, 50, torch.float64, 512) == 64


# ---------------------------------------------------------------------------
# the chunked routes, Kessler with chunk-local rainsplit counts
# ---------------------------------------------------------------------------

def test_chunks_take_different_rainsplit_counts(torch_case):
    drv, st = torch_case
    counts = []
    for c in tmmf._split_ens(st, NENS // CHUNK):
        drv.crm_phys_step(c)
        counts.append(tkessler.kessler_column.rainsplit)
    assert counts[0] > 1 and counts[1] == 1, counts


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_pam_tpu(jax_routes, torch_routes, route):
    start, ref, got = jax_routes[0], jax_routes[1][route], torch_routes[route]
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].shape == got[k].shape, k
        err = _err(k, ref[k], got[k], start)
        assert err < TOL, (k, err)


def test_routes_agree_bit_for_bit(torch_routes, torch_case):
    """The single-step routes equal each other and the chunks stepped
    alone by the chunk driver; run's two modes equal each other and the
    chunks run alone."""
    drv, st = torch_case
    chunks = tmmf._split_ens(st, NENS // CHUNK)
    alone = tmmf._join_ens([drv.crm_phys_step(c) for c in chunks])
    run_alone = tmmf._join_ens([drv.run(c, KW["dt_gcm"]) for c in chunks])
    for route, ref in (("auto", alone), ("microbatched", alone),
                       ("hostchunked", alone), ("run_host", run_alone),
                       ("run_unrolled", run_alone)):
        for k, v in ref.items():
            assert np.array_equal(torch_routes[route][k], v.numpy()), \
                (route, k)


def test_unchunked_step_differs_in_the_rain(torch_case, torch_routes):
    """The whole ensemble in one step takes the first chunk's rainsplit
    count for every member: the second chunk's rain differs."""
    _, st = torch_case
    whole, _ = tmmf.setup_supercell_mmf(nens=NENS, **KW,
                                        dtype=torch.float64, device="cpu")
    got = state_to_numpy(whole.crm_phys_step(st))
    chunked = torch_routes["auto"]
    assert _rel(chunked["precip_liquid"], got["precip_liquid"]) > 1e-10
    # the first chunk takes the global count either way
    np.testing.assert_allclose(got["precip_liquid"][:CHUNK],
                               chunked["precip_liquid"][:CHUNK],
                               rtol=1e-13, atol=0)


def test_split_chunks_are_dense_copies(torch_case):
    """An in-place write to a chunk leaves the state and the other chunk
    as they were."""
    _, st = torch_case
    before = {k: v.clone() for k, v in st.items()}
    chunks = tmmf._split_ens(st, NENS // CHUNK)
    for c in chunks:
        for k, v in c.items():
            assert v.is_contiguous() and v.shape[0] == CHUNK, k
    chunks[0]["temp"].add_(1.0)
    assert torch.equal(st["temp"], before["temp"])
    assert torch.equal(chunks[1]["temp"], before["temp"][CHUNK:])
    joined = tmmf._join_ens(tmmf._split_ens(st, NENS // CHUNK))
    assert all(torch.equal(joined[k], v) for k, v in st.items())


def test_chunks_of_one_equal_a_loop_over_members(torch_case):
    _, st = torch_case
    one, _ = tmmf.setup_supercell_mmf(nens=1, **KW, dtype=torch.float64,
                                      device="cpu")
    got = one.crm_phys_step_microbatched(st, NENS)
    loop = [one.crm_phys_step({k: v[i:i + 1] for k, v in st.items()})
            for i in range(NENS)]
    for k, v in got.items():
        assert torch.equal(v, torch.cat([s[k] for s in loop])), k


@pytest.mark.parametrize("mode", ["host", "unrolled"])
def test_run_takes_a_list_of_chunks_over(torch_routes, torch_case, mode):
    """run on a list of driver-sized chunks equals run on the state bit
    for bit; "host" empties the chunks into its result."""
    drv, st = torch_case
    chunks = list(tmmf._split_ens(st, NENS // CHUNK))
    got = dataclasses.replace(drv, mb_mode=mode).run(chunks, KW["dt_gcm"])
    for k, v in torch_routes[f"run_{mode}"].items():
        assert np.array_equal(got[k].numpy(), v), k
    assert all(not c for c in chunks) == (mode == "host")


def test_join_that_consumes_the_chunks(torch_case):
    _, st = torch_case
    chunks = list(tmmf._split_ens(st, NENS // CHUNK))
    joined = tmmf._join_ens(chunks, consume=True)
    assert all(torch.equal(joined[k], v) for k, v in st.items())
    assert chunks == [{}, {}]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _three_members(state):
    return {k: v[:3] for k, v in state.items()}


@pytest.mark.parametrize("route", ["crm_phys_step",
                                   "crm_phys_step_hostchunked", "run"])
def test_non_multiple_is_refused_as_pam_tpu_refuses_it(jax_routes,
                                                       torch_case, route):
    import jax.numpy as jnp
    drv, st = torch_case
    jdrv = jax_routes[2]
    jst = {k: jnp.asarray(v[:3]) for k, v in jax_routes[0].items()}
    args = (KW["dt_gcm"],) if route == "run" else ()
    with pytest.raises(ValueError, match="micro-batching") as jerr:
        getattr(jdrv, route)(jst, *args)
    with pytest.raises(ValueError, match="micro-batching") as terr:
        getattr(drv, route)(_three_members(st), *args)
    assert str(terr.value) == str(jerr.value)


def test_microbatched_checks_every_leaf(torch_case):
    """pam_tpu's leading-axis check: a leaf that does not carry the full
    ensemble is named."""
    drv, st = torch_case
    bad = dict(st, temp=st["temp"][:CHUNK])
    with pytest.raises(ValueError, match="state\\['temp'\\] has shape"):
        drv.crm_phys_step_microbatched(bad, NENS // CHUNK)


def test_run_refuses_a_chunk_of_another_size(torch_case):
    drv, st = torch_case
    with pytest.raises(ValueError, match="micro-batching takes chunks"):
        drv.run([_three_members(st)], KW["dt_gcm"])


def test_mb_mode_is_checked(torch_case):
    drv, _ = torch_case
    assert drv.mb_mode == "host"
    assert dataclasses.replace(drv, mb_mode="unrolled").mb_mode == "unrolled"
    for bad in ("lax_map", "Host", ""):
        with pytest.raises(ValueError, match=f"mb_mode={bad!r}"):
            dataclasses.replace(drv, mb_mode=bad)


# ---------------------------------------------------------------------------
# P3+SHOC: chunked equals whole
# ---------------------------------------------------------------------------

def test_p3_shoc_chunked_matches_whole():
    kw = dict(KW, nz=12, zlen=20000.0, micro="p3", sgs="shoc")
    whole, st = tmmf.setup_supercell_mmf(nens=NENS, **kw,
                                         dtype=torch.float64, device="cpu")
    st = tforcing.compute_gcm_forcing_tendencies(whole.coupler, st,
                                                 whole.dt_gcm)
    chunk, _ = tmmf.setup_supercell_mmf(nens=CHUNK, **kw,
                                        dtype=torch.float64, device="cpu")
    ref = state_to_numpy(whole.crm_phys_step(st))
    got = state_to_numpy(chunk.crm_phys_step(st))
    start = state_to_numpy(st)
    for k in ref:
        err = _err(k, ref[k], got[k], start)
        assert err < TOL, (k, err)


# ---------------------------------------------------------------------------
# run_mmf with ens_chunk
# ---------------------------------------------------------------------------

def test_run_mmf_ens_chunk_matches_pam_tpu(tmp_path):
    import yaml
    import pam_tpu.driver.standalone as jstandalone
    cfg = dict(sim_time=160, crm_nx=8, crm_ny=1, crm_nz=12, nens=NENS,
               ens_chunk=CHUNK, xlen=16000.0, ylen=64000.0, zlen=20000.0,
               vcoords="uniform", dt_gcm=80.0, dt_crm_phys=20.0,
               micro="kessler", sgs="none", dycore="spam", out_freq=80.0)
    path = tmp_path / "chunked.yaml"
    path.write_text(yaml.safe_dump(cfg))
    states, files = {}, {}
    for side, mod, kw in (("j", jstandalone, {}),
                          ("t", tstandalone, {"device": "cpu"})):
        c = mod.load_config(str(path))
        c["out_prefix"] = str(tmp_path / side)
        states[side] = {k: np.asarray(v) for k, v in
                        mod.run_mmf(c, verbose=False, **kw).items()}
        files[side] = str(tmp_path / f"{side}.nc")
    assert sorted(states["j"]) == sorted(states["t"])
    for k, ref in states["j"].items():
        assert ref.shape[0] == NENS, k
        assert _err(k, ref, states["t"][k], states["j"]) < 1e-10, k
    with netcdf_file(files["j"], "r", mmap=False) as fj, \
            netcdf_file(files["t"], "r", mmap=False) as ft:
        assert ft.dimensions["nens"] == fj.dimensions["nens"] == NENS
        assert sorted(ft.variables) == sorted(fj.variables)
        assert ft.variables["t"].shape == fj.variables["t"].shape == (3,)
        for k, v in fj.variables.items():
            assert ft.variables[k].shape == v.shape, k


def test_run_mmf_builds_the_driver_at_the_chunk(tmp_path, monkeypatch):
    """ens_chunk "auto" takes pick_ens_chunk's chunk (4 of 12: the largest
    power of two within the budget that divides 12) and an integer its
    own; the driver is built at the chunk and the state at nens."""
    cfg = dict(sim_time=20, crm_nx=8, crm_ny=1, crm_nz=12, nens=12,
               xlen=16000.0, ylen=64000.0, zlen=20000.0, dt_gcm=20.0,
               dt_crm_phys=20.0, micro="kessler", dycore="spam",
               out_freq=-1.0)
    seen = []
    real_run = tmmf.MmfDriver.run

    def run(self, state, sim_time, callback=None):
        # run_mmf hands the state over as a list of driver-sized chunks
        seen.append((self.coupler.nens,
                     [int(c["temp"].shape[0]) for c in state]))
        return real_run(self, state, sim_time, callback)
    monkeypatch.setattr(tmmf.MmfDriver, "run", run)
    assert tmmf.pick_ens_chunk(8, 1, 12, torch.float64, 12) == 4
    for chunk, want in (("auto", 4), (6, 6), (12, 12), (None, 12)):
        seen.clear()
        out = tstandalone.run_mmf(dict(cfg, ens_chunk=chunk), verbose=False,
                                  device="cpu")
        assert seen == [(want, [want] * (12 // want))], chunk
        assert out["temp"].shape[0] == 12, chunk


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_chunked_route_launches_the_kernels_once_a_chunk():
    """P3+SHOC on SPAM+SI at 16x1x12, f64, nens 8 as 4 chunks of 2 on
    CUDA tensors: one step launches B1 6 times and B4 once a chunk, with
    no plain fallback, and equals the chunks stepped alone bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(KW, nx=16, zlen=20000.0, xlen=32000.0, micro="p3",
              sgs="shoc")
    full, st = tmmf.setup_supercell_mmf(nens=8, **kw, dtype=torch.float64,
                                        device="cuda")
    st = tforcing.compute_gcm_forcing_tendencies(full.coupler, st,
                                                 full.dt_gcm)
    drv, _ = tmmf.setup_supercell_mmf(nens=2, **kw, dtype=torch.float64,
                                      device="cuda")
    b1, b4 = weno_x.weno_edges_x_cuda.launches, p3_part2.p3_part2_cuda.launches
    got = drv.crm_phys_step(st)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches - b1 == 6 * 4
    assert p3_part2.p3_part2_cuda.launches - b4 == 4
    alone = tmmf._join_ens([drv.crm_phys_step(c)
                            for c in tmmf._split_ens(st, 4)])
    for k, v in alone.items():
        assert torch.equal(got[k], v), k

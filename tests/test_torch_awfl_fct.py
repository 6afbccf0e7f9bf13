"""The AWFL dycore's FCT limiter (``ops/awfl_fct.py``): the plain version
against the limiter as it stood inside ``AwflDycore._fct`` and against
pam_tpu's, the route ``_fct`` takes, the wrapper's refusals, and, on the
card, ``csrc/awfl_fct.cu`` against the plain version and in the compiled
step.

Tolerance on the card: 4 ulp of each face's own value against the plain
version on the card (which divides by dx as a product with the
reciprocal, so that its outflow can differ in the last bit), and bit for
bit against the plain version on the CPU, whose roundings the kernel
follows. JAX is imported inside the one test that uses it, so that the
card-side cases run where it is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_awfl_fct.py
"""

import functools
import operator
import os
import re
import sys

import numpy as np
import pytest
import torch

import pam_tpu_torch.driver.mmf as tmmf
from pam_tpu_torch.convert import state_from_numpy
from pam_tpu_torch.core.coupler import Coupler
from pam_tpu_torch.dycore.awfl import AwflDycore
from pam_tpu_torch.modules import gcm_forcing
from pam_tpu_torch.ops import awfl_fct
from pam_tpu_torch.parallel import comm
from pam_tpu_torch.utils import observe

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import (FCT_DX, FCT_ULPS, fct_firing_share,  # noqa: E402
                        fct_inputs, fct_ulps, fct_work)
AX_Y, AX_Z, AX_X = awfl_fct.AX_Y, awfl_fct.AX_Z, awfl_fct.AX_X
DX = DY = FCT_DX


def _pad_ones(a, axis):
    shape = list(a.shape)
    shape[axis] = 1
    ones = a.new_ones(shape)
    return torch.cat([ones, a, ones], dim=axis)


def _fct_before_the_move(fluxes, tracers_start, dt, dz4, pos, dx, dy):
    """``AwflDycore._fct`` as it was before the limiter moved to
    ``ops/awfl_fct.py``, frozen (its coupler's dx, dy and pos as
    arguments)."""
    vol = dx * dy * dz4
    mass_avail = tracers_start.clamp(min=0.0) * vol

    def outflow(tf, ax, d):
        n = tf.shape[ax] - 1
        return (tf.narrow(ax, 1, n).clamp(min=0.0)
                - tf.narrow(ax, 0, n).clamp(max=0.0)) / d

    flux_out = functools.reduce(
        operator.add, (outflow(tf, ax, d) for ax, d, _, tf in fluxes))
    mass_out = flux_out * dt * vol
    mult = torch.where(
        mass_out > mass_avail,
        mass_avail / torch.where(mass_out == 0, 1.0, mass_out), 1.0)
    mult = torch.where(pos, mult, 1.0)

    def limit(flux, ax):
        n = mult.shape[ax]
        padded = (_pad_ones(mult, ax) if ax == AX_Z
                  else comm.halo_pad(mult, 1, axis=ax,
                                     kind="x" if ax == AX_X else "y"))
        ml = padded.narrow(ax, 0, n + 1)
        mr = padded.narrow(ax, 1, n + 1)
        return flux * torch.where(flux > 0, ml,
                                  torch.where(flux < 0, mr, 1.0))

    return [(ax, d, sf, limit(tf, ax)) for ax, d, sf, tf in fluxes]


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dt", [7.3, "tensor"])
@pytest.mark.parametrize("dims", [(3, 2, 1, 7, 9), (3, 2, 4, 5, 6)],
                         ids=["2d", "3d"])
def test_reference_equals_the_fct_before_the_move(dims, dt, dtype):
    """fct_limit_reference is the limiter that AwflDycore._fct held, bit
    for bit, 2-D and 3-D, with dt a float or a 0-d tensor, the limiter
    firing and one tracer not positive-definite (its fluxes untouched)."""
    fluxes, start, dz4, pos = fct_inputs(*dims, dtype, "cpu", seed=1)
    dt = torch.tensor(7.3, dtype=dtype) if dt == "tensor" else dt
    assert fct_firing_share(fluxes, start, dt, dz4, pos) > 0.1
    got = awfl_fct.fct_limit_reference(fluxes, start, dt, dz4, pos, DX, DY)
    want = _fct_before_the_move(fluxes, start, dt, dz4, pos, DX, DY)
    assert [g[0] for g in got] == [f[0] for f in fluxes]
    for (_, _, sf, g), (_, _, _, w), (_, _, _, f) in zip(got, want, fluxes):
        assert sf is None and torch.equal(g, w)
        assert torch.equal(g[1], f[1]) and not torch.equal(g[0], f[0])


def test_reference_matches_pam_tpu_where_the_limiter_fires(monkeypatch):
    """One 2-D tendencies evaluation on tests/test_awfl_oracle.py's
    stretched grid with the start values cut to a third, so that the
    limiter fires on more than a tenth of the positive tracers' cells
    ("chi" is not positive-definite): the port's tracer tendencies, whose
    FCT is fct_limit_reference, match pam_tpu's at the oracle test's
    rtol 1e-10."""
    import jax
    sys.path.insert(0, HERE)
    import test_awfl_oracle as jorc
    nx, ny, nz, nens = 8, 1, 6, 2
    jcpl, jdyc, jstate, dzc = jorc._setup(nx, ny, nz, nens, seed=5)
    cpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=jcpl.xlen,
                  ylen=jcpl.ylen, dtype=torch.float64,
                  device=torch.device("cpu"))
    for t in jcpl.tracers:
        cpl = cpl.add_tracer(t.name, t.desc, t.positive, t.adds_mass)
    assert list(cpl.tracer_positive) == [True, True, False]
    dyc = AwflDycore.build(cpl, dzc)
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             "cpu", torch.float64)
    jdyn, jtrac = jdyc.coupler_to_dynamics(jstate)
    _, tt_j = jax.jit(lambda d, t: jdyc.tendencies(d, t, t / 3.0, 30.0,
                                                   jstate))(jdyn, jtrac)
    seen = []
    plain = awfl_fct.fct_limit_reference
    monkeypatch.setattr(awfl_fct, "fct_limit_reference",
                        lambda *a: seen.append(a) or plain(*a))
    dyn, trac = dyc.coupler_to_dynamics(state)
    _, tt = dyc.tendencies(dyn, trac, trac / 3.0, 30.0, state)
    assert len(seen) == 1
    fluxes, start, dt, dz4, pos = seen[0][:5]
    assert fct_firing_share(fluxes, start, dt, dz4, pos) > 0.1
    jorc._assert_close(tt.numpy(), np.asarray(tt_j), "tracer tendencies")


class _Mesh:
    """What comm reads of a mesh: the size of each axis."""

    def __init__(self, n_x):
        self.n_x = n_x

    def size(self, kind):
        return self.n_x if kind == "x" else 1


@pytest.mark.parametrize("device,sim2d,x_shards,want", [
    ("cuda", True, None, True), ("cuda", True, 1, True),
    ("cpu", True, None, False), ("cuda", False, None, False),
    ("cuda", True, 2, False)],
    ids=["card-2d", "card-2d-ensemble-mesh", "cpu", "card-3d",
         "card-x-sharded"])
def test_uses_kernel_only_for_an_unsharded_2d_step_on_the_card(
        device, sim2d, x_shards, want):
    ctx = comm.axis_ctx(None if x_shards is None else _Mesh(x_shards),
                        x=x_shards is not None)
    with ctx:
        assert awfl_fct.uses_kernel(torch.device(device), sim2d) is want


def _small_dycore(ny):
    cpl = Coupler(nz=5, ny=ny, nx=6, nens=2, xlen=6 * DX, ylen=ny * DY,
                  dtype=torch.float64, device=torch.device("cpu"))
    for name, positive in (("water_vapor", True), ("chi", False),
                           ("puff", True)):
        cpl = cpl.add_tracer(name, name, positive, name == "water_vapor")
    return AwflDycore.build(cpl, 300.0 * np.ones(5))


@pytest.mark.parametrize("ny", [1, 4], ids=["2d", "3d"])
def test_fct_takes_the_plain_version_on_cpu_tensors(ny):
    """_fct on CPU tensors, 2-D and 3-D: the plain version's result, the
    kernel's counter unmoved."""
    dyc = _small_dycore(ny)
    fluxes, start, dz4, pos = fct_inputs(3, 2, ny, 5, 6, torch.float64, "cpu",
                                          seed=2, member_dz=False)
    fluxes = [(ax, d, torch.zeros(1), tf) for ax, d, _, tf in fluxes]
    before = awfl_fct.fct_limit_cuda.launches
    got = dyc._fct(fluxes, start, 7.3, dz4)
    want = awfl_fct.fct_limit_reference(fluxes, start, 7.3, dz4, dyc.pos,
                                        DX, DY)
    assert awfl_fct.fct_limit_cuda.launches == before
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and torch.equal(g[3], w[3])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("ny", [1, 4], ids=["2d", "3d"])
def test_fct_limit_on_cpu_tensors_is_the_plain_version(ny, dtype):
    """ops/awfl_fct.py::fct_limit, the route's one entry, on CPU tensors
    of a 2-D and a 3-D run: fct_limit_reference's result bit for bit, the
    kernel's counter unmoved."""
    fluxes, start, dz4, pos = fct_inputs(3, 2, ny, 5, 6, dtype, "cpu",
                                          seed=4)
    dt = torch.tensor(7.3, dtype=dtype)
    before = awfl_fct.fct_limit_cuda.launches
    got = awfl_fct.fct_limit(fluxes, start, dt, dz4, pos, DX, DY, ny == 1)
    want = awfl_fct.fct_limit_reference(fluxes, start, dt, dz4, pos, DX, DY)
    assert awfl_fct.fct_limit_cuda.launches == before
    assert len(got) == len(want) == (2 if ny == 1 else 3)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and torch.equal(g[3], w[3])


def test_fct_hands_the_kernel_the_x_and_z_tracer_fluxes(monkeypatch):
    """Where uses_kernel holds, _fct passes the x and z tracer fluxes, the
    start values, dt, dz4, its pos and the coupler's dx and dy to
    fct_limit_cuda, and returns its limited fluxes beside the untouched
    state fluxes."""
    dyc = _small_dycore(1)
    fluxes, start, dz4, _ = fct_inputs(3, 2, 1, 5, 6, torch.float64, "cpu",
                                        seed=3, member_dz=False)
    fluxes = [(ax, d, torch.full((1,), float(ax)), tf)
              for ax, d, _, tf in fluxes]
    calls = []

    def kernel(tfx, tfz, ts, dt, dz, pos, dx, dy):
        calls.append((tfx, tfz, ts, dt, dz, pos, dx, dy))
        return tfx + 1.0, tfz + 2.0

    monkeypatch.setattr(awfl_fct, "uses_kernel", lambda device, sim2d: sim2d)
    monkeypatch.setattr(awfl_fct, "fct_limit_cuda", kernel)
    got = dyc._fct(fluxes, start, 7.3, dz4)
    (tfx, tfz, ts, dt, dz, pos, dx, dy), = calls
    assert tfx is fluxes[0][3] and tfz is fluxes[1][3] and ts is start
    assert (dt, dz, pos, dx, dy) == (7.3, dz4, dyc.pos, DX, DY)
    for (ax, d, sf, tf), (gax, gd, gsf, gtf), add in zip(fluxes, got,
                                                         (1.0, 2.0)):
        assert (gax, gd, gsf) == (ax, d, sf)
        assert torch.equal(gtf, tf + add)


def _refusal_case(what):
    fluxes, start, dz4, pos = fct_inputs(3, 2, 1, 5, 6, torch.float64, "cpu",
                                          seed=4)
    args = dict(flux_x=fluxes[0][3], flux_z=fluxes[1][3],
                tracers_start=start, dt=7.3, dz4=dz4, pos=pos)
    if what == "dtype":
        args["tracers_start"] = start.int()
    elif what == "mixed dtype":
        args["flux_z"] = args["flux_z"].float()
    elif what == "dt dtype":
        args["dt"] = torch.tensor(7.3, dtype=torch.float32)
    elif what == "3-D":
        args["tracers_start"] = start.expand(3, 2, 2, 5, 6)
    elif what == "x faces":
        args["flux_x"] = args["flux_x"][..., :-1]
    elif what == "z faces":
        args["flux_z"] = args["flux_z"][..., :-1, :]
    elif what == "dz4":
        args["dz4"] = dz4[..., :-1, :]
    elif what == "pos":
        args["pos"] = pos[:2]
    return args


@pytest.mark.parametrize("what,exc,match", [
    ("cpu", ValueError, "needs CUDA tensors.*flux_x is on cpu"),
    ("dtype", TypeError, "float32/float64.*tracers_start torch.int32"),
    ("mixed dtype", TypeError, "flux_z is torch.float32"),
    ("dt dtype", TypeError, "dt is a 0-d torch.float32"),
    ("3-D", ValueError, "2-D run's"),
    ("x faces", ValueError, r"flux_x is \(3, 2, 1, 5, 6\)"),
    ("z faces", ValueError, r"flux_z is \(3, 2, 1, 5, 6\)"),
    ("dz4", ValueError, "dz4 is"),
    ("pos", ValueError, "pos is torch.bool")])
def test_cuda_wrapper_refuses_by_name(what, exc, match):
    with pytest.raises(exc, match=match):
        awfl_fct.fct_limit_cuda(**_refusal_case(what), dx=DX, dy=DY)


def test_kernel_layout_numbers_match_source():
    """The argument-array length and the tile's largest count of entries
    of ops/awfl_fct.py are those of csrc/awfl_fct.cu, and the struct the
    array fills has a field for each of its values."""
    src = open(os.path.join(os.path.dirname(awfl_fct.__file__), "..",
                            "csrc", "awfl_fct.cu")).read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    assert const("N_ARGS") == awfl_fct.N_ARGS
    assert const("THREADS") * const("CPT") == awfl_fct.ENTRIES
    assert "ENTRIES = THREADS * CPT" in src
    # 8 pointers, 4 extents, 3 x 4 strides of the fluxes and start values,
    # 2 of dz, the tile's rows and columns
    fields = re.search(r"struct FctArgs \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"void\*|char\*", fields)) == 8
    assert 8 + 4 + 12 + 2 + 2 == awfl_fct.N_ARGS
    assert f"v[{awfl_fct.N_ARGS - 1}]" in src
    assert f"v[{awfl_fct.N_ARGS}]" not in src


def test_fct_work_and_tiles_at_the_cell():
    """The yardstick of a call in pama_kessler.nens128 (3 tracers x 128
    members, 65x1x50, float64): 30.0 MB read, 20.3 MB written, 15.1 us at
    3.35 TB/s. A tile's multipliers with their halo fit the kernel's
    ENTRIES: the cell's plane as four tiles of 13 whole rows, a larger
    plane as more of them, and a row longer than ENTRIES / 2 in
    segments."""
    nbytes = fct_work(3, 128, 50, 65, 8)
    assert nbytes == 8 * (3 * 128 * (50 * 65 + 2 * (50 * 66 + 51 * 65)))
    assert round(nbytes / 3.35e12 * 1e6, 1) == 15.1
    for nz, nx, want in ((50, 65, (13, 65)), (200, 256, (2, 256)),
                         (12, 65, (12, 65)), (4, 3000, (1, 511))):
        rows, cols = awfl_fct.fct_tiles(nz, nx)
        assert (rows, cols) == want
        assert (rows + 1) * (cols + 1) <= awfl_fct.ENTRIES


# ----------------------------------------------------------- on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check_on_card(case, dtype, dt):
    """The kernel against the plain version on the card (ULPS) and on the
    CPU (bit for bit), one launch."""
    fluxes, start, dz4, pos = case
    assert fct_firing_share(fluxes, start, dt, dz4, pos) > 0.1
    before = awfl_fct.fct_limit_cuda.launches
    got = awfl_fct.fct_limit_cuda(fluxes[0][3], fluxes[-1][3], start, dt,
                                  dz4, pos, DX, DY)
    torch.cuda.synchronize()
    assert awfl_fct.fct_limit_cuda.launches == before + 1
    card = awfl_fct.fct_limit_reference(fluxes, start, dt, dz4, pos, DX, DY)
    host = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    cpu = awfl_fct.fct_limit_reference(
        [(ax, host(d), None, tf.cpu()) for ax, d, _, tf in fluxes],
        start.cpu(), host(dt), dz4.cpu(), pos.cpu(), DX, DY)
    for g, r, c in zip(got, card, cpu):
        assert g.is_contiguous() and g.shape == r[3].shape
        assert fct_ulps(r[3], g, dtype) <= FCT_ULPS
        assert torch.equal(g.cpu(), c[3])


# (ntr, nens, nz, nx): the cell's call; a plane larger than a block's
# shared memory; P3's ten tracers (tracer 1 not positive-definite)
CARD_CASES = {"cell": (3, 128, 50, 65), "large plane": (2, 4, 200, 256),
              "p3 tracers": (10, 16, 50, 65)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_version_on_the_card(case, dtype):
    _cuda()
    ntr, nens, nz, nx = CARD_CASES[case]
    inputs = fct_inputs(ntr, nens, 1, nz, nx, dtype, "cuda", seed=nz + ntr)
    _check_on_card(inputs, dtype, torch.tensor(7.3, dtype=dtype,
                                               device="cuda"))


# (nz, nx): the tile fct_tiles gives each. The cell's plane as four tiles
# of whole rows; one tile for the whole plane; many row tiles; the widest
# row that whole rows take; rows in two segments, the second short, then
# exactly two; three segments
TILINGS = {(50, 65): (13, 65), (12, 65): (12, 65), (200, 65): (14, 65),
           (6, 511): (1, 511), (4, 600): (1, 511), (5, 1022): (1, 511),
           (3, 1100): (1, 511)}


@pytest.mark.gpu
@pytest.mark.parametrize("nz,nx", list(TILINGS),
                         ids=[f"{nz}x{nx}" for nz, nx in TILINGS])
def test_kernel_on_every_tiling_strided_inputs_and_a_float_dt(nz, nx):
    """Planes that fct_tiles cuts into whole rows, into one tile, or into
    row segments; start values read in place from every second member of
    a larger array; dt a Python float; dz one row for every member."""
    _cuda()
    assert awfl_fct.fct_tiles(nz, nx) == TILINGS[(nz, nx)]
    fluxes, start, dz4, pos = fct_inputs(3, 10, 1, nz, nx, torch.float64,
                                         "cuda", seed=7, member_dz=False)
    start = torch.stack([start, start + 1.0], dim=2).reshape(
        3, 20, 1, nz, nx)[:, ::2]
    assert not start.is_contiguous()
    _check_on_card((fluxes, start, dz4, pos), torch.float64, 7.3)


@pytest.fixture
def _counters():
    """The counters a compiled step leaves as device tensors, put back."""
    saved = (awfl_fct.fct_limit_cuda.launches, AwflDycore.timestep.cycles)
    yield
    awfl_fct.fct_limit_cuda.launches, AwflDycore.timestep.cycles = saved


@pytest.mark.gpu
def test_a_compiled_awfl_replay_launches_the_kernel_three_times_a_trip(
        _counters):
    """The compiled AWFL step, untraced and traced (two captures): each
    replay launches the kernel once a tendency, three times an acoustic
    trip, and with the tracer on the pam:awfl.fct span counts as many."""
    _cuda()
    drv, st = tmmf.setup_supercell_mmf(
        nens=2, nx=16, ny=1, nz=12, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0, dycore="awfl",
        micro="kessler", dtype=torch.float64, device="cuda")
    st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st,
                                                    drv.dt_gcm)
    per_trip = []
    for traced in (False, True):
        if traced:
            observe.enable()
        try:
            step = drv._graphed_single()
            st = step(st)                       # the capture
            observe.reset()
            n0 = int(awfl_fct.fct_limit_cuda.launches)
            c0 = int(AwflDycore.timestep.cycles)
            st = step(st)
            step.check()
            launches = int(awfl_fct.fct_limit_cuda.launches) - n0
            cycles = int(AwflDycore.timestep.cycles) - c0
            assert cycles > 0 and launches == 3 * cycles
            per_trip.append(launches // cycles)
            if traced:
                snap = observe.snapshot()
                assert snap["trips"]["awfl.acoustic"] == cycles
                assert snap["spans"]["pam:awfl.fct"][1] == launches
        finally:
            observe.disable()
    assert per_trip == [3, 3]


# the compiled step through F1 against the eager step through the plain
# limiter, max |d| / max(|ref|, 1) a field: F1 is within FCT_ULPS of the
# plain version on the card at each call, and one step's 43 or so
# acoustic trips grow that by ~1000x at most
REPLAY_TOL = 1e-10


@pytest.mark.gpu
def test_a_compiled_replay_where_the_limiter_fires_matches_the_plain_route(
        _counters, monkeypatch):
    """One compiled AWFL+Kessler step at the PAM-A cell's grid (65x1x50,
    128 km x 64 km x 20 km, f64, 4 members) from a state with rain in a
    block of levels and columns, so that the limiter fires in every
    tendency: through F1 (three launches an acoustic trip) within
    REPLAY_TOL of the eager step through the plain limiter."""
    _cuda()
    drv, st = tmmf.setup_supercell_mmf(
        nens=4, nx=65, ny=1, nz=50, xlen=128000.0, ylen=64000.0,
        zlen=20000.0, dt_gcm=900.0, dt_crm_phys=20.0, dycore="awfl",
        micro="kessler", dtype=torch.float64, device="cuda")
    st = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, st,
                                                    drv.dt_gcm)
    rain = torch.zeros_like(st["precip_liquid"])
    rain[:, 25:45, :, 30:36] = 3e-2 * st["density_dry"][:, 25:45, :, 30:36]
    st["precip_liquid"] = rain
    awfl_fct.fct_limit_cuda.launches = 0
    AwflDycore.timestep.cycles = 0
    compiled = drv._graphed_single()(st)        # capture, then a replay
    drv._graphed_single().check()
    cycles = int(AwflDycore.timestep.cycles)
    assert cycles > 0
    assert int(awfl_fct.fct_limit_cuda.launches) == 3 * cycles

    shares = []
    plain = awfl_fct.fct_limit_reference

    def watched(fluxes, start, dt, dz4, pos, dx, dy):
        shares.append(fct_firing_share(fluxes, start, dt, dz4, pos))
        return plain(fluxes, start, dt, dz4, pos, dx, dy)

    monkeypatch.setattr(awfl_fct, "uses_kernel", lambda device, sim2d: False)
    monkeypatch.setattr(awfl_fct, "fct_limit_reference", watched)
    eager = drv._crm_phys_step_single(st)
    assert len(shares) == 3 * cycles and min(shares) > 0, shares
    for k, want in eager.items():
        got = compiled[k].double()
        want = want.double()
        err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        assert err < REPLAY_TOL, (k, err)

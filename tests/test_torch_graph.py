"""The port's compiled CRM step (ops/graph.py, MmfDriver._graphed_single):
the device loop, the step's freedom from host reads, and the graph
against the eager step.

On the CPU (16x1x12, f64):

* ``while_loop``'s eager route equals a counted Python loop: zero trips,
  tuple, dict and nested carries, its trip counter; a predicate that is
  not a 0-d bool tensor is refused; ``fori_loop`` takes an int or a
  tensor count, and its device route equals its eager one;
* ``no_host_reads`` refuses every host read it names, but the eager
  predicate of a while loop;
* ``_crm_phys_step_single`` of SPAM+SI Kessler, P3+SHOC and AWFL+Kessler
  completes under ``no_host_reads``, the route capture takes (the trip
  counts stay tensors and every loop tests its predicate), so the step
  holds no host read that capture would trip on; it equals the eager step
  bit for bit, with the same trip counts; AWFL's range check raises on
  that route as the eager one does;
* ``_graphed_single()`` on a CPU state is the eager step, bit for bit,
  cached on the driver;
* the restructured Kessler (rainsplit a device tensor, the sub-cycles a
  ``fori_loop``) returns pam_tpu's rainsplit (> 1) and fields at 1e-12 on
  a seeded rainy input.

On the card (``gpu``): the compiled step against the eager one, bit for
bit, for the three stacks in f32 and f64, whole and as 4 x 2 chunks
through ``run``, with equal trip counts; no synchronising call in the
replays; an earlier result unchanged by the next call; a capture that
meets a host read raises and names it; a second shape, or the Thomas
route, captures a second graph; the trip-count division rounds as a
division by a Python int.

JAX and pam_tpu are imported inside the test that uses them:

    python -m pytest --noconftest -m gpu tests/test_torch_graph.py
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import pam_tpu_torch.driver.mmf as tmmf
from pam_tpu_torch.dycore.awfl import AwflDycore
from pam_tpu_torch.modules import gcm_forcing as tforcing
from pam_tpu_torch.ops import awfl_flux, graph, p3_part2, weno_x
from pam_tpu_torch.physics import kessler as tkessler
from pam_tpu_torch.physics.p3 import sedimentation as tsed

torch.set_num_threads(1)

SMALL = dict(nx=16, ny=1, nz=12, xlen=32000.0, ylen=64000.0, zlen=20000.0,
             dt_gcm=200.0, dt_crm_phys=20.0)
STACKS = {"kessler": dict(dycore="spam", micro="kessler"),
          "p3_shoc": dict(dycore="spam", micro="p3", sgs="shoc"),
          "awfl": dict(dycore="awfl", micro="kessler")}


# the counters the device route leaves as tensors, restored after each
# test so that later tests in the process read what they set
COUNTERS = ((tkessler.kessler_column, "rainsplit"),
            (AwflDycore.timestep, "cycles"),
            (tsed.combined_sedimentation, "rounds"),
            (weno_x.weno_edges_x_cuda, "launches"),
            (weno_x.weno_edges_x_cuda, "launches_padded"),
            (p3_part2.p3_part2_cuda, "launches"),
            (awfl_flux.flux_direction_cuda, "launches"))


@pytest.fixture(autouse=True)
def _restore_counters():
    saved = [getattr(o, a) for o, a in COUNTERS]
    yield
    for (o, a), v in zip(COUNTERS, saved):
        setattr(o, a, v)


# ---------------------------------------------------------------------------
# the device loop, eager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_loop_counts_like_a_python_loop(n):
    x = torch.arange(3.0, dtype=torch.float64)
    i, y = graph.while_loop(lambda c: c[0] < n,
                            lambda c: (c[0] + 1, c[1] * 2.0 + 1.0),
                            (torch.tensor(0), x))
    want = x.clone()
    for _ in range(n):
        want = want * 2.0 + 1.0
    assert int(i) == n and torch.equal(y, want)


def test_while_loop_dict_and_nested_carries_and_counter():
    class Owner:
        trips = 0
    carry = {"a": torch.zeros(2), "b": (torch.ones(3), torch.tensor(10))}
    out = graph.while_loop(
        lambda c: c["b"][1] > 7,
        lambda c: {"a": c["a"] + 1.0, "b": (c["b"][0] * 3.0, c["b"][1] - 1)},
        carry, counter=(Owner, "trips"))
    assert Owner.trips == 3
    assert torch.equal(out["a"], torch.full((2,), 3.0))
    assert torch.equal(out["b"][0], torch.full((3,), 27.0))
    assert int(out["b"][1]) == 7


@pytest.mark.parametrize("pred", [lambda c: c > 0, lambda c: c.sum(),
                                  lambda c: True])
def test_while_loop_refuses_a_predicate_that_is_no_0d_bool(pred):
    with pytest.raises(ValueError, match="0-d bool tensor"):
        graph.while_loop(pred, lambda c: c, torch.ones(3))


@pytest.mark.parametrize("n", [0, 4, torch.tensor(0), torch.tensor(4)])
def test_fori_loop_eager_and_device_routes(n):
    body = lambda c: (c[0] * 2.0, c[1] + 1.0)   # noqa: E731
    start = (torch.ones(2), torch.zeros(()))
    eager = graph.fori_loop(n, body, start)
    with graph.no_host_reads():
        device = graph.fori_loop(n, body, start)
    want = 2.0 ** int(n)
    for got in (eager, device):
        assert torch.equal(got[0], torch.full((2,), want))
        assert float(got[1]) == int(n)


@pytest.mark.parametrize("read", [
    lambda t: bool(t[0]), lambda t: int(t[0]), lambda t: float(t[0]),
    lambda t: t[0].item(), lambda t: t.tolist(), lambda t: t.numpy(),
    lambda t: t.cpu(), lambda t: range(9)[t[0].long()],
    lambda t: torch.as_tensor(np.ones(2), device=t.device),
    lambda t: torch.tensor([1.0], device=t.device), lambda t: t[[0, 2]],
    lambda t: t[..., np.array([1])]])
def test_no_host_reads_names_every_read(read):
    t = torch.ones(3)
    with pytest.raises(graph.HostReadError, match="test_torch_graph.py"):
        with graph.no_host_reads():
            read(t)
    read(t)   # outside the guard: allowed


def test_no_host_reads_allows_the_eager_predicate_only():
    with graph.no_host_reads():
        assert graph.device_loops()
        c = graph.while_loop(lambda c: c < 3, lambda c: c + 1,
                             torch.tensor(0))
    assert not graph.device_loops()
    assert int(c) == 3


# ---------------------------------------------------------------------------
# the CRM step on the route capture takes
# ---------------------------------------------------------------------------

def _counts():
    return (tkessler.kessler_column.rainsplit, AwflDycore.timestep.cycles,
            tsed.combined_sedimentation.rounds)


@pytest.fixture(scope="module", params=list(STACKS))
def stack(request):
    """(name, driver, forced start state) of one stack, nens 2, f64."""
    drv, st = tmmf.setup_supercell_mmf(nens=2, **SMALL, **STACKS[request.param],
                                       dtype=torch.float64, device="cpu")
    st = tforcing.compute_gcm_forcing_tendencies(drv.coupler, st, drv.dt_gcm)
    return request.param, drv, st


def test_step_has_no_host_read_and_equals_the_eager_step(stack):
    name, drv, st = stack
    tkessler.kessler_column.rainsplit = 0
    AwflDycore.timestep.cycles = 0
    tsed.combined_sedimentation.rounds = 0
    eager = drv._crm_phys_step_single(st)
    want = tuple(int(c) for c in _counts())
    tkessler.kessler_column.rainsplit = 0
    AwflDycore.timestep.cycles = 0
    tsed.combined_sedimentation.rounds = 0
    with graph.no_host_reads():
        device = drv._crm_phys_step_single(st)
        counts = _counts()
    # the trip counts stayed on the device: tensors, read only now
    if name == "p3_shoc":
        assert want[2] > 0
    else:
        assert isinstance(counts[0], torch.Tensor) and want[0] > 0
    if name == "awfl":
        assert isinstance(counts[1], torch.Tensor) and want[1] > 0
    assert tuple(int(c) for c in counts) == want
    assert eager.keys() == device.keys()
    for k in eager:
        assert torch.equal(eager[k], device[k]), k


def test_awfl_range_check_raises_on_both_routes():
    drv, st = tmmf.setup_supercell_mmf(nens=2, **SMALL, **STACKS["awfl"],
                                       dtype=torch.float64, device="cpu")
    bad = dict(st, temp=st["temp"] * float("nan"))
    msgs = []
    for guard in (False, True):
        with pytest.raises(FloatingPointError,
                           match="AWFL sub-cycle count") as err:
            if guard:
                with graph.no_host_reads():
                    drv.dycore.timestep(bad, drv.dt_crm_phys)
            else:
                drv.dycore.timestep(bad, drv.dt_crm_phys)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_graphed_single_on_cpu_is_the_eager_step(stack):
    _, drv, st = stack
    step = drv._graphed_single()
    assert drv._graphed_single() is step
    other = dataclasses.replace(drv)
    assert other._graphed_single() is not step
    got, want = step(st), drv._crm_phys_step_single(st)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not step.graphs     # nothing captured for a CPU state
    step.check()


def test_kessler_rainsplit_matches_pam_tpu_on_rain():
    """kessler_column on a seeded rainy column batch (rain falling fast
    over 150 m levels): pam_tpu's rainsplit, above 1, and fields at
    1e-12."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.core.constants import Constants as JConstants
    from pam_tpu.physics import kessler as jkessler
    from pam_tpu_torch.core.constants import Constants

    rng = np.random.default_rng(15)
    nz, ncol = 14, 24
    z = (np.arange(nz) + 0.5)[:, None] * 150.0 * np.ones((1, ncol))
    rho = 1.2 * np.exp(-z / 8000.0)
    exner = (1.0 - 2e-5 * z) ** 1.0
    theta = 300.0 + 2.0 * rng.random((nz, ncol))
    qv = 0.012 * (1.0 + 0.2 * rng.random((nz, ncol))) * np.exp(-z / 3000.0)
    qc = 1e-3 * rng.random((nz, ncol))
    qr = 6e-3 * rng.random((nz, ncol))
    args = (theta, qv, qc, qr, rho, z, exner)
    jout = jax.jit(lambda *a: jkessler.kessler_column(
        *a, 20.0, JConstants()))(*(jnp.asarray(a) for a in args))
    jout = [np.asarray(o) for o in jout]
    # pam_tpu's count, computed as its kessler_column computes it
    r = 0.001 * rho
    vel = 36.34 * np.maximum(qr * r, 0.0) ** 0.1364 * np.sqrt(rho[:1] / rho)
    dt2d = np.where(vel[:-1] > 1e-10, 0.8 * np.diff(z, axis=0) / vel[:-1],
                    20.0)
    jsplit = int(np.ceil(20.0 / min(dt2d.min(), 20.0)))
    tout = tkessler.kessler_column(
        *(torch.as_tensor(a) for a in args), 20.0, Constants())
    split = tkessler.kessler_column.rainsplit
    assert isinstance(split, torch.Tensor) and int(split) == jsplit > 1
    for a, b in zip(jout, tout):
        b = b.numpy()
        assert float(np.abs(a - b).max()) <= 1e-12 * max(
            float(np.abs(a).max()), 1e-300)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_case(name, dtype, nens=2):
    drv, st = tmmf.setup_supercell_mmf(nens=nens, **SMALL, **STACKS[name],
                                       dtype=dtype, device="cuda")
    st = tforcing.compute_gcm_forcing_tendencies(drv.coupler, st, drv.dt_gcm)
    return drv, st


def _same(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(STACKS))
def test_compiled_step_equals_eager_on_the_card(name, dtype):
    _cuda()
    drv, st = _card_case(name, dtype)
    step = drv._graphed_single()
    eager, compiled = st, st
    for _ in range(3):
        tkessler.kessler_column.rainsplit = 0
        AwflDycore.timestep.cycles = 0
        tsed.combined_sedimentation.rounds = 0
        eager = drv._crm_phys_step_single(eager)
        want = [int(c) for c in _counts()]
        tkessler.kessler_column.rainsplit = 0
        AwflDycore.timestep.cycles = 0
        tsed.combined_sedimentation.rounds = 0
        compiled = step(compiled)
        assert [int(c) for c in _counts()] == want
        assert not _same(eager, compiled)
    step.check()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(STACKS))
def test_run_in_chunks_compiled_equals_eager(name, dtype):
    """run over 4 chunks of 2 (one GCM step of 10 CRM steps) against the
    same chunks stepped eagerly."""
    _cuda()
    full, st = _card_case(name, dtype, nens=8)
    drv, _ = _card_case(name, dtype)
    got = drv.run(st, SMALL["dt_gcm"])
    chunks = list(tmmf._split_ens(st, 4))
    for i, c in enumerate(chunks):
        c = drv._forcing(c)
        for _ in range(10):
            c = drv._crm_phys_step_single(c)
        chunks[i] = c
    assert not _same(tmmf._join_ens(chunks), got)


@pytest.mark.gpu
def test_replays_make_no_synchronising_call():
    _cuda()
    drv, st = _card_case("awfl", torch.float32)
    step = drv._graphed_single()
    st = step(st)          # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st = step(st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step.check()


@pytest.mark.gpu
def test_an_earlier_result_survives_the_next_call():
    _cuda()
    drv, st = _card_case("kessler", torch.float64)
    step = drv._graphed_single()
    first = step(st)
    kept = {k: v.clone() for k, v in first.items()}
    second = step(first)
    assert not _same(first, kept)
    assert _same(first, second)


@pytest.mark.gpu
def test_a_dropped_graph_gives_its_memory_back():
    """A driver's graph captured and dropped with the driver leaves the
    card's allocated memory where it was: a capture keeps nothing a graph
    (a capture stream of its own would keep a cuBLAS workspace)."""
    _cuda()

    def capture_and_drop():
        drv, st = _card_case("kessler", torch.float32)
        drv._graphed_single()(st)
        del drv, st
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()
    capture_and_drop()      # what is built once a device (tables, flags)
    assert capture_and_drop() == capture_and_drop()


@pytest.mark.gpu
def test_a_host_read_in_capture_raises_and_a_new_key_captures_again():
    _cuda()
    drv, st = _card_case("kessler", torch.float64)

    def reads(state):
        out = drv._crm_phys_step_single(state)
        float(out["temp"].max())
        return out
    with pytest.raises(graph.CaptureError, match="Tensor.__float__"):
        graph.GraphedFunction(reads)(st)
    step = drv._graphed_single()
    step(st)
    step({k: v[:1].clone() for k, v in st.items()})
    assert len(step.graphs) == 2
    # PAM_TRIDIAG's route is part of the key; auto is PCR on the card
    from pam_tpu_torch.ops import tridiag
    old = tridiag._TRIDIAG_MODE
    try:
        tridiag._TRIDIAG_MODE = "pcr"
        step(st)
        assert len(step.graphs) == 2
        tridiag._TRIDIAG_MODE = "thomas"
        step(st)
        assert len(step.graphs) == 3
    finally:
        tridiag._TRIDIAG_MODE = old


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_count_division_rounds_as_a_python_int(dtype):
    _cuda()
    x = torch.rand(4096, dtype=dtype, device="cuda") * 40.0
    for n in range(1, 65):
        got = tkessler._over_count(x, torch.tensor(n, dtype=torch.int32,
                                                   device="cuda"))
        assert torch.equal(got, x / n), n

"""The tracer of the compiled step (``pam_tpu_torch/utils/observe.py``):
spans that are ``record_function`` alone while it is off, device stamps
that add up inside captured graphs while it is on, named loop trips, host
spans, and the benchmark's readers of what it holds
(``benchmark/mmfbench/graph_trace.py``, ``benchmark/metrics``).

The CPU cases run everywhere (the tracer takes the host's clock there);
the ``gpu`` cases need the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_trace.py``. No JAX is imported here."""

import contextlib
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

import pam_tpu_torch.driver.mmf as tmmf
from pam_tpu_torch.ops import graph
from pam_tpu_torch.utils import observe

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
from mmfbench import graph_trace, program, spec   # noqa: E402

torch.set_num_threads(1)

SMALL = dict(nx=16, ny=1, nz=12, xlen=32000.0, ylen=64000.0, zlen=20000.0,
             dt_gcm=200.0, dt_crm_phys=20.0)
P3_SHOC = dict(dycore="spam", micro="p3", sgs="shoc")
METRICS = ("step.graph_ms_per_step", "dycore.graph_ms_per_step",
           "physics.graph_ms_per_step", "driver.outside_graph_ms_per_step",
           "micro.loop_trips_per_step")


@pytest.fixture
def tracer():
    """The tracer on the CPU, zeroed, turned off again after the test."""
    observe.enable("cpu")
    observe.reset()
    try:
        yield observe
    finally:
        observe.disable()


def _spin(ms):
    t = time.perf_counter()
    while time.perf_counter() - t < ms / 1e3:
        pass


def _driver(device="cpu", nens=2, stack=None):
    drv, st = tmmf.setup_supercell_mmf(nens=nens, **SMALL,
                                       **(stack or P3_SHOC),
                                       dtype=torch.float64, device=device)
    return drv, drv._forcing(st)


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_span_off_is_record_function_alone_and_the_profiler_keeps_layers():
    assert not observe.active()
    assert isinstance(observe.span("pam:x"),
                      torch.autograd.profiler.record_function)
    assert isinstance(observe.host_span("host:x"), contextlib.nullcontext)
    drv, st = _driver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv._crm_phys_step_single(st)
    names = {e.name for e in prof.events()}
    assert {"pam:step", "pam:forcing", "pam:dycore", "pam:sponge",
            "pam:sgs", "pam:micro", "pam:p3.part2", "pam:p3.sedimentation",
            "pam:si.solve", "pam:si.compute_rhs"} <= names
    assert not any(n.startswith("host:") for n in names)


def test_nothing_is_recorded_while_off(tracer):
    observe.disable()
    with observe.span("pam:off"):
        pass
    observe.add_trips("off.loop", 3)
    observe.enable("cpu")
    snap = observe.snapshot()
    assert "pam:off" not in snap["spans"] and "off.loop" not in snap["trips"]


# ---------------------------------------------------------------------------
# on, on the CPU's clock
# ---------------------------------------------------------------------------

def test_totals_counts_same_named_spans_reset_and_snapshot(tracer):
    t0 = time.perf_counter_ns()
    with observe.span("pam:outer"):
        for _ in range(2):
            with observe.span("pam:inner"):
                _spin(2.0)
    t1 = time.perf_counter_ns()
    snap = observe.snapshot()
    assert snap["clock"] == "host" and snap["offset_ns"] == 0
    ns_in, n_in = snap["spans"]["pam:inner"]
    ns_out, n_out = snap["spans"]["pam:outer"]
    assert n_in == 2 and n_out == 1
    assert 4e6 <= ns_in <= ns_out <= t1 - t0
    assert [n for n, _, _ in snap["ring"]] == ["pam:inner", "pam:inner",
                                               "pam:outer"]
    for _, b, e in snap["ring"]:
        assert t0 <= b <= e <= t1
    assert snap["ring_dropped"] == 0
    observe.reset()
    snap = observe.snapshot()
    assert snap["spans"]["pam:inner"] == (0, 0) and snap["ring"] == []


def test_a_span_in_a_loop_body_adds_each_trip_and_stays_off_the_timeline(
        tracer):
    def body(c):
        with observe.span("pam:body"):
            return c + 1
    out = graph.while_loop(lambda c: c < 4, body, torch.tensor(0),
                           name="test.loop")
    assert int(out) == 4
    snap = observe.snapshot()
    assert snap["spans"]["pam:body"][1] == 4
    assert snap["trips"]["test.loop"] == 4
    assert snap["ring"] == []


def test_a_span_opened_inside_itself_raises(tracer):
    with pytest.raises(RuntimeError, match="inside itself"):
        with observe.span("pam:self"):
            with observe.span("pam:self"):
                pass


def test_paused_records_nothing(tracer):
    with observe.paused():
        with observe.span("pam:paused"):
            pass
        observe.add_trips("paused.loop", 2)
    snap = observe.snapshot()
    assert "pam:paused" not in snap["spans"]
    assert "paused.loop" not in snap["trips"]


@pytest.mark.parametrize("n", [0, 3, torch.tensor(0), torch.tensor(3)])
def test_named_trips_of_while_and_fori_loops_on_both_routes(tracer, n):
    body = lambda c: c * 2.0   # noqa: E731
    graph.fori_loop(n, body, torch.ones(2), name="test.fori")
    with graph.no_host_reads():
        graph.fori_loop(n, body, torch.ones(2), name="test.fori")
        graph.while_loop(lambda c: c[0] < 5, lambda c: c + 1,
                         torch.zeros(1), name="test.while")
    graph.while_loop(lambda c: c[0] < 2, lambda c: c + 1, torch.zeros(1),
                     name="test.while")
    trips = observe.snapshot()["trips"]
    assert trips["test.fori"] == 2 * int(n)
    assert trips["test.while"] == 5 + 2


def test_host_spans_record_on_the_host_clock_and_in_the_profiler(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        with observe.host_span("host:probe"):
            _spin(1.0)
        t1 = time.perf_counter_ns()
    (name, b, e), = observe.snapshot()["host"]
    assert name == "host:probe" and t0 <= b <= e <= t1 and e - b >= 1e6
    assert "host:probe" in {ev.name for ev in prof.events()}


def test_the_eager_step_on_cpu_traced_and_guarded(tracer):
    """Each layer once a step, the SI solve three times, the sedimentation
    rounds as the loop's counter has them, the top-level layers disjoint
    inside pam:step, one pam:step on the timeline a step; the same under
    the host-read guard (the device route of the loops)."""
    from pam_tpu_torch.physics.p3 import sedimentation as tsed
    drv, st = _driver()
    rounds0 = tsed.combined_sedimentation.rounds
    eager = drv._crm_phys_step_single(st)
    with graph.no_host_reads():
        guarded = drv._crm_phys_step_single(st)
    for k in eager:
        assert torch.equal(eager[k], guarded[k]), k
    snap = observe.snapshot()
    spans = snap["spans"]
    for name in ("pam:step", "pam:forcing", "pam:dycore", "pam:sponge",
                 "pam:sgs", "pam:micro", "pam:p3.part2",
                 "pam:p3.sedimentation", "pam:si.compute_rhs"):
        assert spans[name][1] == 2, name
    assert spans["pam:si.solve"][1] == 6
    top = sum(spans[n][0] for n in ("pam:forcing", "pam:dycore",
                                    "pam:sponge", "pam:sgs", "pam:micro"))
    assert 0.9 * spans["pam:step"][0] <= top <= spans["pam:step"][0]
    rounds = int(tsed.combined_sedimentation.rounds) - rounds0
    assert snap["trips"]["p3.sedimentation"] == rounds > 0
    assert [n for n, _, _ in snap["ring"]].count("pam:step") == 2


AWFL = dict(dycore="awfl", micro="kessler")
AWFL_SPANS = ("pam:awfl.tendencies", "pam:awfl.halo", "pam:awfl.flux_x",
              "pam:awfl.flux_z", "pam:awfl.fct", "pam:awfl.stage")


@pytest.mark.parametrize("guarded", [False, True], ids=["eager", "device"])
def test_the_awfl_step_traced_once_a_stage(tracer, guarded):
    """An AWFL step with the tracer on, on the eager route and on the
    device route of its loop (under the host-read guard): every AWFL span
    three times an acoustic trip, one tendency evaluation and one stage
    update each (halo, fluxes and FCT inside the tendencies; tendencies
    and stage updates inside pam:dycore), none of them on the timeline."""
    drv, st = _driver(nens=1, stack=AWFL)
    with graph.no_host_reads() if guarded else contextlib.nullcontext():
        drv._crm_phys_step_single(st)
    snap = observe.snapshot()
    spans, trips = snap["spans"], snap["trips"]["awfl.acoustic"]
    assert trips > 0
    for name in AWFL_SPANS:
        assert spans[name][1] == 3 * trips, name
    ns = {n: spans[n][0] for n in AWFL_SPANS + ("pam:dycore",)}
    assert (ns["pam:awfl.halo"] + ns["pam:awfl.flux_x"]
            + ns["pam:awfl.flux_z"] + ns["pam:awfl.fct"]
            <= ns["pam:awfl.tendencies"])
    assert ns["pam:awfl.tendencies"] + ns["pam:awfl.stage"] \
        <= ns["pam:dycore"]
    assert not [n for n, _, _ in snap["ring"] if n.startswith("pam:awfl")]


class _Ops(TorchDispatchMode):
    """The operators a block dispatches, in order, less the profiler's
    own (``record_function``'s, which launch nothing on a card)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "profiler":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_spans_off_leave_the_awfl_step_op_for_op(monkeypatch):
    """With the tracer off the AWFL step on its device route (the route a
    capture takes) dispatches the same operators, in the same order, as
    with no span at all, and launches no stamp: so the compiled step
    captures the same graph, node for node."""
    assert not observe.active()
    drv, st = _driver(nens=1, stack=AWFL)
    n0 = observe.stamp_kernel.launches
    runs = []
    for spans in (True, False):
        if not spans:
            monkeypatch.setattr(observe, "span",
                                lambda name: contextlib.nullcontext())
        with graph.no_host_reads(), _Ops() as rec:
            drv._crm_phys_step_single(st)
        runs.append(rec.ops)
    assert len(runs[0]) > 1000 and runs[0] == runs[1]
    assert observe.stamp_kernel.launches == n0


def test_the_graphed_key_follows_the_tracer():
    drv, _ = _driver()
    key = drv._graphed_single().key
    observe.disable()
    off = key()
    observe.enable("cpu")
    try:
        on = key()
    finally:
        observe.disable()
    assert off != on and off[-1] is False and on[-1] is True
    assert key() == off


def test_the_timeline_keeps_its_first_entries_and_counts_the_rest(
        tracer, monkeypatch):
    monkeypatch.setattr(observe, "RING", 4)
    for _ in range(6):
        with observe.span("pam:many"):
            pass
    snap = observe.snapshot()
    assert len(snap["ring"]) == 4 and snap["ring_dropped"] == 2
    assert snap["spans"]["pam:many"][1] == 6


def test_the_card_buffer_holds_every_slot_and_the_whole_timeline():
    lay = observe._Layout
    assert (lay.BEGIN, lay.NS, lay.COUNT, lay.TRIPS, lay.RING_N) == tuple(
        k * observe.SLOTS for k in range(5))
    assert lay.SIZE - lay.ENTRIES == 3 * lay.CAP == 3 * observe.RING


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _synthetic():
    """A stretch of 2 CRM steps of 2 chunks: pam:step 10 ms a replay,
    3 ms gaps between replays on the timeline, 7 sedimentation rounds."""
    ms = 1_000_000
    ring, t = [], 5 * ms
    for _ in range(4):
        ring.append(("pam:step", t, t + 10 * ms))
        ring.append(("pam:dycore", t + ms, t + 7 * ms))
        t += 13 * ms
    snap = {"spans": {"pam:step": (40 * ms, 4), "pam:dycore": (24 * ms, 4),
                      "pam:sgs": (6 * ms, 4), "pam:micro": (8 * ms, 4),
                      "pam:sponge": (ms, 4)},
            "trips": {"p3.sedimentation": 7, "awfl.acoustic": 99},
            "ring": ring, "ring_dropped": 0, "host": []}
    return {"program": {"snapshot": snap, "step_ms": [26.0, 26.0],
                        "steps": 2, "chunks": 2}}


@pytest.mark.parametrize("metric,want", zip(METRICS, (20.0, 12.0, 7.0,
                                                      4.5, 3.5)))
def test_each_reader_on_a_synthetic_stretch(metric, want):
    assert spec.reader(metric)(_synthetic()) == pytest.approx(want)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_nothing_without_a_traced_card(metric):
    """No profiled stretch of a card (a CPU run), or a stretch that found
    no tracer: no value, no exception."""
    assert spec.reader(metric)({"nens": 4, "chunk": 2}) is None
    assert spec.reader(metric)({"program": None}) is None


def test_readers_leave_a_timeline_that_lost_entries_out():
    r = _synthetic()
    r["program"]["snapshot"]["ring_dropped"] = 1
    assert spec.reader("driver.outside_graph_ms_per_step")(r) is None


@pytest.mark.parametrize("cell", ["production.nens512",
                                  "pamc_kessler.nens128"])
def test_the_stretch_on_the_cpu(monkeypatch, cell):
    """graph_trace.stretch at a tiny size on the CPU (the card's build
    swapped for the CPU's): one GCM step of 3 CRM steps from the last step
    of a GCM step, its spans and trips read by all five readers, the
    tracer off again after it."""
    c = spec.cell(cell)
    config = dict(c.config, run=dict(c.config["run"], crm_nx=16, crm_nz=12,
                                     dt_gcm=60.0, xlen=32000.0, f64=True))
    build = program.build
    monkeypatch.setattr(program, "build",
                        lambda *a: build(*a, device="cpu"))
    r = {"compiled": {"ops": []}, "config": config, "nens": 4, "chunk": 2}
    values = {m: spec.reader(m)(r) for m in METRICS}
    assert not observe.active()
    p = r["program"]
    assert p["steps"] == 3 and p["chunks"] == 2
    assert p["snapshot"]["spans"]["pam:step"][1] == 6
    hosts = {n for n, _, _ in p["snapshot"]["host"]}
    assert "host:forcing" in hosts
    for m, v in values.items():
        assert v is not None and v > 0, m
    assert values["dycore.graph_ms_per_step"] + \
        values["physics.graph_ms_per_step"] <= \
        values["step.graph_ms_per_step"]
    trips = p["snapshot"]["trips"]
    loop = "p3.sedimentation" if "production" in cell else "kessler.rain"
    assert values["micro.loop_trips_per_step"] == trips[loop] / 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("dycore", ["spam", "awfl"])
def test_an_untraced_capture_and_its_replays_launch_no_stamp(dycore):
    _cuda()
    observe.disable()
    drv, st = _driver("cuda", stack=dict(dycore=dycore, micro="kessler"))
    n0 = observe.stamp_kernel.launches
    step = drv._graphed_single()
    for _ in range(3):
        st = step(st)
    torch.cuda.synchronize()
    assert observe.stamp_kernel.launches == n0


@pytest.mark.gpu
def test_a_span_in_a_while_body_adds_trips_times_its_body():
    """A captured loop of 6 trips, each a span around a matmul, replayed
    4 times back to back: 24 entries, and a total that the replays' CUDA
    events hold and that the body's work nearly fills."""
    _cuda()
    a = torch.randn(1024, 1024, device="cuda")

    def fn(d):
        def body(c):
            with observe.span("pam:test.body"):
                return (c[0] + 1, torch.tanh(a @ c[1]))
        i, x = graph.while_loop(lambda c: c[0] < 6, body,
                                (torch.zeros((), dtype=torch.int32,
                                             device="cuda"), d["x"]),
                                name="test.body_loop")
        return {"x": x}
    observe.enable()
    try:
        g = graph.Graphed(fn, {"x": torch.randn(1024, 1024, device="cuda")})
        x = {"x": torch.randn(1024, 1024, device="cuda")}
        g(x)
        torch.cuda.synchronize()
        observe.reset()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the card busy while the host queues the replays, so that they
        # run back to back between the events
        torch.cuda._sleep(50_000_000)
        e0.record()
        for _ in range(4):
            x = g(x)
        e1.record()
        snap = observe.snapshot()
    finally:
        observe.disable()
    ns, count = snap["spans"]["pam:test.body"]
    assert count == 24 and snap["trips"]["test.body_loop"] == 24
    assert not [n for n, _, _ in snap["ring"] if n == "pam:test.body"]
    event_ns = e0.elapsed_time(e1) * 1e6
    assert 0.5 * event_ns <= ns <= event_ns


@pytest.mark.gpu
def test_stamps_on_the_host_clock_fall_in_their_bracket():
    """A span's stamps, taken to the host's clock by the measured offset,
    lie inside the host's bracket of the span (widened by the offset's
    uncertainty); a host span agrees with its record_function event in a
    torch.profiler trace to within 50 us."""
    _cuda()
    a = torch.randn(2048, 2048, device="cuda")
    observe.enable()
    observe.reset()
    try:
        for _ in range(3):   # warm: the profiler's first events are slow
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter_ns()
                with observe.span("pam:test.bracket"):
                    (a @ a).sum()
                torch.cuda.synchronize()
                t1 = time.perf_counter_ns()
                wall = time.time_ns() - time.perf_counter_ns()
                with observe.host_span("host:test.probe"):
                    _spin(1.0)
            snap = observe.snapshot()
            observe.reset()
    finally:
        observe.disable()
    err = snap["offset_err_ns"]
    assert err < 100_000 and snap["resolution_ns"] > 0
    (name, b, e), = snap["ring"]
    assert name == "pam:test.bracket"
    assert t0 - err <= b <= e <= t1 + err
    (_, hb, he), = snap["host"]
    ev = [x for x in prof.profiler.kineto_results.events()
          if x.name() == "host:test.probe"]
    assert len(ev) == 1
    # torch.profiler's host events are on the Unix clock
    start = ev[0].start_ns() - wall
    assert abs(start - hb) < 50_000
    assert abs(start + ev[0].duration_ns() - he) < 50_000


@pytest.mark.gpu
def test_graph_and_outside_add_up_to_the_stretch():
    """graph_trace.stretch on the card at a small size (one GCM step of
    30 CRM steps, 2 chunks): step.graph_ms_per_step and
    driver.outside_graph_ms_per_step add up to the stretch's CUDA-event
    ms a step to within 2% (the events also hold the host's launch of the
    first replay, before the timeline starts), and the layers sit inside
    the step."""
    _cuda()
    c = spec.cell("pamc_kessler.nens128")
    config = dict(c.config, run=dict(c.config["run"], crm_nx=16, crm_nz=12,
                                     dt_gcm=600.0, xlen=32000.0))
    r = {"compiled": {"ops": []}, "config": config, "nens": 4, "chunk": 2}
    v = {m: spec.reader(m)(r) for m in METRICS}
    p = r["program"]
    assert p["steps"] == 30
    event_ms = sum(p["step_ms"]) / p["steps"]
    total = v["step.graph_ms_per_step"] + \
        v["driver.outside_graph_ms_per_step"]
    ring = [x for x in p["snapshot"]["ring"] if x[0] == "pam:step"]
    host = p["snapshot"]["host"]
    lead_ms = (ring[0][1] - host[0][1]) / 1e6
    assert abs(total - event_ms) <= 0.02 * event_ms, (total, event_ms,
                                                      lead_ms, host[:4])
    assert v["dycore.graph_ms_per_step"] + v["physics.graph_ms_per_step"] \
        <= v["step.graph_ms_per_step"]
    assert p["snapshot"]["clock"] == "device"


def test_profile_step_compiled_report_on_the_cpu(capsys):
    """profile_step --compiled's report (the eager step in the graph's
    place on the CPU, the host's clock for the events): every line, the
    tracer off after it."""
    from pam_tpu_torch import profile_step
    drv, st = tmmf.setup_supercell_mmf(
        nens=2, **dict(SMALL, dt_gcm=40.0), **P3_SHOC, dtype=torch.float64,
        device="cpu")
    profile_step.compiled(drv, drv._forcing(st), "p3+shoc tiny")
    out = capsys.readouterr().out
    assert "compiled, 2 steps from one start" in out
    assert "the tracer costs" in out and "pam:p3.sedimentation" in out
    assert "p3.sedimentation" in out.split("loop: trips/step")[1]
    assert "outside the graph" in out and not observe.active()
    # one gap a traced run, the GCM boundary: the forcing covers most of it
    gaps = out.split("widest gaps outside the graph")[1].splitlines()[1:]
    assert len(gaps) == 2 and all("host:forcing" in g for g in gaps)


def test_profile_step_names_the_host_span_over_each_widest_gap():
    """widest_gaps: the gaps between pam:step entries, widest first, each
    with the host span that overlaps it most and that span's share."""
    from pam_tpu_torch import profile_step
    snap = {"ring": [("pam:step", 0, 100), ("pam:dycore", 10, 90),
                     ("pam:step", 110, 200), ("pam:step", 300, 400),
                     ("pam:step", 401, 500)],
            "host": [("host:graph.launch", 100, 105),
                     ("host:graph.check", 195, 210),
                     ("host:forcing", 205, 295)]}
    assert profile_step.widest_gaps(snap, 3) == [
        (100e-6, 200e-6, "host:forcing", 0.9),
        (10e-6, 100e-6, "host:graph.launch", 0.5),
        (1e-6, 400e-6, None, 0.0)]
    assert profile_step.widest_gaps(snap, 1)[0][2] == "host:forcing"
    assert profile_step.widest_gaps({"ring": snap["ring"][:1],
                                     "host": []}) == []

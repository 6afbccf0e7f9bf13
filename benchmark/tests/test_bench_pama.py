"""The PAM-A cell ``pama_kessler.nens128``: its configuration
(``configs/mmf_pama_kessler.json``) and traffic
(``traffic/gcm_loop.nens128.pama.json``), the readers of its five
per-layer metrics (``metrics/b3_roofline.py``, ``awfl.*``) on a synthetic
stretch and on the CPU, and the check of a tiny run of the configuration,
sound and broken."""

import dataclasses
import json

import pytest
import torch

from mmfbench import graph_trace, kernels, program, runner, spec
from test_bench_awfl import FAULTS, PAMA_KESSLER_B3, TINY, _b3_calls

CELL = "pama_kessler.nens128"
METRICS = ("b3_roofline", "awfl.acoustic_trips_per_step",
           "awfl.fct_ms_per_step", "awfl.halo_ms_per_step",
           "awfl.stage_ms_per_step")
# the metrics of the two SPAM cells that read this cell too: the compiled
# step's spans and loop trips, and the driver's host and event spans
SHARED = ("step.graph_ms_per_step", "dycore.graph_ms_per_step",
          "physics.graph_ms_per_step", "driver.outside_graph_ms_per_step",
          "micro.loop_trips_per_step", "driver.host_ms_per_step",
          "device.idle_pct", "physics.device_ms_per_step")
GRAPH = SHARED[:5]
SEED = 2**31 + 23
WINDOW_S = 51.0
# the slowest rate (3.921 M grid-point steps a second) and the slowest
# step p95 (107.58 ms) measured for this cell on an H100
SLOW_RATE = 3.921e6
SLOW_STEP_S = 0.10758


def tiny():
    """The cell cut to TINY, 4 members in chunks of 2, its samples in the
    first steps."""
    c = spec.cell(CELL)
    cfg = json.loads(json.dumps(c.config))
    cfg["run"].update(TINY)
    return dataclasses.replace(c, config=cfg, traffic={
        "nens": 4, "ens_chunk": 2,
        "check": {"boundaries": [1, 2], "interior": [1, 8]}})


def test_the_cell_loads_its_configuration_and_traffic():
    c = spec.cell(CELL)
    assert c.chips == 1
    assert c.config["name"] == "mmf_pama_kessler"
    run = c.config["run"]
    assert run["dycore"] == "awfl" and run["micro"] == "kessler"
    assert spec.dtype_name(c.config) == "float64"
    assert (run["crm_nx"], run["crm_ny"], run["crm_nz"]) == (65, 1, 50)
    assert c.config["reduced"] == [] and c.config["control"] == "float32"
    assert c.traffic["nens"] == 128 and c.traffic["ens_chunk"] is None
    assert set(c.config["limits"].values()) == {1e-6, 0}
    assert {m["name"] for m in c.per_layer} == set(METRICS) | set(SHARED)
    assert {m["name"] for m in c.end_to_end} == {
        "gridpoint_steps_per_s", "step_ms_p95", "peak_reserved_mib",
        "setup_s"}


def test_the_configuration_lists_a_sub_cycle_of_b3_calls():
    """kernel_calls["b3"] is PAMA_KESSLER_B3, and the calls that the
    port's AWFL step makes in one sub-cycle at this configuration."""
    c = spec.cell(CELL)
    assert c.config["kernel_calls"]["b3"] == PAMA_KESSLER_B3
    assert [call for call, _ in _b3_calls(c)] == PAMA_KESSLER_B3


def test_the_samples_lie_inside_the_window():
    """Every step the check may sample is taken inside a 51 s window at
    the slowest measured rate and at the step p95: none waits for steps
    after the window."""
    c = spec.cell(CELL)
    run = c.config["run"]
    ncrm = round(run["dt_gcm"] / run["dt_crm_phys"])
    last = max(ncrm * c.traffic["check"]["boundaries"][1],
               c.traffic["check"]["interior"][1])
    gridpoints = c.traffic["nens"] * run["crm_nx"] * run["crm_nz"]
    assert last < WINDOW_S * SLOW_RATE / gridpoints
    assert last < WINDOW_S / SLOW_STEP_S


def _synthetic(config):
    """A stretch of 2 CRM steps of one chunk: 86 acoustic trips, flux_x
    18 ms and flux_z 22 ms, FCT 56, halo 30, stage 32."""
    ms = 1_000_000
    snap = {"spans": {"pam:step": (200 * ms, 2), "pam:dycore": (198 * ms, 2),
                      "pam:awfl.tendencies": (150 * ms, 258),
                      "pam:awfl.flux_x": (18 * ms, 258),
                      "pam:awfl.flux_z": (22 * ms, 258),
                      "pam:awfl.fct": (56 * ms, 258),
                      "pam:awfl.halo": (30 * ms, 258),
                      "pam:awfl.stage": (32 * ms, 258)},
            "trips": {"kessler.rain": 2, "awfl.acoustic": 86},
            "ring": [], "ring_dropped": 0, "host": []}
    return {"config": config, "nens": 128, "chunk": 128,
            "program": {"snapshot": snap, "step_ms": [100.0, 100.0],
                        "steps": 2, "chunks": 1}}


def _want(config):
    least = kernels.least_s_per_cycle(config, 128)
    return {"b3_roofline": 100.0 * least * 43 / 20e-3,
            "awfl.acoustic_trips_per_step": 43.0,
            "awfl.fct_ms_per_step": 28.0,
            "awfl.halo_ms_per_step": 15.0,
            "awfl.stage_ms_per_step": 16.0}


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_on_a_synthetic_stretch(metric):
    config = spec.cell(CELL).config
    got = spec.reader(metric)(_synthetic(config))
    assert got == pytest.approx(_want(config)[metric], rel=1e-12)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_nothing_without_its_spans_or_trips(metric):
    """No traced card; a SPAM stretch (no AWFL span, no acoustic trip);
    and, for the two new spans, a program that lacks them (the parent of
    this cell): no value, no exception."""
    config = spec.cell(CELL).config
    assert spec.reader(metric)({"nens": 128, "chunk": 128}) is None
    assert spec.reader(metric)({"program": None}) is None
    spam = _synthetic(config)
    snap = spam["program"]["snapshot"]
    snap["spans"] = {k: v for k, v in snap["spans"].items()
                     if not k.startswith("pam:awfl")}
    del snap["trips"]["awfl.acoustic"]
    assert spec.reader(metric)(spam) is None
    older = _synthetic(config)
    for name in ("pam:awfl.halo", "pam:awfl.stage"):
        del older["program"]["snapshot"]["spans"][name]
    if metric in ("awfl.halo_ms_per_step", "awfl.stage_ms_per_step"):
        assert spec.reader(metric)(older) is None
    else:
        assert spec.reader(metric)(older) is not None


def test_b3_roofline_needs_both_flux_spans_and_trips():
    config = spec.cell(CELL).config
    r = _synthetic(config)
    del r["program"]["snapshot"]["trips"]["awfl.acoustic"]
    assert spec.reader("b3_roofline")(r) is None
    r = _synthetic(config)
    for name in ("pam:awfl.flux_x", "pam:awfl.flux_z"):
        del r["program"]["snapshot"]["spans"][name]
    assert spec.reader("b3_roofline")(r) is None


def test_the_stretch_on_the_cpu(monkeypatch):
    """graph_trace.stretch of the tiny cell on the CPU (the card's build
    swapped for the CPU's): the five readers of this cell and the
    compiled step's readers that it shares with the SPAM cells read a
    value, the trips are the loop's over the stretch's steps, the AWFL
    spans sit inside pam:dycore."""
    c = tiny()
    build = program.build
    monkeypatch.setattr(program, "build",
                        lambda *a: build(*a, device="cpu"))
    r = {"compiled": {"ops": []}, "config": c.config, "nens": 4,
         "chunk": 2}
    values = {m: spec.reader(m)(r) for m in METRICS + GRAPH}
    for m, v in values.items():
        assert v is not None and v > 0, m
    p = r["program"]
    assert p["steps"] == 3 and p["chunks"] == 2
    trips = p["snapshot"]["trips"]["awfl.acoustic"]
    assert values["awfl.acoustic_trips_per_step"] == trips / 3
    flux = graph_trace.span_ms_per_step(r, *(
        "pam:awfl.flux_x", "pam:awfl.flux_y", "pam:awfl.flux_z"))
    assert (values["awfl.fct_ms_per_step"] + values["awfl.halo_ms_per_step"]
            + values["awfl.stage_ms_per_step"] + flux
            <= graph_trace.span_ms_per_step(r, "pam:dycore"))


def test_a_sound_tiny_run_reads_correct():
    result = runner.run_cell(tiny(), SEED, 3.0, False, 0.0, device="cpu")
    assert result["correct"] is True, result["checked"]
    assert set(result["checked"]) == set(tiny().config["limits"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_tiny_run_reads_incorrect(fault):
    """The tiny cell's run with its AWFL step broken under it: each
    planted fault fails the configuration's own limits."""
    c = tiny()
    result = runner.run_cell(c, SEED, 3.0, False, 0.0, device="cpu",
                             fault=FAULTS[fault])
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.gpu
def test_b3_launches_are_six_a_traced_trip_on_the_card():
    """On the card, the stretch's sequence at a tiny size (one GCM step
    of the compiled loop, the tracer on): B3's counter grows by 6 times
    the awfl.acoustic trips the tracer counts, and b3_roofline reads a
    share between 0 and 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pam_tpu_torch.utils import observe
    c = tiny()
    # the tiny grid's calls, for B3's least time
    c.config["kernel_calls"]["b3"] = [call for call, _ in _b3_calls(c)]
    system = program.build(c.config, c.traffic, SEED, "cuda")
    try:
        observe.enable()
        program.warm_up(system)
        for j in range(len(system.chunks)):
            system.chunks[j] = system.drv._forcing(system.chunks[j])
        program.synchronize(system)
        observe.reset()
        before = program.kernel_launches()["b3"]
        loop = program.gcm_loop(system, 0.0, start=system.ncrm - 1,
                                nsteps=system.ncrm)
        launched = program.kernel_launches()["b3"] - before
        snap = observe.snapshot()
    finally:
        observe.disable()
    trips = snap["trips"]["awfl.acoustic"]
    assert trips > 0 and launched == 6 * trips
    r = {"config": c.config, "nens": 4, "chunk": 2,
         "program": {"snapshot": snap, "step_ms": loop.step_ms,
                     "steps": len(loop.step_ms), "chunks": 2}}
    assert 0.0 < spec.reader("b3_roofline")(r) < 100.0

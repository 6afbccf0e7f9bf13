"""The AWFL dycore in the harness, on the CPU at a tiny size: the plain
reference (``mmfref/dycore/awfl.py``) is the port's AWFL step bit for bit
today, a run whose timed AWFL path is broken reads incorrect, and B3's
frozen work and launch counter (``mmfbench/kernels.py``,
``mmfbench/program.py``) are the port's. No cell of ``BENCHMARK.json``
runs AWFL yet: the configurations here are the benchmark's own with
``"dycore": "awfl"``, as ``configs/input_mmf_*.yaml`` run PAM-A."""

import dataclasses
import json

import pytest
import torch

from mmfbench import check, kernels, program, runner, spec

TINY = dict(crm_nx=16, crm_nz=12, dt_gcm=60.0, xlen=32000.0)
CELLS = ("pamc_kessler.nens128", "production.nens512")
SEED = 2**31 + 7
WINDOW_S = 3.0          # a few AWFL steps on the CPU, for the p95

# the B3 calls of one acoustic sub-cycle at the configurations' 65x1x50
# grid with Kessler's three tracers, a member's shapes: what a PAM-A
# Kessler configuration lists under kernel_calls["b3"]
PAMA_KESSLER_B3 = [
    {"axis": "x", "cells": [1, 50, 71], "tracers": 3, "matrix_sets": 0},
    {"axis": "z", "cells": [1, 56, 65], "tracers": 3, "matrix_sets": 1},
] * 3


def awfl(name, f64=True, tiny=True):
    """The cell ``name`` with the AWFL dycore, cut to TINY."""
    c = spec.cell(name)
    cfg = json.loads(json.dumps(c.config))
    cfg["run"]["dycore"] = "awfl"
    if tiny:
        cfg["run"].update(TINY, f64=f64)
    return dataclasses.replace(c, config=cfg, traffic={
        "nens": 4, "ens_chunk": 2,
        "check": {"boundaries": [1, 2], "interior": [1, 8]}})


@pytest.mark.parametrize("name", CELLS)
def test_awfl_reference_is_the_ports_step(name):
    """Set-up (the hydrostatic background with it), the forcing at a GCM
    boundary and three CRM steps of one chunk in float64, Kessler and
    P3+SHOC: the frozen copy and the port agree bit for bit on the
    CPU."""
    cell = awfl(name)
    system = program.build(cell.config, cell.traffic, seed=SEED,
                           device="cpu")
    run = program.run_settings(cell.config, cell.traffic)
    seeds = program.member_seeds(SEED, system.nens, system.chunk)
    ref = check.Reference(run, seeds, system.chunk, 1, "cpu")
    assert type(ref.drv.dycore).__module__ == "mmfref.dycore.awfl"
    mine = system.chunks[1]
    assert mine.keys() == ref.start.keys()
    for k in mine:
        assert torch.equal(mine[k], ref.start[k]), k
    assert bool((ref.start["hy_pressure_cells"] > 0).all())
    theirs = ref.start
    for i in range(3):
        if i == 0:
            mine = system.drv._forcing(mine)
        mine = system.drv._crm_phys_step_single(mine)
        theirs = ref.step(theirs, boundary=i == 0)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k


def test_the_reference_holds_the_awfl_slab_only():
    from mmfref.driver import config as ref_config
    from mmfref.driver import mmf as ref_mmf
    run = dict(awfl(CELLS[0]).config["run"], crm_ny=2)
    kw = ref_config.setup_kwargs(run, 2, torch.float64, "cpu")
    with pytest.raises(ValueError, match="ny=2"):
        ref_mmf.setup_supercell_mmf(**kw)
    with pytest.raises(ValueError, match="uniform grid"):
        ref_config.build_zint(dict(run, vcoords="file"))


def _unchanged(i, before, chunks):
    chunks[:] = before


def _half_members(i, before, chunks):
    for j, (b, c) in enumerate(zip(before, chunks)):
        n = c["temp"].shape[0] // 2
        chunks[j] = {k: torch.cat([v[:n], b[k][n:]]) if k in b and v.dim()
                     else v for k, v in c.items()}


def _one_answer_altered(i, before, chunks):
    for c in chunks:
        t = c["temp"].clone()
        t[0] += 0.5
        c["temp"] = t


FAULTS = {"unchanged": _unchanged, "half_members": _half_members,
          "one_answer_altered": _one_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_awfl_step_reads_incorrect(fault):
    """The whole run but the look for a card, the AWFL step broken under
    it: returned as it was, half of each chunk's members left as they
    were, one member's temperature changed by 0.5 K."""
    result = runner.run_cell(awfl(CELLS[0], f64=False), 2**31 + 11,
                             WINDOW_S, False, 0.0, device="cpu",
                             fault=FAULTS[fault])
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_a_sound_awfl_run_reads_correct():
    result = runner.run_cell(awfl(CELLS[0]), 2**31 + 11, WINDOW_S, False,
                             0.0, device="cpu")
    assert result["correct"] is True, result["checked"]


def _b3_calls(cell) -> list:
    """The B3 calls of one acoustic sub-cycle of the port's AWFL dycore,
    two members on the CPU, as ``kernel_calls["b3"]`` lists them, with
    the (prim shape, tracers, axis, matrix sets) of each call."""
    from pam_tpu_torch.ops import awfl_flux
    system = program.build(cell.config, {"nens": 2}, seed=5, device="cpu")
    dyc, state = system.drv.dycore, system.chunks[0]
    calls, flux = [], awfl_flux.flux_direction

    def record(prim, trac, pres, axis, tables, levels=None):
        sets = 0 if levels is None else levels.packed.shape[0]
        calls.append(({"axis": {awfl_flux.AX_X: "x", awfl_flux.AX_Z: "z"}
                       [axis], "cells": list(prim.shape[2:]),
                       "tracers": trac.shape[0], "matrix_sets": sets},
                      (tuple(prim.shape), trac.shape[0], axis, sets)))
        return flux(prim, trac, pres, axis, tables, levels)

    dyn, tracers = dyc.coupler_to_dynamics(state)
    awfl_flux.flux_direction = record
    try:
        dyc._ssprk3_cycle(dyn, tracers, 0.5, state)
    finally:
        awfl_flux.flux_direction = flux
    return calls


def test_b3_calls_are_a_sub_cycle_of_the_ports_step():
    calls = _b3_calls(awfl(CELLS[0], tiny=False))
    assert [c for c, _ in calls] == PAMA_KESSLER_B3


@pytest.mark.parametrize("itemsize", (4, 8))
def test_b3_work_equals_the_ports(itemsize):
    """kernels.b3_work against the port's flux_work at the calls of a
    PAM-A sub-cycle, on one member and on a chunk of 128, and one
    sub-cycle's least time as their sum."""
    from pam_tpu_torch.ops import awfl_flux, weno
    tables = weno.weno_tables(5, torch.float64)
    cell = awfl(CELLS[0], tiny=False)
    dtype = "float32" if itemsize == 4 else "float64"
    for call, (shape, ntr, axis, sets) in _b3_calls(cell):
        for chunk in (1, 128):
            prim_shape = (5, chunk) + shape[2:]
            want = awfl_flux.flux_work(prim_shape, ntr, axis, itemsize,
                                       tables, sets)
            assert kernels.b3_work(prim_shape, ntr, axis, itemsize,
                                   sets) == want
            assert kernels.b3_call_work(call, chunk, itemsize) == want
    config = dict(cell.config, kernel_calls={"b3": PAMA_KESSLER_B3},
                  run=dict(cell.config["run"], f64=itemsize == 8))
    assert kernels.least_s_per_cycle(config, 128) == sum(
        kernels.least_s(*kernels.b3_call_work(c, 128, itemsize), dtype)
        for c in PAMA_KESSLER_B3)


def test_b3_launches_read_zero_on_spam():
    """B3's counter in kernel_launches, and no launch of it from a SPAM
    step."""
    cell = dataclasses.replace(spec.cell(CELLS[0]), traffic={"nens": 2})
    cfg = json.loads(json.dumps(cell.config))
    cfg["run"].update(TINY)
    system = program.build(cfg, cell.traffic, seed=3, device="cpu")
    before = program.kernel_launches()
    assert set(before) == {"b1", "b3", "b4"}
    system.step(system.drv._forcing(system.chunks[0]))
    assert program.kernel_launches()["b3"] - before["b3"] == 0


@pytest.mark.gpu
def test_b3_launches_count_the_compiled_sub_cycles_on_the_card():
    """On the card, two replays of the compiled step: a SPAM chunk adds
    no B3 launch, an AWFL chunk 6 a sub-cycle, as the device decided
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pam_tpu_torch.dycore.awfl import AwflDycore
    for name, dycore in (("pamc_kessler.nens128", "spam"),
                         ("pamc_kessler.nens128", "awfl")):
        cell = awfl(name)
        cfg = json.loads(json.dumps(cell.config))
        cfg["run"]["dycore"] = dycore
        system = program.build(cfg, {"nens": 2}, seed=3, device="cuda")
        program.warm_up(system)
        before = program.kernel_launches()
        cycles = int(AwflDycore.timestep.cycles)
        w = system.drv._forcing(system.chunks[0])
        for _ in range(2):
            w = system.step(w)
        program.synchronize(system)
        n = program.kernel_launches()["b3"] - before["b3"]
        if dycore == "spam":
            assert n == 0
        else:
            taken = int(AwflDycore.timestep.cycles) - cycles
            assert taken > 0 and n == 6 * taken

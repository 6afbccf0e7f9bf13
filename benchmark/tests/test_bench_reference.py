"""The plain reference (``mmfref``) and the check that decides
``correct``, on the CPU at a tiny size: the reference is the port's step
today, bit for bit; it and the harness load no JAX, and the reference
nothing of the port; a run whose timed path is broken reads incorrect."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmfbench import check, program, runner, spec

BENCH = str(spec.HERE)
TINY = dict(crm_nx=16, crm_nz=12, dt_gcm=60.0, xlen=32000.0)
CELLS = ("production.nens512", "pamc_kessler.nens128")


def tiny(name, f64=False):
    c = spec.cell(name)
    cfg = json.loads(json.dumps(c.config))
    cfg["run"].update(TINY, f64=f64)
    return dataclasses.replace(c, config=cfg, traffic={
        "nens": 4, "ens_chunk": 2,
        "check": {"boundaries": [1, 2], "interior": [1, 8]}})


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_ports_step(name):
    """Set-up, forcing and three CRM steps of one chunk in float64: the
    frozen copy and the port agree bit for bit on the CPU."""
    cell = tiny(name, f64=True)
    system = program.build(cell.config, cell.traffic, seed=2**31 + 7,
                           device="cpu")
    run = program.run_settings(cell.config, cell.traffic)
    seeds = program.member_seeds(2**31 + 7, system.nens, system.chunk)
    ref = check.Reference(run, seeds, system.chunk, 1, "cpu")
    mine = system.chunks[1]
    assert mine.keys() == ref.start.keys()
    for k in mine:
        assert torch.equal(mine[k], ref.start[k]), k
    theirs = ref.start
    for i in range(3):
        if i == 0:
            mine = system.drv._forcing(mine)
        mine = system.drv._crm_phys_step_single(mine)
        theirs = ref.step(theirs, boundary=i == 0)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k


def test_every_seed_steps_the_same_chunks():
    """The run seed orders the members within a chunk, the same order in
    every chunk, and nothing more, so every seed gives the card the same
    work: member c*128 + j always shares position j with member j."""
    a, b = (program.member_seeds(s, 512, 128) for s in (1, 2**33 + 5))
    assert not np.array_equal(a, b)
    for s in (a, b):
        for c in range(4):
            assert np.array_equal(s[c * 128:(c + 1) * 128], c * 128 + s[:128])
        assert set(s[:128].tolist()) == set(range(128))


def _run_in_a_process(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_no_jax_and_nothing_of_the_port():
    loaded = _run_in_a_process(f"""
import json, sys
sys.path.insert(0, {BENCH!r})
import numpy as np, torch
from mmfbench import check, spec
cell = spec.cell("production.nens512")
run = dict(cell.config["run"], **{TINY!r})
for dycore in ("spam", "awfl"):
    ref = check.Reference(dict(run, dycore=dycore),
                          np.arange(2, dtype=np.uint64), 2, 0, "cpu")
    ref.step(ref.start, boundary=True)
assert type(ref.drv.dycore).__module__ == "mmfref.dycore.awfl"
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert not {"jax", "jaxlib", "flax", "pam_tpu", "pam_tpu_torch"} \
        & set(loaded)


def test_a_run_loads_no_jax():
    """A CPU rehearsal of a run, set-up to check: no module whose whole
    top-level name is jax, jaxlib, flax or pam_tpu."""
    loaded = _run_in_a_process(f"""
import dataclasses, json, sys, time
sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]
from mmfbench import runner, spec
c = spec.cell("pamc_kessler.nens128")
cfg = dict(c.config, run=dict(c.config["run"], **{TINY!r}))
cell = dataclasses.replace(c, config=cfg, traffic={{"nens": 2,
    "check": {{"boundaries": [1, 1], "interior": [1, 2]}}}})
runner.run_cell(cell, 3, 1.0, False, time.perf_counter(), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "pam_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "pam_tpu"} & set(loaded)


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


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_reads_incorrect(name, fault):
    """The whole run but the look for a card, the timed path broken under
    it: a step that returns its state as it was, half of each chunk's
    members left as they were, one member's temperature changed by 0.5 K
    where the step produces it."""
    result = runner.run_cell(tiny(name), 2**31 + 11, 1.0, False, 0.0,
                             device="cpu", fault=FAULTS[fault])
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_reads_correct(name):
    """The same run unbroken, in float64: the check passes it."""
    result = runner.run_cell(tiny(name, f64=True), 2**31 + 11, 1.0, False,
                             0.0, device="cpu")
    assert result["correct"] is True, result["checked"]
    assert list(result)[-1] == "checked"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_reads_incorrect_on_the_card(name):
    """The configuration's control (the reference in the next precision
    below the configuration's, put in the program's place) fails the
    cell's limits on the card at 16 members; the program at the same size
    passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import calibrate
    cell = dataclasses.replace(spec.cell(name), traffic=dict(
        spec.cell(name).traffic, nens=16, ens_chunk=None))
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        r = calibrate.readings(cell, seed, control=True)
        limits = cell.config["limits"]
        assert check.verdict(r["program"]["numbers"], limits)[0]
        assert not check.verdict(r[cell.config["control"]]["numbers"],
                                 limits)[0]


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "pam_tpu.ops"])
def test_a_run_with_jax_loaded_prints_no_result(name, monkeypatch):
    """Compared by whole top-level name: pam_tpu_torch is no pam_tpu."""
    import types
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_loaded() == [name.split(".")[0]]
    with pytest.raises(runner.ForbiddenImport):
        runner.run_cell(tiny("pamc_kessler.nens128"), 5, 1.0, False, 0.0,
                        device="cpu")


def test_the_port_alone_is_not_forbidden():
    assert "pam_tpu_torch" in sys.modules and runner.forbidden_loaded() == []

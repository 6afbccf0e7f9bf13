"""The frozen work of Z1 (``metrics/z1_roofline.py``) equals the port's
today, and its calls are those the port's step makes at the
configurations' shapes."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mmfbench import program, spec
from pam_tpu_torch.ops import weno, weno_z

CELLS = {"production.nens512": "mmf_production",
         "pamc_kessler.nens128": "mmf_pamc_kessler"}


def _z1():
    return spec.reader("z1_roofline").__globals__


@pytest.mark.parametrize("itemsize", [4, 8])
def test_z1_work_equals_the_ports(itemsize):
    z1 = _z1()
    tables = weno.weno_tables(5, torch.float64)
    for rows, nlev in (r for calls in z1["CALLS"].values() for r in calls):
        for chunk in (1, 128):
            assert z1["work"](rows * chunk, nlev, itemsize) == \
                weno_z.weno_z_work(rows * chunk, nlev, z1["NX"], itemsize,
                                   tables)


@pytest.mark.parametrize("cell", list(CELLS))
def test_z1_calls_are_the_ports_step(cell, monkeypatch):
    """One CRM step of a chunk of 2 members on the CPU, at the
    configuration's grid: the shapes that reach the z reconstruction are
    the metric's calls, in order."""
    c = spec.cell(cell)
    cfg = json.loads(json.dumps(c.config))
    cfg["run"]["dt_gcm"] = 60.0
    c = dataclasses.replace(c, config=cfg, traffic={
        "nens": 2, "ens_chunk": 2,
        "check": {"boundaries": [1, 2], "interior": [1, 2]}})
    system = program.build(c.config, c.traffic, seed=2**31 + 3,
                           device="cpu")
    seen = []
    plain = weno_z.weno_edges_z

    def record(field, tables, nlev, *args, **kw):
        seen.append((int(np.prod(field.shape[:-2])) // system.chunk, nlev,
                     field.shape[-2], field.shape[-1]))
        return plain(field, tables, nlev, *args, **kw)

    monkeypatch.setattr(weno_z, "weno_edges_z", record)
    state = system.drv._forcing(system.chunks[0])
    system.drv._crm_phys_step_single(state)
    z1 = _z1()
    assert seen == [(rows, nlev, nlev + 4, z1["NX"])
                    for rows, nlev in z1["CALLS"][CELLS[cell]]]


@pytest.mark.parametrize("cell", list(CELLS))
def test_z1_reads_nothing_without_every_launch(cell):
    """A share where the trace holds every call of the profiled steps;
    nothing where it holds none (a program without the kernel) or one
    fewer."""
    read = spec.reader("z1_roofline")
    config = spec.cell(cell).config
    steps, nens, chunk = 3, 512, 128
    n = 6 * steps * nens // chunk
    ops = [("void weno_z_edges_kernel<float, true>(...)", i * 10**6,
            i * 10**6 + 10**5) for i in range(n)]
    ops.append(("void weno_x_kernel<float>(...)", 0, 10**9))

    def readings(ops):
        return {"config": config, "nens": nens, "chunk": chunk,
                "compiled": {"steps": steps, "ops": ops}}

    share = read(readings(ops))
    assert share is not None and 0.0 < share < 100.0
    assert read(readings(ops[1:])) is None
    assert read(readings(ops[-1:])) is None
    assert read({"config": config, "nens": nens, "chunk": chunk}) is None

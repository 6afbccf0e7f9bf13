"""The step profiler's arithmetic and the layer spans it reads.

``python -m pam_tpu_torch.profile_step`` needs the card; here its busy
share (a union of device intervals) is checked on fixed intervals, and
one CPU step is traced to check that the driver and ``si_step`` emit
every ``pam:`` span the profiler reports per layer.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pam_tpu_torch.driver.mmf import setup_supercell_mmf
from pam_tpu_torch.modules import gcm_forcing
from pam_tpu_torch.profile_step import union_us

torch.set_num_threads(1)

SPANS = {"pam:step", "pam:forcing", "pam:dycore", "pam:sponge", "pam:micro",
         "pam:si.compute_rhs", "pam:si.solve", "pam:si.discrete_gradient",
         "pam:si.symplectic"}


@pytest.mark.parametrize("intervals, total", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)], 4.0),       # overlap + gap
    ([(5.0, 6.0), (0.0, 4.0), (1.0, 2.0)], 5.0),       # unsorted, nested
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),                   # touching
])
def test_union_us(intervals, total):
    assert union_us(intervals) == total


def test_step_emits_layer_spans():
    drv, state = setup_supercell_mmf(
        nx=8, ny=1, nz=8, nens=1, xlen=16000.0, ylen=64000.0, zlen=16000.0,
        dt_gcm=40.0, dt_crm_phys=20.0, dtype=torch.float64, device="cpu",
        dycore="spam")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       40.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.crm_phys_step(state)
    counts = {}
    for e in prof.events():
        if e.name.startswith("pam:"):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert set(counts) == SPANS
    # one SI step: compute_rhs, then max_iters-1 quasi-Newton evaluations
    # and max_iters linear solves
    iters = drv.dycore.si_max_iters
    assert counts["pam:si.compute_rhs"] == 1
    assert counts["pam:si.solve"] == iters
    assert counts["pam:si.symplectic"] == iters - 1


def test_p3_shoc_step_emits_the_sgs_span():
    """The production physics adds the pam:sgs layer between sponge and
    micro; profile_step takes it with --micro p3 --sgs shoc."""
    from pam_tpu_torch import profile_step
    drv, state = setup_supercell_mmf(
        nx=8, ny=1, nz=8, nens=1, xlen=16000.0, ylen=64000.0, zlen=16000.0,
        dt_gcm=40.0, dt_crm_phys=20.0, dtype=torch.float64, device="cpu",
        micro="p3", sgs="shoc", dycore="spam")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       40.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.crm_phys_step(state)
    order = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name in ("pam:sponge", "pam:sgs", "pam:micro")]
    assert order == ["pam:sponge", "pam:sgs", "pam:micro"]
    with pytest.raises(SystemExit, match="cuda"):
        profile_step.main(["--micro", "p3", "--sgs", "shoc"])


def test_3d_step_emits_layer_spans():
    """The coupled 3-D SPAM step (profile_step --grid3d) emits the same
    layer spans, its SI step through the pressure-gravity system."""
    from pam_tpu_torch import profile_step
    assert profile_step.FULL3D["ny"] == 32
    drv, state = setup_supercell_mmf(
        nx=6, ny=4, nz=8, nens=1, xlen=12000.0, ylen=8000.0, zlen=16000.0,
        dt_gcm=40.0, dt_crm_phys=20.0, dtype=torch.float64, device="cpu",
        dycore="spam")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       40.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.crm_phys_step(state)
    names = {e.name for e in prof.events() if e.name.startswith("pam:")}
    assert names == SPANS
    with pytest.raises(SystemExit, match="cuda"):
        profile_step.main(["--grid3d", "--nens", "16"])

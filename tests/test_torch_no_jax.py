"""pam_tpu_torch runs without JAX and without pam_tpu: in a fresh
interpreter where importing either fails, the package imports and one
full crm_phys_step runs at a tiny size, with Kessler and with P3+SHOC
(whose lookup table is the port's own copy) under SPAM, and with Kessler
under the AWFL dycore; the AWFL thermal bubble takes a step through
AwflDycore alone; run_mmf of driver/standalone.py runs a tiny Kessler
config from configs/input_mmf_kessler.yaml and writes its NetCDF file;
the modules of the standalone slice import; the idealized x-z modules
import and run_idealized runs configs/input_gravitywave.yaml cut to 8x8
for 2 SI steps; the 3-D modules import, run_idealized_3d runs
configs/input_supercell3d.yaml cut to 6x4x6 for 2 SI steps, one
coupled ny = 4 SPAM+Kessler CRM step runs, and the 3-D oracle case that
chip_smoke.py imports from tests/torch_spam3d_case.py builds; the
anelastic and layer modules and the GCM bridge import, run_idealized
takes one step of configs/input_risingbubble_an.yaml cut to 8x8 and one
of configs/input_doublevortex.yaml cut to 8x8, the anelastic oracle case
of tests/torch_anelastic_case.py builds, and one GCM step of a tiny
SPAM+Kessler CRM makes the round trip through the port's registry; a
one-rank sharded CRM step (parallel/{mesh,sharded_step}.py) equals the
unsharded one; the benchmark route, the scaling tool and the plotting
utilities import."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["pam_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import pam_tpu_torch
from pam_tpu_torch import convert, profile_step
from pam_tpu_torch.driver.mmf import setup_supercell_mmf
from pam_tpu_torch.modules import gcm_forcing, saturation
from pam_tpu_torch.core.coupler import Coupler
from pam_tpu_torch.dycore import AwflDycore, awfl_init
from pam_tpu_torch.ops import awfl_flux, p3_part2
from pam_tpu_torch.physics import p3
from pam_tpu_torch.physics.sgs import shoc
for micro, sgs, dycore in (("kessler", "none", "spam"),
                           ("p3", "shoc", "spam"),
                           ("kessler", "none", "awfl")):
    drv, state = setup_supercell_mmf(nx=8, ny=1, nz=8, nens=1, xlen=16000.0,
                                     ylen=64000.0, zlen=16000.0, dt_gcm=40.0,
                                     dt_crm_phys=20.0, dtype=torch.float64,
                                     device="cpu", micro=micro, sgs=sgs,
                                     dycore=dycore)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       40.0)
    state = drv.crm_phys_step(state)
    out = convert.state_to_numpy(state)
    assert all(np.isfinite(v).all() for v in out.values()), (micro, dycore)
assert isinstance(drv.dycore, AwflDycore) and AwflDycore.timestep.cycles > 0
cpl = Coupler(nz=8, ny=1, nx=12, nens=1, xlen=12000.0, ylen=12000.0,
              dtype=torch.float64, device=torch.device("cpu"))
cpl = cpl.add_tracer("water_vapor")
zint = np.linspace(0.0, 8000.0, 9)
state = awfl_init.init_thermal(cpl, cpl.allocate_state(zint))
state = AwflDycore.build(cpl, np.diff(zint)).timestep(state, 5.0)
assert float(state["wvel"].max()) > 0.0
assert awfl_flux.flux_direction_cuda.launches == 0
import os, tempfile
from pam_tpu_torch.core import profiles, vinterp
from pam_tpu_torch.driver import standalone
from pam_tpu_torch.io import output
from pam_tpu_torch.modules import averaging, broadcast, surface_friction
from pam_tpu_torch.ops import banded, recon_matrices
from pam_tpu_torch.physics import radiation
from pam_tpu_torch.utils import (checkpoint, convert_output, observe,
                                 vertical_levels)
cfg = standalone.load_config("configs/input_mmf_kessler.yaml")
with tempfile.TemporaryDirectory() as tmp:
    cfg.update(crm_nx=8, crm_nz=8, nens=1, dt_gcm=20, sim_time=20,
               out_freq=20.0, out_prefix=os.path.join(tmp, "k"))
    state = standalone.run_mmf(cfg, verbose=False, device="cpu")
    from scipy.io import netcdf_file
    with netcdf_file(os.path.join(tmp, "k.nc"), "r", mmap=False) as f:
        assert f.variables["t"].shape == (2,)
assert all(bool(torch.isfinite(v).all()) for v in state.values())
from pam_tpu_torch.spam import (diagnostics, diffusion, si, testcases,
                                thermo, timesteppers)
from pam_tpu_torch.utils import gw_verification
cfg = standalone.load_config("configs/input_gravitywave.yaml")
cfg.update(crm_nx=8, crm_nz=8, sim_time=2 * cfg["dtcrm"])
dens, v, w = standalone.run_idealized(cfg, verbose=False, device="cpu")
assert dens.shape == (2, 1, 8, 8) and w.shape == (1, 7, 8)
assert all(bool(torch.isfinite(a).all()) for a in (dens, v, w))
from pam_tpu_torch.spam import dycore, extruded3d, geometry, varset
cfg = standalone.load_config("configs/input_supercell3d.yaml")
cfg.update(crm_nx=6, crm_ny=4, crm_nz=6, sim_time=2 * cfg["dtcrm"])
dens, v, w = standalone.run_idealized_3d(cfg, verbose=False, device="cpu")
assert dens.shape == (3, 1, 6, 4, 6) and v.shape == (2, 1, 6, 4, 6)
assert all(bool(torch.isfinite(a).all()) for a in (dens, v, w))
drv, state = setup_supercell_mmf(nx=8, ny=4, nz=8, nens=1, xlen=16000.0,
                                 ylen=8000.0, zlen=16000.0, dt_gcm=20.0,
                                 dt_crm_phys=20.0, dtype=torch.float64,
                                 device="cpu", dycore="spam")
assert isinstance(drv.dycore.tend, extruded3d.Tendencies3D)
state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state, 20.0)
state = drv.crm_phys_step(state)
assert all(bool(torch.isfinite(v).all()) for v in state.values())
sys.path.insert(0, "tests")
from torch_spam3d_case import oracle_case_3d
tend, (dens, v, w, geop), _ = oracle_case_3d("cpu")
assert isinstance(tend, extruded3d.Tendencies3D) and dens.shape[0] == 3
from pam_tpu_torch import interface
from pam_tpu_torch.spam import anelastic, layer
cfg = standalone.load_config("configs/input_risingbubble_an.yaml")
cfg.update(crm_nx=8, crm_nz=8, sim_time=cfg["dtcrm"])
dens, v, w = standalone.run_idealized(cfg, verbose=False, device="cpu")
assert dens.shape == (2, 1, 8, 8) and float(dens[0].std()) > 0.0
assert all(bool(torch.isfinite(a).all()) for a in (dens, v, w))
cfg = standalone.load_config("configs/input_doublevortex.yaml")
cfg.update(crm_nx=8, crm_ny=8, sim_time=cfg["dtcrm"])
dens, v = standalone.run_idealized(cfg, verbose=False, device="cpu")
assert dens.shape == (1, 1, 8, 8) and v.shape == (2, 1, 8, 8)
assert all(bool(torch.isfinite(a).all()) for a in (dens, v))
from torch_anelastic_case import an_case
tend, (dens, v, w, geop), _, _ = an_case("cpu", "man")
assert isinstance(tend, anelastic.ManTendencies) and dens.shape[0] == 3
dm = interface.HostDataManager()
dm.finalize()
drv, state = setup_supercell_mmf(nx=8, ny=1, nz=8, nens=1, xlen=16000.0,
                                 ylen=64000.0, zlen=16000.0, dt_gcm=20.0,
                                 dt_crm_phys=20.0, dtype=torch.float64,
                                 device="cpu", dycore="spam")
host = {k: np.array(state[k].numpy()) for k in ("temp", "water_vapor", "wvel")}
for k, a in host.items():
    dm.mirror_array(k, a, readonly=False)
views = {k: dm.get(k) for k in host}
for k in host:
    state[k] = torch.tensor(views[k])
state = drv.gcm_step(state)
for k in host:
    views[k][...] = state[k].numpy()
    assert dm.validate(k) == 0 and dm.entry_dirty(k)
assert np.array_equal(host["temp"], state["temp"].numpy())
dm.finalize()
from pam_tpu_torch.parallel import mesh as tmesh, sharded_step
drv, state = setup_supercell_mmf(nx=8, ny=1, nz=8, nens=2, xlen=16000.0,
                                 ylen=64000.0, zlen=16000.0, dt_gcm=20.0,
                                 dt_crm_phys=20.0, dtype=torch.float64,
                                 device="cpu", dycore="spam")
state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state, 20.0)
step, place = sharded_step.sharded_crm_step(
    drv, tmesh.make_mesh(1, 1, 1, device="cpu"))
out = tmesh.gather_state(tmesh.make_mesh(1, 1, 1, device="cpu"),
                         step(place(state)))
ref = drv.crm_phys_step(state)
assert all(torch.equal(out[k], ref[k]) for k in ref)
from pam_tpu_torch import bench, measure_scaling
from pam_tpu_torch.utils import plotting
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "pam_tpu" or m.startswith("pam_tpu.")]
assert all(sys.modules[m] is None for m in loaded), loaded
print("OK")
"""


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")

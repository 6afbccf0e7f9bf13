"""Write the golden files of the PyTorch port, built with pam_tpu:

* for each config of tools/make_golden.py (kessler_spam_si,
  p3_shoc_spam_si) and for awfl_kessler (the same small grid with the
  AWFL dycore and Kessler), tests/golden/<name>_init.npz: the full
  coupler state that tools/make_golden.py::run_config passes to its first
  CRM step (after compute_gcm_forcing_tendencies). The port starts from
  these files to reproduce the golden trajectories tests/golden/<name>.npz
  without JAX (it draws its own temperature perturbation, so the initial
  state is carried across);
* tests/golden/p3_shoc_spam_si_opbyop.npz: the fields of
  tests/golden/p3_shoc_spam_si.npz after the same 10 steps run by
  pam_tpu op by op (jax.disable_jit). The golden file pins one fused XLA
  program's rounding, which P3's rain evaporation amplifies (its
  qv - qv_prev cancellation), so pam_tpu's own op-by-op run lies up to
  1.1e-6 (rain) from it; the port rounds as the op-by-op run does;
* tests/golden/awfl_kessler.npz and awfl_kessler_opbyop.npz: the fields
  after 5 CRM steps of the awfl_kessler config, run by pam_tpu as one
  jitted step and op by op. AWFL takes 6 SSPRK3 sub-cycles per step
  here, so the two differ by the rounding of 90 tendency evaluations;
* mmf_pamc_small: configs/input_mmf_pamc.yaml (SPAM+SI, Kessler) cut to
  16x1x12 cells and 2 members (PAMC_SMALL), on the config's own
  build_zint levels, whose first and last cells are half cells: its
  _init file and 10 CRM steps run jitted (mmf_pamc_small.npz) and op by
  op (mmf_pamc_small_opbyop.npz) — the stretched-grid SPAM trajectory.

tests/test_torch_mmf.py, tests/test_torch_awfl.py and
tests/test_torch_standalone.py rebuild the _init files and check them
unchanged.

Usage: python tools/make_torch_golden_init.py [name ...]
(every config when no name is given)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden")
CONFIGS = {"kessler_spam_si": ("kessler", "none", "spam"),
           "p3_shoc_spam_si": ("p3", "shoc", "spam"),
           "awfl_kessler": ("kessler", "none", "awfl"),
           "mmf_pamc_small": ("kessler", "none", "spam")}
AWFL_NSTEPS = 5
PAMC_SMALL = dict(crm_nx=16, crm_nz=12, nens=2)
# the trajectories: (config, CRM steps, op by op)
TRAJECTORIES = (("p3_shoc_spam_si", 10, True),
                ("awfl_kessler", AWFL_NSTEPS, False),
                ("awfl_kessler", AWFL_NSTEPS, True),
                ("mmf_pamc_small", 10, False),
                ("mmf_pamc_small", 10, True))


def pamc_small_kwargs(device="cpu"):
    """setup_supercell_mmf arguments of mmf_pamc_small for the port
    (pam_tpu_torch.driver.standalone.mmf_setup_kwargs of the cut config,
    which tests/test_torch_standalone.py holds equal to pam_tpu's
    run_mmf)."""
    from pam_tpu_torch.driver.standalone import load_config, mmf_setup_kwargs
    cfg = load_config(os.path.join(os.path.dirname(GOLDEN), "..", "configs",
                                   "input_mmf_pamc.yaml"))
    cfg.update(PAMC_SMALL)
    return mmf_setup_kwargs(cfg, device)


def path(name="kessler_spam_si"):
    return os.path.join(GOLDEN, f"{name}_init.npz")


def _setup(name):
    """The setup call of tools/make_golden.py:40-45 for config ``name``."""
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf
    if name == "mmf_pamc_small":
        kw = pamc_small_kwargs()
        del kw["device"]
        return setup_supercell_mmf(**dict(kw, dtype=jnp.float64))
    micro, sgs, dycore = CONFIGS[name]
    return setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=200.0,
        dt_crm_phys=20.0, dycore=dycore, dtype=jnp.float64)


def initial_state(name="kessler_spam_si"):
    """The state of config ``name`` after the GCM forcing tendencies;
    numpy float64 leaves."""
    import numpy as np
    from pam_tpu.modules import gcm_forcing
    drv, state = _setup(name)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    return {k: np.asarray(v) for k, v in state.items()}


def out_path(name, opbyop=False):
    return os.path.join(GOLDEN, name + ("_opbyop" if opbyop else "") + ".npz")


def trajectory(name, nsteps, opbyop):
    """``nsteps`` CRM steps of config ``name`` from :func:`initial_state`,
    as tools/make_golden.py::run_config takes them (one jitted step) or,
    with ``opbyop``, with every JAX op dispatched on its own
    (jax.disable_jit); numpy float64 leaves of the golden fields."""
    import contextlib
    import numpy as np
    import jax
    import jax.numpy as jnp
    from make_golden import FIELDS
    drv, _ = _setup(name)
    state = {k: jnp.asarray(v) for k, v in initial_state(name).items()}
    step = drv.crm_phys_step if opbyop else jax.jit(drv.crm_phys_step)
    with (jax.disable_jit() if opbyop else contextlib.nullcontext()):
        for _ in range(nsteps):
            state = step(state)
    extra = ("cloud_liquid", "precip_liquid") if CONFIGS[name][0] == \
        "kessler" else ("cloud_water", "rain", "ice", "tke")
    return {k: np.asarray(state[k]) for k in FIELDS + extra}


def main(argv=None):
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    names = (sys.argv[1:] if argv is None else argv) or list(CONFIGS)
    for name in names:
        np.savez_compressed(path(name), **initial_state(name))
        print(f"wrote {path(name)}")
    for name, nsteps, opbyop in TRAJECTORIES:
        if name not in names:
            continue
        np.savez_compressed(out_path(name, opbyop),
                            **trajectory(name, nsteps, opbyop))
        print(f"wrote {out_path(name, opbyop)}")


if __name__ == "__main__":
    main()

"""Write the golden files of the PyTorch port, built with pam_tpu:

* for each config of tools/make_golden.py (kessler_spam_si,
  p3_shoc_spam_si), tests/golden/<name>_init.npz: the full coupler state
  that tools/make_golden.py::run_config passes to its first CRM step
  (after compute_gcm_forcing_tendencies). The port starts from these
  files to reproduce the golden trajectories tests/golden/<name>.npz
  without JAX (it draws its own temperature perturbation, so the initial
  state is carried across);
* tests/golden/p3_shoc_spam_si_opbyop.npz: the fields of
  tests/golden/p3_shoc_spam_si.npz after the same 10 steps run by
  pam_tpu op by op (jax.disable_jit). The golden file pins one fused XLA
  program's rounding, which P3's rain evaporation amplifies (its
  qv - qv_prev cancellation), so pam_tpu's own op-by-op run lies up to
  1.1e-6 (rain) from it; the port rounds as the op-by-op run does.

tests/test_torch_mmf.py and tests/test_torch_golden_opbyop.py rebuild
them and check them unchanged.

Usage: python tools/make_torch_golden_init.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden")
CONFIGS = {"kessler_spam_si": ("kessler", "none"),
           "p3_shoc_spam_si": ("p3", "shoc")}


def path(name="kessler_spam_si"):
    return os.path.join(GOLDEN, f"{name}_init.npz")


def initial_state(name="kessler_spam_si"):
    """The same setup call as tools/make_golden.py:40-45 for config
    ``name``, then the GCM forcing tendencies; numpy float64 leaves."""
    import numpy as np
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    micro, sgs = CONFIGS[name]
    drv, state = setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=200.0,
        dt_crm_phys=20.0, dycore="spam", dtype=jnp.float64)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    return {k: np.asarray(v) for k, v in state.items()}


OPBYOP = os.path.join(GOLDEN, "p3_shoc_spam_si_opbyop.npz")


def opbyop_trajectory(nsteps=10):
    """tools/make_golden.py::run_config("p3", "shoc") with every JAX op
    dispatched on its own (jax.disable_jit) instead of one jitted step;
    numpy float64 leaves of the golden file's fields."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from make_golden import FIELDS
    micro, sgs = CONFIGS["p3_shoc_spam_si"]
    drv, _ = setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=200.0,
        dt_crm_phys=20.0, dycore="spam", dtype=jnp.float64)
    state = {k: jnp.asarray(v) for k, v in
             initial_state("p3_shoc_spam_si").items()}
    with jax.disable_jit():
        for _ in range(nsteps):
            state = drv.crm_phys_step(state)
    return {k: np.asarray(state[k])
            for k in FIELDS + ("cloud_water", "rain", "ice", "tke")}


def main():
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for name in CONFIGS:
        np.savez_compressed(path(name), **initial_state(name))
        print(f"wrote {path(name)}")
    np.savez_compressed(OPBYOP, **opbyop_trajectory())
    print(f"wrote {OPBYOP}")


if __name__ == "__main__":
    main()

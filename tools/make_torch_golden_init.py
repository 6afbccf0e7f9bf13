"""Write tests/golden/kessler_spam_si_init.npz: the full coupler state that
tools/make_golden.py::run_config("kessler", "none") passes to its first
CRM step (after compute_gcm_forcing_tendencies), built with pam_tpu.

The PyTorch port starts from this file to reproduce the golden
trajectory tests/golden/kessler_spam_si.npz without JAX (the port draws
its own temperature perturbation, so the initial state is carried
across). tests/test_torch_mmf.py rebuilds it and checks it unchanged.

Usage: python tools/make_torch_golden_init.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "kessler_spam_si_init.npz")


def initial_state():
    """The same setup call as tools/make_golden.py:40-45, then the GCM
    forcing tendencies; numpy float64 leaves."""
    import numpy as np
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    drv, state = setup_supercell_mmf(
        nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
        zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
        dt_crm_phys=20.0, dycore="spam", dtype=jnp.float64)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    return {k: np.asarray(v) for k, v in state.items()}


def main():
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(PATH, **initial_state())
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()

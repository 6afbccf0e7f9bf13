"""References that pam_tpu and JAX compute, for the port's tests and for
chip_smoke.py (which imports this module without JAX: JAX is imported
only where a reference is built):

* tests/golden/kessler_spam_si_pcr.npz and
  tests/golden/p3_shoc_spam_si_pcr_opbyop.npz: pam_tpu's trajectories
  with its tridiagonal solves on the parallel-cyclic-reduction branch
  (``pam_tpu.ops.tridiag._TRIDIAG_MODE = "pcr"``, the branch it takes on
  an accelerator), on the CPU in float64, from the golden start states:
  the 10 steps of tests/golden/kessler_spam_si.npz, one jitted step each
  as tools/make_golden.py runs them, and the 10 steps of
  tests/golden/p3_shoc_spam_si_opbyop.npz op by op (jax.disable_jit), as
  that file was made (P3's rain evaporation amplifies the rounding of a
  fused program: ROADMAP, trap 6). The files under the Thomas recurrence
  stay the references of that route; these are those of PCR, the port's
  route on the card;
* tests/golden/perturb_uniform.npz: ``jax.random.uniform(
  jax.random.PRNGKey(seed), UNIFORM_SHAPE, dtype, -1.0, 1.0)`` for each
  of UNIFORM_SEEDS in float32 and float64, the draw of
  pam_tpu/modules/perturb.py; and the rule that holds a start state to
  tests/golden/*_init.npz (start_state_error).

tests/test_torch_tridiag.py and tests/test_torch_perturb.py rebuild them
and hold the port against them; chip_smoke.py phase 19 holds the card's.

Usage: python tests/torch_jax_refs.py
"""

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
GOLDEN = os.path.join(ROOT, "tests", "golden")
# (start config, CRM steps, op by op, reference file stem)
PCR_TRAJECTORIES = (("kessler_spam_si", 10, False, "kessler_spam_si_pcr"),
                    ("p3_shoc_spam_si", 10, True,
                     "p3_shoc_spam_si_pcr_opbyop"))
UNIFORM_PATH = os.path.join(GOLDEN, "perturb_uniform.npz")
UNIFORM_SEEDS = (0, 1, 7, 2**31 + 5)
UNIFORM_SHAPE = (12, 1, 16)
# the GCM column whose scale over dt_gcm a forcing tendency, (gcm -
# mean(crm)) / dt_gcm, is held to: the CRM starts from the GCM's columns,
# so a tendency is the rounding of that mean (the moisture tendencies are
# mixing ratios, of the vapour's scale; the others stay 0 here)
TEND_COLUMN = {"rho_d": "gcm_density_dry", "uvel": "gcm_uvel",
               "vvel": "gcm_vvel", "temp": "gcm_temp"}


def start_state_error(name, got, ref, dt_gcm):
    """(max abs error of field ``name`` of a start state against the
    reference start state ``ref``, the scale it is held to): the field's
    largest |value|, or for a forcing tendency its GCM column's over
    dt_gcm."""
    if name.startswith("gcm_forcing_tend_"):
        column = TEND_COLUMN.get(name[len("gcm_forcing_tend_"):],
                                 "gcm_water_vapor")
        scale = float(abs(ref[column]).max()) / dt_gcm
    else:
        scale = float(abs(ref[name]).max())
    return float(abs(got - ref[name]).max()), scale


def pcr_path(stem):
    return os.path.join(GOLDEN, f"{stem}.npz")


def uniform_key(dtype_name, seed):
    return f"{dtype_name}_seed{seed}"


@contextlib.contextmanager
def tridiag_mode(module, mode):
    """``module._TRIDIAG_MODE`` set to ``mode`` for the block (either
    package's ops/tridiag.py; both read it at every solve)."""
    old = module._TRIDIAG_MODE
    module._TRIDIAG_MODE = mode
    try:
        yield
    finally:
        module._TRIDIAG_MODE = old


def pcr_trajectory(name, nsteps, opbyop):
    """pam_tpu's trajectory of tools/make_torch_golden_init.py::trajectory
    with every tridiagonal solve on the PCR branch."""
    from pam_tpu.ops import tridiag
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from make_torch_golden_init import trajectory
    finally:
        sys.path.pop(0)
    with tridiag_mode(tridiag, "pcr"):
        return trajectory(name, nsteps, opbyop)


def jax_uniform_draws():
    """{uniform_key(dtype, seed): JAX's draw} (the keys of UNIFORM_PATH)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    return {uniform_key(d, s): np.asarray(jax.random.uniform(
        jax.random.PRNGKey(s), UNIFORM_SHAPE, getattr(jnp, d), -1.0, 1.0))
        for d in ("float32", "float64") for s in UNIFORM_SEEDS}


def main():
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for name, nsteps, opbyop, stem in PCR_TRAJECTORIES:
        np.savez_compressed(pcr_path(stem),
                            **pcr_trajectory(name, nsteps, opbyop))
        print(f"wrote {pcr_path(stem)}")
    np.savez_compressed(UNIFORM_PATH, **jax_uniform_draws())
    print(f"wrote {UNIFORM_PATH}")


if __name__ == "__main__":
    main()

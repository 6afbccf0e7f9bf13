"""The port's temperature perturbation (pam_tpu_torch/modules/perturb.py)
against pam_tpu's:

* the draw equals ``jax.random.uniform(jax.random.PRNGKey(seed), shape,
  dtype, -1.0, 1.0)`` bit for bit, float32 and float64, and
  tests/golden/perturb_uniform.npz (which chip_smoke.py phase 19d holds
  the card's machine to) is JAX's draw;
* ``perturb_temperature`` equals pam_tpu's at 1e-14;
* ``setup_supercell_mmf`` and the GCM forcing of the port build the
  committed start states tests/golden/*_init.npz without loading them:
  every field within 1e-14 of its largest |value| (the horizontal means
  of the conserving rescale may sum in another order), each forcing
  tendency, (gcm - mean(crm)) / dt_gcm, within 1e-14 of its GCM column's
  scale over dt_gcm.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pam_tpu_torch.core.coupler import Coupler
from pam_tpu_torch.driver.mmf import setup_supercell_mmf
from pam_tpu_torch.modules import gcm_forcing, perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_jax_refs  # noqa: E402

SEEDS = torch_jax_refs.UNIFORM_SEEDS
SHAPES = ((12, 1, 16), (50, 1, 65))
DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def _golden():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import make_torch_golden_init as golden
    finally:
        sys.path.pop(0)
    return golden


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_draw_is_jax_uniform_bit_for_bit(seed, shape, dtype):
    import jax
    import jax.numpy as jnp
    tdt, npdt = DTYPES[dtype]
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         getattr(jnp, dtype), -1.0, 1.0))
    got = perturb.uniform(seed, shape, tdt)
    assert got.dtype == npdt == want.dtype and got.shape == shape
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                  want.view(f"u{want.itemsize}"))


def test_uniform_reference_file_is_current():
    """tests/golden/perturb_uniform.npz is JAX's draw, and the port's."""
    want = torch_jax_refs.jax_uniform_draws()
    ref = np.load(torch_jax_refs.UNIFORM_PATH)
    assert sorted(ref.files) == sorted(want)
    for d in DTYPES:
        for s in torch_jax_refs.UNIFORM_SEEDS:
            k = torch_jax_refs.uniform_key(d, s)
            got = perturb.uniform(s, torch_jax_refs.UNIFORM_SHAPE,
                                  DTYPES[d][0])
            for a in (want[k], got):
                assert a.dtype == ref[k].dtype
                np.testing.assert_array_equal(a.view(f"u{a.itemsize}"),
                                              ref[k].view(f"u{a.itemsize}"))


@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_perturb_temperature_matches_pam_tpu(dtype):
    """tests/test_modules.py's case (nz 20, two members of seeds 3 and 4,
    magnitude 0.5) through both packages: the same state at 1e-14 (f64) /
    1e-6 (f32), the bottom quarter perturbed and the top untouched."""
    import jax.numpy as jnp
    from pam_tpu.core import Coupler as JCoupler
    from pam_tpu.modules import perturb_temperature as jperturb
    tdt, npdt = DTYPES[dtype]
    nz, ny, nx, nens = 20, 1, 16, 2
    rng = np.random.default_rng(0)
    temp = (280.0 + rng.standard_normal((nens, nz, ny, nx))).astype(npdt)
    jcpl = JCoupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=1.0, ylen=1.0,
                    dtype=getattr(jnp, dtype))
    tcpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=1.0, ylen=1.0,
                   dtype=tdt, device=torch.device("cpu"))
    seeds = np.array([3, 4])
    want = np.asarray(jperturb(jcpl, {"temp": jnp.asarray(temp)}, seeds,
                               magnitude=0.5)["temp"])
    got = perturb.perturb_temperature(tcpl, {"temp": torch.from_numpy(temp)},
                                      seeds, magnitude=0.5)["temp"]
    assert got.dtype == tdt
    got = got.numpy()
    tol = 1e-14 if dtype == "float64" else 1e-6
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())
    assert np.array_equal(got[:, nz // 4:], temp[:, nz // 4:])
    assert not np.array_equal(got[:, :nz // 4], temp[:, :nz // 4])


def _start_state(name):
    """The port's state of config ``name`` of
    tools/make_torch_golden_init.py after the GCM forcing, f64 on the
    CPU, built by the port alone."""
    golden = _golden()
    if name == "mmf_pamc_small":
        kw = golden.pamc_small_kwargs()
    elif name == "mmf_spam3d_small":
        kw = dict(golden.SPAM3D_KW, device="cpu")
    else:
        micro, sgs, dycore = golden.CONFIGS[name]
        kw = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
                  zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=200.0,
                  dt_crm_phys=20.0, dycore=dycore, device="cpu")
    drv, state = setup_supercell_mmf(**dict(kw, dtype=torch.float64))
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    return state, drv.dt_gcm


@pytest.mark.parametrize("name", ("kessler_spam_si", "p3_shoc_spam_si",
                                  "awfl_kessler", "mmf_pamc_small",
                                  "mmf_spam3d_small"))
def test_setup_builds_the_committed_start_state(name):
    """Kessler and P3+SHOC on SPAM+SI, AWFL+Kessler, the stretched pamc
    cut and the coupled 3-D step: the port's own start state is the
    committed one, the perturbed temperature included."""
    state, dt_gcm = _start_state(name)
    ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}_init.npz"))
    assert sorted(state) == sorted(ref.files)
    for k in ref.files:
        got = state[k].numpy()
        assert got.shape == ref[k].shape, k
        err, scale = torch_jax_refs.start_state_error(k, got, ref, dt_gcm)
        assert err <= 1e-14 * scale, k
    # the draw itself reached the state: the perturbation is pam_tpu's
    temp, base = state["temp"].numpy(), ref["gcm_temp"]
    nlev = temp.shape[1] // 4
    assert float(np.abs(temp[:, :nlev] - base[:, :nlev, None, None]).max()) \
        > 0.01

"""SHOC turbulence: the port (pam_tpu_torch.physics.sgs.shoc) against
pam_tpu on the same numpy-seeded inputs, float64 on the CPU.

Tolerances, relative to each field's largest |value|: 1e-13 for the
tridiagonal solve and the PBL height (the same recurrences and
selections), 1e-11 for shoc_main and ShocSgs.timestep (whole chains of
transcendental functions, summed in other orders by XLA).
"""

import os

import numpy as np
import pytest
import torch

from pam_tpu_torch.physics.sgs.shoc import main as tmain

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0, dycore="spam")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_solve_shared_matches_jax():
    import jax.numpy as jnp
    from pam_tpu.physics.sgs.shoc import main as jmain
    rng = np.random.default_rng(1)
    nlev, cols = 20, (6, 3)
    du = -rng.uniform(0.0, 1.0, (nlev,) + cols)
    dl = -rng.uniform(0.0, 1.0, (nlev,) + cols)
    du[-1] = 0.0
    dl[0] = 0.0
    d0 = 1.0 - du - dl + rng.uniform(0.0, 0.1, (nlev,) + cols)
    rhs = [rng.standard_normal((nlev,) + cols) for _ in range(3)]
    tr = rng.standard_normal((nlev,) + cols + (4,))
    ref = jmain._solve_shared(jnp.asarray(du), jnp.asarray(dl),
                              jnp.asarray(d0), [jnp.asarray(r) for r in rhs],
                              jnp.asarray(tr))
    got = tmain._solve_shared(torch.as_tensor(du), torch.as_tensor(dl),
                              torch.as_tensor(d0),
                              [torch.as_tensor(r) for r in rhs],
                              torch.as_tensor(tr))
    assert len(ref) == len(got) == 4
    for a, b in zip(ref, got):
        assert _rel(a, _np(b)) < 1e-13
    # and it solves the system
    x = _np(got[0])
    lhs = d0 * x
    lhs[:-1] += du[:-1] * x[1:]
    lhs[1:] += dl[1:] * x[:-1]
    assert np.abs(lhs - rhs[0]).max() < 1e-12


@pytest.mark.parametrize("npbl", [1, 5, 30])
def test_pblintd_matches_jax(npbl):
    import jax.numpy as jnp
    from pam_tpu.physics.sgs.shoc import main as jmain
    rng = np.random.default_rng(npbl)
    nlev, cols = 30, (7, 2)
    zi = np.linspace(6000.0, 0.0, nlev + 1)[:, None, None] * \
        np.ones((1,) + cols)
    z = 0.5 * (zi[1:] + zi[:-1])
    thl = 300.0 + 3e-3 * z + rng.normal(0.0, 0.3, z.shape)
    ql = np.where(rng.random(z.shape) < 0.3, 1e-4 * rng.random(z.shape), 0)
    q = 0.01 * np.exp(-z / 3000.0)
    u = rng.normal(0.0, 3.0, z.shape)
    v = rng.normal(0.0, 3.0, z.shape)
    ustar = rng.uniform(0.05, 0.5, cols)
    obklen = rng.choice([-1.0, 1.0], cols) * rng.uniform(10.0, 500.0, cols)
    kbfs = rng.normal(0.0, 0.05, cols)
    cldn = rng.uniform(-0.5, 1.0, z.shape)
    args = (z, zi, thl, ql, q, u, v, ustar, obklen, kbfs, cldn)
    ref = jmain.pblintd(*(jnp.asarray(a) for a in args), npbl)
    got = tmain.pblintd(*(torch.as_tensor(a) for a in args), npbl)
    assert _rel(ref, _np(got)) < 1e-13


def _seeded_state(micro):
    """A start state of the golden grid with shear, TKE, cloud and (for
    P3) rain and ice seeded in, as numpy."""
    if micro == "p3":
        state = dict(np.load(os.path.join(GOLDEN,
                                          "p3_shoc_spam_si_init.npz")))
        cloud, extra = "cloud_water", ("rain", "ice")
    else:
        import jax.numpy as jnp
        from pam_tpu.driver.mmf import setup_supercell_mmf
        _, js = setup_supercell_mmf(**KW, micro="kessler", sgs="shoc",
                                    dtype=jnp.float64, state_only=True)
        state = {k: np.asarray(v) for k, v in js.items()}
        cloud, extra = "cloud_liquid", ("precip_liquid",)
    rng = np.random.default_rng(2)
    rho = state["density_dry"]
    shape = rho.shape
    state["uvel"] = state["uvel"] + rng.normal(0.0, 2.0, shape)
    state["vvel"] = rng.normal(0.0, 1.0, shape)
    state["wvel"] = rng.normal(0.0, 0.5, shape)
    state["tke"] = rho * rng.uniform(0.0, 1.0, shape)
    state[cloud] = rho * np.where(rng.random(shape) < 0.4,
                                  1e-3 * rng.random(shape), 0.0)
    for name in extra:
        state[name] = rho * np.where(rng.random(shape) < 0.4,
                                     1e-3 * rng.random(shape), 0.0)
    state["sfc_mom_flx_u"] = rng.normal(0.0, 0.05, shape[:1] + shape[2:])
    return state


def _shocs(micro):
    """pam_tpu's and the port's ShocSgs for the golden grid."""
    import jax.numpy as jnp
    from pam_tpu.core import Coupler as JCoupler
    from pam_tpu.physics import kessler as jkess, p3 as jp3
    from pam_tpu.physics.sgs import shoc as jshoc
    from pam_tpu_torch.core.coupler import Coupler as TCoupler
    from pam_tpu_torch.physics import kessler as tkess, p3 as tp3
    from pam_tpu_torch.physics.sgs import shoc as tshoc
    dims = dict(nz=12, ny=1, nx=16, nens=2, xlen=32000.0, ylen=64000.0)
    jm, tm = (jp3, tp3) if micro == "p3" else (jkess, tkess)
    jc = jshoc.register(jm.register(JCoupler(**dims, dtype=jnp.float64)))
    tc = tshoc.register(tm.register(TCoupler(
        **dims, dtype=torch.float64, device=torch.device("cpu"))))
    pref = np.linspace(2e4, 1e5, 12)   # top-down; 9 levels >= 400 hPa
    return (jshoc.ShocSgs.build(jc, pref_mid=pref),
            tshoc.ShocSgs.build(tc, pref_mid=pref))


@pytest.mark.parametrize("micro", ["p3", "kessler"])
def test_shoc_sgs_timestep_matches_jax(micro):
    import jax.numpy as jnp
    jsgs, tsgs = _shocs(micro)
    assert jsgs.npbl == tsgs.npbl == 9
    state = _seeded_state(micro)
    ref = jsgs.timestep({k: jnp.asarray(v) for k, v in state.items()}, 20.0)
    got = tsgs.timestep({k: torch.as_tensor(v) for k, v in state.items()},
                        20.0)
    assert sorted(ref) == sorted(got)
    assert float(np.abs(np.asarray(ref["tk"])).max()) > 0
    for k in ref:
        assert _rel(ref[k], _np(got[k])) < 1e-11, k


def test_shoc_main_matches_jax(monkeypatch):
    """shoc_main itself, on the column inputs ShocSgs.timestep builds
    from the seeded P3 state (captured from pam_tpu's wrapper)."""
    import jax.numpy as jnp
    from pam_tpu.physics.sgs.shoc import main as jmain, sgs as jsgs_mod
    jsgs, _ = _shocs("p3")
    seen = {}

    def spy(**kw):
        seen.update(kw)
        return jmain.shoc_main(**kw)
    monkeypatch.setattr(jsgs_mod, "shoc_main", spy)
    jsgs.timestep({k: jnp.asarray(v) for k, v in
                   _seeded_state("p3").items()}, 20.0)
    ints = ("dtime", "nadv", "npbl")
    ref_st, ref_d = jmain.shoc_main(**seen)
    got_st, got_d = tmain.shoc_main(**{
        k: (v if k in ints else torch.as_tensor(np.asarray(v)))
        for k, v in seen.items()})
    for k in ref_st:
        assert _rel(ref_st[k], _np(got_st[k])) < 1e-11, k
    assert sorted(ref_d) == sorted(got_d)
    for k in ref_d:
        assert _rel(ref_d[k], _np(got_d[k])) < 1e-11, k


def test_npbl_equals_pam_tpu_at_the_golden_config():
    """SPAM leaves hy_pressure_cells at zero in pam_tpu and in the port,
    so the PBL search depth is 1 level in both (a deviation of the
    reference from PAM's SGS.h:169-178, kept to match the golden file)."""
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf as jsetup
    from pam_tpu.physics.sgs.shoc.sgs import _npbl as jnpbl
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf as tsetup
    from pam_tpu_torch.physics.sgs.shoc.sgs import _npbl as tnpbl
    jd, _ = jsetup(**KW, micro="p3", sgs="shoc", dtype=jnp.float64)
    td, _ = tsetup(**KW, micro="p3", sgs="shoc", dtype=torch.float64,
                   device="cpu")
    assert jd.sgs.npbl == td.sgs.npbl == 1
    pref = np.linspace(1e4, 1e5, 50)
    assert jnpbl(pref) == tnpbl(pref) == 33

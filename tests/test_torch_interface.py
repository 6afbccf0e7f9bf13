"""The port's GCM bridge (pam_tpu_torch/interface.py) against pam_tpu's:

* the Python surface of tests/test_native_interface.py (zero-copy
  mirroring, the read-only flag, allocation and dimensions, options,
  the refusals of mirror_array, validators and dirty tracking), mirrored
  on the port's HostDataManager;
* the port's library is its own build of native/pam_interface.cpp under
  pam_tpu_torch/_build, and a name registered through one package's
  registry is not seen by the other's;
* the GCM round trip of tests/test_gcm_native_roundtrip.py with the
  port's state: host arrays mirrored read-write, the CRM state copied in
  from the registry views, MmfDriver.gcm_step, the results written back
  through the views; 2 GCM steps of 80 s at 16x1x12, nens 2, f64, SPAM+SI
  with Kessler, from pam_tpu's initial state: equal to pam_tpu's round
  trip at 1e-9, and bit for bit to the port's same steps without the
  registry.
"""

import os

import numpy as np
import pytest
import torch

import pam_tpu_torch.interface as tiface
from pam_tpu_torch.convert import state_from_numpy
from pam_tpu_torch.driver.mmf import setup_supercell_mmf
from pam_tpu_torch.interface import HostDataManager

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("temp", "water_vapor", "density_dry", "uvel", "vvel", "wvel",
          "cloud_liquid", "precip_liquid")
# tests/test_gcm_native_roundtrip.py's configuration
KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
          zlen=20000.0, micro="kessler", dt_gcm=80.0, dt_crm_phys=20.0,
          dycore="spam")
NGCM = 2
RUN_TOL = 1e-9


@pytest.fixture()
def dm():
    d = HostDataManager()
    d.finalize()
    yield d
    d.finalize()


# ------------------------------------ tests/test_native_interface.py, mirrored
def test_mirror_zero_copy_roundtrip(dm):
    gcm = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    dm.mirror_array("state", gcm, "GCM state", readonly=False)
    view = dm.get("state")
    assert view.shape == (2, 3, 4)
    assert view.ctypes.data == gcm.ctypes.data
    # a write through the view lands in the GCM's array (zero copy)
    view[1, 2, 3] = 99.0
    assert gcm[1, 2, 3] == 99.0
    # and the other way round
    gcm[0, 0, 0] = -5.0
    assert dm.get("state")[0, 0, 0] == -5.0


def test_readonly_flag(dm):
    gcm = np.ones(5)
    dm.mirror_array("ro", gcm, readonly=True)
    v = dm.get("ro")
    assert not v.flags.writeable
    # the CRM copies a read-only view into its state without a warning
    # (torch.from_numpy warns on a non-writable array)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = torch.tensor(v)
    assert t.data_ptr() != gcm.ctypes.data and bool((t == 1.0).all())


def test_register_allocate_and_dims(dm):
    dm.register_and_allocate("work", (4, 5), np.float64)
    a = dm.get("work")
    assert a.shape == (4, 5)
    assert (a == 0).all()
    assert dm.exists("work")
    dm.unregister("work")
    assert not dm.exists("work")
    dm.register_dimension("z", 50)
    assert dm.get_dimension_size("z") == 50
    assert dm.get_dimension_size("nope") == -1


def test_options(dm):
    dm.set_option("crm_dt", 20.0)
    dm.set_option("nens", 4)
    dm.set_option("micro", "p3")
    dm.set_option("adv", True)
    assert dm.get_option_float("crm_dt") == 20.0
    assert dm.get_option_int("nens") == 4
    assert dm.get_option_str("micro") == "p3"
    assert dm.get_option_bool("adv") is True
    assert dm.option_is_set("crm_dt")
    dm.remove_option("crm_dt")
    assert not dm.option_is_set("crm_dt")
    # int options are 64-bit end to end
    dm.set_option("seed", 2**35 + 7)
    assert dm.get_option_int("seed") == 2**35 + 7
    assert dm.get_option_float("seed") == float(2**35 + 7)
    # missing or wrong-typed lookups raise in Python
    with pytest.raises(KeyError):
        dm.get_option_int("no_such_option")
    with pytest.raises(TypeError):
        dm.get_option_int("micro")
    with pytest.raises(TypeError):
        dm.get_option_str("adv")


def test_mirror_rejects_noncontiguous_and_unsupported(dm):
    big = np.zeros((4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        dm.mirror_array("stride", big[:, ::2], readonly=False)
    with pytest.raises(TypeError, match="int64"):
        dm.mirror_array("ints", np.arange(4), readonly=False)
    with pytest.raises(TypeError, match="unsupported"):
        dm.register_and_allocate("h", (2, 2), dtype=np.int64)


def test_validators_and_dirty(dm):
    a = np.array([1.0, -2.0, np.nan, np.inf])
    dm.mirror_array("v", a, readonly=False)
    assert dm.validate("v", nan=True, inf=False, pos=False) == 1
    assert dm.validate("v", nan=True, inf=True, pos=False) == 2
    assert dm.validate("v", nan=True, inf=True, pos=True) == 3
    dm.clean_all_entries()
    assert not dm.entry_dirty("v")
    _ = dm.get("v")
    assert dm.entry_dirty("v")


# ----------------------------------------------------------- two registries
def test_the_port_builds_its_own_library():
    """The port loads its build of native/pam_interface.cpp from
    pam_tpu_torch/_build, keyed on the source, never
    native/libpam_interface.so."""
    lib = tiface._build_and_load()
    path = tiface.library_path()
    assert lib._name == str(path) and path.exists()
    assert path.parent == tiface.BUILD_DIR and \
        path.name.startswith("libpam_interface_")
    assert os.path.samefile(tiface.SOURCE, os.path.join(
        ROOT, "native", "pam_interface.cpp"))


def test_the_two_registries_are_apart(dm):
    """One process, both packages: what pam_tpu's HostDataManager
    registers the port's does not see, and the other way round."""
    from pam_tpu.interface import HostDataManager as JHostDataManager
    jdm = JHostDataManager()
    try:
        assert os.path.realpath(jdm.lib._name) != \
            os.path.realpath(dm.lib._name)
        jdm.register_dimension("only_jax", 3)
        jdm.set_option("owner", "pam_tpu")
        jdm.mirror_array("jax_field", np.ones(4), readonly=False)
        dm.register_dimension("only_torch", 5)
        dm.set_option("owner", "pam_tpu_torch")
        dm.mirror_array("torch_field", np.zeros(2), readonly=False)
        assert not dm.exists("jax_field") and dm.exists("torch_field")
        assert not jdm.exists("torch_field") and jdm.exists("jax_field")
        assert dm.get_dimension_size("only_jax") == -1
        assert jdm.get_dimension_size("only_torch") == -1
        assert dm.get_option_str("owner") == "pam_tpu_torch"
        assert jdm.get_option_str("owner") == "pam_tpu"
    finally:
        jdm.finalize()


# ------------------------------------------------------------- round trip
def round_trip(dm, drv, state, ngcm):
    """ngcm GCM steps of the CRM driven through the registry
    (tests/test_gcm_native_roundtrip.py): the GCM's host arrays are
    mirrored read-write, with one more that the CRM does not touch; each
    step the CRM state is copied in from the registry views, advanced by
    drv.gcm_step on its device, and written back through the views.
    Checks the views zero-copy, the GCM's arrays untouched until the
    write-back, validate and the dirty flags; returns (final state, the
    GCM's arrays)."""
    nens, nz, nx = state["temp"].shape[0], state["temp"].shape[1], \
        state["temp"].shape[-1]
    for name, n in (("nens", nens), ("nz", nz), ("nx", nx)):
        dm.register_dimension(name, n)
    host = {name: np.array(state[name].cpu().numpy(), dtype=np.float64)
            for name in FIELDS}
    host["gcm_surface_flux"] = np.ones((nens, nx))
    for name, a in host.items():
        dm.mirror_array(name, a, desc=name, readonly=False)
    dm.set_option("micro", "kessler")
    dm.set_option("dt_gcm", drv.dt_gcm)
    assert dm.get_option_str("micro") == "kessler"
    for _ in range(ngcm):
        dm.clean_all_entries()
        views = {name: dm.get(name) for name in FIELDS}
        before = {name: host[name].copy() for name in FIELDS}
        for name in FIELDS:
            assert views[name].ctypes.data == host[name].ctypes.data, name
            # a copy on the way in: the step must not write GCM memory
            state[name] = torch.tensor(views[name], dtype=state[name].dtype,
                                       device=state[name].device)
        state = drv.gcm_step(state)
        for name in FIELDS:
            assert np.array_equal(host[name], before[name]), name
            views[name][...] = state[name].cpu().numpy()
            assert dm.validate(name) == 0, f"{name}: non-finite"
        assert all(dm.entry_dirty(name) for name in FIELDS)
        assert not dm.entry_dirty("gcm_surface_flux")
    return state, host


def _jax_round_trip(ngcm):
    """pam_tpu's round trip of tests/test_gcm_native_roundtrip.py (its
    registry, its jitted gcm_step): (initial state, final state) as
    numpy."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
    from pam_tpu.interface import HostDataManager as JHostDataManager
    drv, state = jax_setup(**KW)
    init = {k: np.array(v) for k, v in state.items()}
    jdm = JHostDataManager()
    try:
        host = {}
        for name in FIELDS:
            host[name] = np.ascontiguousarray(np.asarray(state[name],
                                                         np.float64))
            jdm.mirror_array(name, host[name], desc=name, readonly=False)
        step = jax.jit(drv.gcm_step)
        for _ in range(ngcm):
            views = {name: jdm.get(name) for name in FIELDS}
            for name in FIELDS:
                state[name] = jnp.asarray(views[name], state[name].dtype)
            state = step(state)
            for name in FIELDS:
                views[name][...] = np.asarray(state[name])
    finally:
        jdm.finalize()
    return init, {k: np.array(v) for k, v in state.items()}


def _state(init):
    """The port's state from numpy arrays, in memory of its own."""
    return state_from_numpy({k: v.copy() for k, v in init.items()}, "cpu",
                            torch.float64)


@pytest.fixture(scope="module")
def trips():
    """pam_tpu's round trip and the port's from the same initial state,
    and the port's same steps without the registry."""
    init, ref = _jax_round_trip(NGCM)
    drv, _ = setup_supercell_mmf(**KW, dtype=torch.float64, device="cpu")
    d = HostDataManager()
    d.finalize()
    try:
        got, host = round_trip(d, drv, _state(init), NGCM)
    finally:
        d.finalize()
    plain = _state(init)
    for _ in range(NGCM):
        plain = drv.gcm_step(plain)
    return ref, got, host, plain


def test_round_trip_matches_jax(trips):
    """Every prognostic field after the 2 GCM steps at 1e-9 of pam_tpu's
    round trip; the GCM's arrays hold the port's final state."""
    ref, got, host, _ = trips
    for name in FIELDS:
        r, g = ref[name], got[name].numpy()
        err = float(np.abs(r - g).max()) / max(float(np.abs(r).max()),
                                               1e-300)
        assert err < RUN_TOL, (name, err)
        np.testing.assert_array_equal(host[name], g)
    assert host["temp"].min() > 150.0 and host["temp"].max() < 330.0


def test_round_trip_equals_the_run_without_the_registry(trips):
    """The registry changes nothing: bit for bit the same state as the
    same 2 GCM steps from the same state without it, and the state has
    moved."""
    _, got, _, plain = trips
    for name in plain:
        assert torch.equal(got[name], plain[name]), name
    assert float((got["wvel"]).abs().max()) > 0.0

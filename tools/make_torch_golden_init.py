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
  op (mmf_pamc_small_opbyop.npz) — the stretched-grid SPAM trajectory;
* ideal_<case>_small.npz for the idealized x-z cases risingbubble (CE,
  SSPRK3, dry), gravitywave (CE, SI) and supercell (MCE_rho, SI with 5
  iterations, diffusion and its own reference state): the final (dens, v,
  w) of pam_tpu's run_idealized on configs/input_<case>.yaml cut by
  ideal_small_config (16x12 cells, 2 members, IDEAL_STEPS steps of the
  file's own step). Their initial states are deterministic, so they have
  no _init file;
* ideal_risingbubble3d_small.npz and ideal_supercell3d_small.npz, the 3-D
  (ny > 1) idealized runs: configs/input_<case>.yaml cut to 10x8x10
  cells and 2 members (IDEAL3D_SMALL), risingbubble3d SSPRK3 and
  supercell3d SI through the pressure-gravity system in float64 (its file
  runs float32);
* mmf_spam3d_small: the coupled 3-D SPAM+SI (pressure-gravity) step with
  Kessler at 12x8x12 cells and 2 members (SPAM3D_KW): its _init file and
  3 CRM steps run jitted (mmf_spam3d_small.npz, with vvel);
* ideal_<name>_small.npz for the anelastic and layer-model runs
  (AN_LAYER): configs/input_risingbubble_an.yaml (AN, SSPRK3), the
  moist rising bubble with hamil man (MAN), configs/input_doublevortex.yaml
  (SWE) and its model tswe form, configs/input_bickleyjet.yaml (SWE),
  cut to 16x12 (x-z) or 16x16 (layer) cells and 2 members, 10 steps of
  the file's own step: the final (dens, v, w), or (dens, v) of a layer
  run.

tests/test_torch_mmf.py, tests/test_torch_awfl.py,
tests/test_torch_standalone.py and tests/test_torch_spam3d_runs.py
rebuild the _init files and check them unchanged;
tests/test_torch_spam_ideal_runs.py, tests/test_torch_spam3d_runs.py,
tests/test_torch_anelastic.py and tests/test_torch_layer.py check the
ideal_ files against pam_tpu's run.

Usage: python tools/make_torch_golden_init.py [name ...]
(every config when no name is given; ideal_<case> for an idealized one)
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
           "mmf_pamc_small": ("kessler", "none", "spam"),
           "mmf_spam3d_small": ("kessler", "none", "spam")}
AWFL_NSTEPS = 5
PAMC_SMALL = dict(crm_nx=16, crm_nz=12, nens=2)
# the idealized x-z cut: grid and members, and the steps of each stable
# config (gravitywave 5: its w, a 1-form of ~1, carries the rounding of
# 5e9-sized dens terms, 6e-10 after 5 steps between pam_tpu's own jitted
# and op-by-op runs, 1.4e-9 after 10)
IDEAL_SMALL = dict(crm_nx=16, crm_nz=12, nens=2)
IDEAL_STEPS = {"risingbubble": 10, "densitycurrent": 10, "gravitywave": 5,
               "largerisingbubble": 10, "supercell": 10}
IDEAL_GOLDEN = ("risingbubble", "gravitywave", "supercell")
# the 3-D cut: grid and members, the steps of each config, what else
# changes (the supercell in float64)
IDEAL3D_SMALL = dict(crm_nx=10, crm_ny=8, crm_nz=10, nens=2)
IDEAL3D_STEPS = {"risingbubble3d": 4, "supercell3d": 3}
IDEAL3D_EXTRA = {"supercell3d": dict(f64=True)}
IDEAL3D_GOLDEN = tuple(IDEAL3D_STEPS)
# the anelastic and layer-model cuts: golden name -> (config file, what
# the cut sets besides the grid), the layer grid, the steps of each
AN_LAYER = {"risingbubble_an": ("risingbubble_an", {}),
            "moistrisingbubble_man": ("moistrisingbubble", dict(hamil="man")),
            "doublevortex": ("doublevortex", {}),
            "doublevortex_tswe": ("doublevortex", dict(model="tswe")),
            "bickleyjet": ("bickleyjet", {})}
LAYER_SMALL = dict(crm_nx=16, crm_ny=16, nens=2)
AN_LAYER_STEPS = dict.fromkeys(AN_LAYER, 10)
# the coupled 3-D step: dx = dy = 2 km
SPAM3D_KW = dict(nx=12, ny=8, nz=12, nens=2, xlen=24000.0, ylen=16000.0,
                 zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
                 dt_crm_phys=20.0, dycore="spam")
SPAM3D_NSTEPS = 3
# the trajectories: (config, CRM steps, op by op)
TRAJECTORIES = (("p3_shoc_spam_si", 10, True),
                ("awfl_kessler", AWFL_NSTEPS, False),
                ("awfl_kessler", AWFL_NSTEPS, True),
                ("mmf_pamc_small", 10, False),
                ("mmf_pamc_small", 10, True),
                ("mmf_spam3d_small", SPAM3D_NSTEPS, False))


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


def ideal_small_config(name, nsteps=None):
    """configs/input_<name>.yaml cut by IDEAL_SMALL (IDEAL3D_SMALL and
    IDEAL3D_EXTRA for a 3-D config; AN_LAYER's file and keys, and
    LAYER_SMALL for a layer model, for one of AN_LAYER) to ``nsteps``
    steps (IDEAL_STEPS, IDEAL3D_STEPS or AN_LAYER_STEPS by default) of the
    config's own step: sim_time is set half a step short of nsteps steps,
    so that both packages' ceil(sim_time / dt) takes exactly nsteps."""
    from pam_tpu_torch.driver.standalone import (LAYER_CASES, idealized_dt,
                                                 load_config)
    stem, extra = AN_LAYER.get(name, (name, {}))
    cfg = load_config(os.path.join(os.path.dirname(GOLDEN), "..", "configs",
                                   f"input_{stem}.yaml"))
    layer = cfg["init_data"] in LAYER_CASES
    if name in IDEAL3D_STEPS:
        cfg.update(IDEAL3D_SMALL, **IDEAL3D_EXTRA.get(name, {}))
        steps = IDEAL3D_STEPS
    else:
        cfg.update(LAYER_SMALL if layer else IDEAL_SMALL, **extra)
        steps = AN_LAYER_STEPS if name in AN_LAYER else IDEAL_STEPS
    nsteps = steps[name] if nsteps is None else nsteps
    cfg["sim_time"] = (nsteps - 0.5) * (cfg["dtcrm"] if layer
                                        else idealized_dt(cfg))
    return cfg


def ideal_trajectory(name):
    """pam_tpu's run_idealized of ideal_small_config(name): the final
    dens, v and w (dens and v of a layer model), numpy float64."""
    import numpy as np
    from pam_tpu.driver.standalone import run_idealized
    out = run_idealized(ideal_small_config(name), verbose=False)
    return {k: np.asarray(a) for k, a in zip(("dens", "v", "w"), out)}


def ideal_path(name):
    return os.path.join(GOLDEN, f"ideal_{name}_small.npz")


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
    if name == "mmf_spam3d_small":
        return setup_supercell_mmf(**SPAM3D_KW, dtype=jnp.float64)
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
    if name == "mmf_spam3d_small":
        extra += ("vvel",)
    return {k: np.asarray(state[k]) for k in FIELDS + extra}


def main(argv=None):
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    names = (sys.argv[1:] if argv is None else argv) or \
        list(CONFIGS) + [f"ideal_{n}" for n in IDEAL_GOLDEN + IDEAL3D_GOLDEN
                         + tuple(AN_LAYER)]
    for name in names:
        if name.startswith("ideal_"):
            case = name[len("ideal_"):]
            np.savez_compressed(ideal_path(case), **ideal_trajectory(case))
            print(f"wrote {ideal_path(case)}")
            continue
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

"""Standalone driver: configured MMF runs, as the mmf_simplified executable
runs them, and the idealized SPAM runs: x-z, anelastic, 3-D and the
shallow-water layer models (port of pam_tpu/driver/standalone.py:24-449;
ref standalone/mmf_simplified/driver.cpp).

The MMF config keys (sim_time, crm_nx/ny/nz, nens, xlen/ylen/zlen,
vcoords, dt_gcm, dt_crm_phys, crm_per_phys, out_freq, out_prefix,
io_backend, micro, sgs, dycore, f64, ens_chunk) are those of
configs/input_mmf_*.yaml, the names the reference's YAML inputs use.
``ens_chunk`` is checked as pam_tpu checks it and then not used: pam_tpu
runs a large ensemble in micro-batches, the port runs the whole ensemble
as one program, and the two give the same result. A config with
``idealized: true`` or ``mode: idealized`` (configs/input_<case>.yaml)
runs through run_idealized.

Run:  python -m pam_tpu_torch.driver.standalone <config.yaml>

on the card; ``run_mmf(cfg, device="cpu")`` and
``run_idealized(cfg, device="cpu")`` run on the CPU.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time

import numpy as np
import torch

# YAML 1.1 plain scalars as PyYAML's safe loader resolves them (its
# implicit resolvers, yaml/resolver.py), restricted to the forms this
# parser converts; an int or float written another way raises
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                          "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = re.compile(r"[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# what PyYAML reads as an int or float in a form not converted here
# (binary, octal, hex, base 60)
_OTHER_NUMBER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|"
                           r"[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _scalar(text: str, where: str):
    """A plain or quoted YAML scalar -> bool, int, float, None or str."""
    if text[:1] in ("'", '"'):
        q = text[0]
        if len(text) < 2 or text[-1] != q or q in text[1:-1] or \
                (q == '"' and "\\" in text):
            raise ValueError(f"{where}: unsupported quoted scalar {text!r}")
        return text[1:-1]
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _SPECIAL_FLOAT.fullmatch(text):
        return float(text.lower().replace(".", ""))
    if _OTHER_NUMBER.fullmatch(text):
        raise ValueError(f"{where}: number form {text!r} is not supported")
    if text[0] in "[]{}&*!|>%@`?,#" or text == "-" or \
            text.startswith("- "):
        raise ValueError(f"{where}: {text!r} is not a flat scalar (no "
                         "lists, mappings, anchors, tags or block scalars)")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: nested mapping {text!r}")
    return text


def load_config(path: str) -> dict:
    """The flat ``key: scalar`` mapping of a config file, equal to what
    ``yaml.safe_load`` returns for it (comments, ints, floats such as
    ``20.`` and ``-1.``, booleans, null and strings), with no PyYAML.
    Nesting, lists, flow collections, anchors, tags, block scalars,
    multiple documents and duplicate keys raise ValueError."""
    cfg = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for n, raw in enumerate(lines, 1):
        where = f"{path}:{n}"
        line = raw.rstrip()
        if "\t" in line:
            raise ValueError(f"{where}: tabs are not supported")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0] == " ":
            raise ValueError(f"{where}: indented line (nesting is not "
                             "supported)")
        if line.startswith(("---", "...", "%")):
            raise ValueError(f"{where}: document markers and directives "
                             "are not supported")
        key, sep, rest = line.partition(":")
        if not sep or not _KEY.fullmatch(key):
            raise ValueError(f"{where}: expected 'key: value', got {raw!r}")
        if rest and rest[0] != " ":
            raise ValueError(f"{where}: expected a space after ':'")
        value = rest.strip()
        if value.startswith("#"):
            value = ""
        elif value[:1] not in ("'", '"'):
            # a comment starts at " #" (YAML: # after whitespace)
            m = re.search(r"\s#", value)
            if m:
                value = value[:m.start()].rstrip()
        else:
            end = value.find(value[0], 1)
            tail = value[end + 1:].strip() if end > 0 else ""
            if tail and not tail.startswith("#"):
                raise ValueError(f"{where}: text after a quoted scalar")
            value = value[:end + 1] if end > 0 else value
        if value == "":
            nxt = next((l for l in lines[n:] if l.strip()
                        and not l.lstrip().startswith("#")), "")
            if nxt[:1] in (" ", "-"):
                raise ValueError(f"{where}: nested block under {key!r}")
        if key in cfg:
            raise ValueError(f"{where}: duplicate key {key!r}")
        cfg[key] = _scalar(value, where)
    return cfg


def build_zint(cfg) -> np.ndarray:
    """Vertical interface heights: "uniform" (driver.cpp:137-155, whose
    first and last cells are half cells) or from a NetCDF vcoords file
    (pam_tpu/driver/standalone.py:30-45)."""
    vcoords = cfg.get("vcoords", "uniform")
    if vcoords == "uniform":
        crm_nz = cfg["crm_nz"]
        zlen = cfg.get("zlen", 20000.0)
        dz = zlen / (crm_nz - 1)
        zint = np.empty(crm_nz + 1)
        zint[0] = 0.0
        zint[-1] = zlen
        zint[1:-1] = np.arange(1, crm_nz) * dz - dz / 2
        return zint
    from scipy.io import netcdf_file
    with netcdf_file(vcoords, "r") as f:
        return np.array(f.variables["vertical_interfaces"][:])


def check_ens_chunk(cfg, nens: int):
    """Refuse an ``ens_chunk`` that pam_tpu refuses: "auto", or a divisor
    of nens (pam_tpu/driver/standalone.py:75-83). The port runs the whole
    ensemble in one program whatever it says."""
    chunk = cfg.get("ens_chunk")
    if chunk and chunk != "auto" and nens % int(chunk) != 0:
        raise ValueError(f"ens_chunk={int(chunk)} must divide nens={nens}")


def mmf_setup_kwargs(cfg: dict, device="cuda") -> dict:
    """The arguments of driver/mmf.py::setup_supercell_mmf for config
    ``cfg``, as pam_tpu's run_mmf passes them
    (pam_tpu/driver/standalone.py:55-70), on ``device``."""
    zint = build_zint(cfg)
    return dict(
        nx=cfg["crm_nx"], ny=cfg.get("crm_ny", 1), nz=len(zint) - 1,
        nens=cfg.get("nens", 1), xlen=cfg["xlen"],
        ylen=cfg.get("ylen", 64000.0), zlen=float(zint[-1]),
        micro=cfg.get("micro", "kessler"), sgs=cfg.get("sgs", "none"),
        dt_gcm=cfg.get("dt_gcm", cfg["sim_time"]),
        dt_crm_phys=cfg["dt_crm_phys"], dycore=cfg.get("dycore", "awfl"),
        crm_per_phys=cfg.get("crm_per_phys", 1), zint=zint,
        dtype=torch.float64 if cfg.get("f64", True) else torch.float32,
        device=device)


def run_mmf(cfg: dict, verbose: bool = True, device="cuda"):
    """MMF (supercell column, GCM-forced) run, the non-idealized branch of
    driver.cpp:221-272, on ``device``; returns the final state. Writes
    ``<out_prefix>.nc`` (or ``.h5`` with io_backend hdf5) at t=0 and every
    out_freq seconds of simulated time when out_freq >= 0."""
    from .mmf import setup_supercell_mmf
    from ..io.output import make_writer

    if is_idealized(cfg):
        raise NotImplementedError(
            "an idealized config runs through run_idealized, not run_mmf")
    kw = mmf_setup_kwargs(cfg, device)
    check_ens_chunk(cfg, kw["nens"])
    drv, state = setup_supercell_mmf(**kw)
    out_freq = cfg.get("out_freq", -1.0)
    writer = None
    if out_freq >= 0:
        writer = make_writer(drv.coupler, state, cfg.get("out_prefix", "out"),
                             cfg.get("io_backend", "netcdf"))
        writer.write(state, 0.0)

    t0 = time.time()
    nout = [0]

    def cb(s, etime):
        # multiplication, not division: out_freq == 0 means "write every
        # callback" (the reference's C++ float division yields inf and
        # never writes again; every step is the useful reading of 0)
        if writer is not None and etime >= (nout[0] + 1) * out_freq:
            writer.write(s, etime)
            nout[0] += 1
        if verbose:
            maxw = float(s["wvel"].abs().max())
            print(f"Etime , dtphys, maxw: {etime} , "
                  f"{drv.dt_crm_phys} , {maxw:10.5f}", flush=True)

    try:
        state = drv.run(state, cfg["sim_time"], cb)
    finally:
        if writer is not None:
            writer.close()
    if verbose:
        print(f"Simulation Time: {cfg['sim_time']}")
        print(f"Run Time: {time.time() - t0}")
    return state


# the diffusion coefficients an idealized config may set (ref
# read_model_params_file, extrudedmodel.h:5020-5078; 0 = off)
DIFFUSION_KEYS = ("scalar_horiz_diffusion_coeff",
                  "scalar_vert_diffusion_coeff",
                  "velocity_vort_horiz_diffusion_coeff",
                  "velocity_vort_vert_diffusion_coeff",
                  "velocity_div_horiz_diffusion_coeff",
                  "velocity_div_vert_diffusion_coeff")


# the init_data of the layer models (run_layer)
LAYER_CASES = ("doublevortex", "bickleyjet")


def is_idealized(cfg) -> bool:
    return bool(cfg.get("idealized", False)) or \
        cfg.get("mode") == "idealized"


def idealized_dt(cfg) -> float:
    """The step of an idealized run: ``dtcrm``, else 10 s for the SI
    integrators and the acoustic rule 0.3 min(dx, [dy,] dz) / 350 m/s for
    the explicit ones, on the test case's np.linspace levels, dy =
    Ly / crm_ny in 3-D (pam_tpu/driver/standalone.py:225-227, 374, 385,
    395-396)."""
    from ..spam import testcases as tcs
    if cfg.get("tstype", "ssprk3") in ("si", "si_fixed"):
        return cfg.get("dtcrm", 10.0)
    tc, _ = tcs.testcase_from_string(cfg["init_data"])
    dz = float(np.diff(np.linspace(0.0, tc.Lz, cfg["crm_nz"] + 1)).min())
    dmin = min(tc.Lx / cfg["crm_nx"], dz)
    if cfg.get("crm_ny", 1) > 1:
        dmin = min(dmin, getattr(tc, "Ly", tc.Lx) / cfg["crm_ny"])
    return cfg.get("dtcrm", 0.3 * dmin / 350.0)


def _si_reference(tc, geom, thermo, vs, special_ref, name):
    """The SI reference state: the test case's special one (the
    supercell's), else built from its reference profiles."""
    from ..spam import si as si_mod
    if special_ref is not None:
        return special_ref
    if not hasattr(tc, "refrho_f"):
        raise ValueError(
            f"init_data {name!r} has no reference state for tstype=si")
    return si_mod.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: np.asarray(tc.refnsq_f(z, thermo)), tc.g)


def _with_reference(tend, ref, dtype, device):
    """tend with the SI reference state and the hydrostatic-balance
    correction on."""
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dataclasses.replace(
        tend, force_refstate_hydrostatic_balance=True,
        refdens=T(ref["dens"]), ref_rho_pi=T(ref["rho_pi"]),
        ref_q_pi=T(ref["q_pi"]), ref_rho_di=T(ref["rho_di"]),
        ref_q_di=T(ref["q_di"]), ref_B=T(ref["B"]))


def _numerics_knobs(cfg) -> dict:
    """The reconstruction and upwinding knobs a config may set
    (compile-time in the reference, common.h:72-111)."""
    knobs = {k: str(cfg[k]) for k in ("reconstruction_type",
                                      "dual_upwind_type") if k in cfg}
    if "tanh_upwind_coeff" in cfg:
        knobs["tanh_upwind_coeff"] = float(cfg["tanh_upwind_coeff"])
    return knobs


def _moist_thermo(tc, thermo):
    """The supercell's own thermodynamic constants where it has them."""
    if getattr(tc, "needs_special_init", False):
        return dataclasses.replace(thermo, cst=tc.thermo_constants())
    return thermo


def idealized_setup_3d(cfg, device="cuda"):
    """The pieces of a 3-D (ndims=2, crm_ny > 1) idealized run of config
    ``cfg`` on ``device``, as idealized_setup returns them
    (pam_tpu/driver/standalone.py:160-246): the reference's max_ndims=2
    cases risingbubble, moistrisingbubble and supercell on an x-y-z grid
    (extrudedmodel.h:6195, 7050), SSPRK3 or semi-implicit steps through a
    pressure linear system (``linear_system`` pressure_gravity, the
    default, or pressure; the velocity system is slab-only). The model
    takes its default numerics and ignores the numerics knobs, as
    pam_tpu's does; refuses what the 3-D model has not: diffusion, the
    anelastic variants and the other integrators (pam_tpu ignores the
    keys and takes SSPRK3)."""
    from ..spam import si as si_mod
    from ..spam import testcases as tcs
    from ..spam.extruded3d import Tendencies3D
    from ..spam.geometry import ExtrudedGeometry
    from ..spam.thermo import thermo_from_string
    from ..spam.varset import VariableSet

    name = cfg["init_data"]
    tstype = cfg.get("tstype", "ssprk3")
    unsupported = [k for k in DIFFUSION_KEYS if float(cfg.get(k, 0.0)) > 0]
    if cfg.get("hamil") in ("an", "man"):
        unsupported.append(f"hamil {cfg['hamil']}")
    if tstype not in ("ssprk3", "si"):
        unsupported.append(f"tstype {tstype}")
    if unsupported:
        raise ValueError(f"a 3-D idealized run (crm_ny > 1) takes tstype "
                         f"ssprk3 or si without diffusion or anelastic "
                         f"variants, not: {', '.join(unsupported)}")
    tc, moist = tcs.testcase_from_string(name)
    nx, ny, nz = cfg["crm_nx"], cfg["crm_ny"], cfg["crm_nz"]
    dtype = torch.float64 if cfg.get("f64", True) else torch.float32
    geom = ExtrudedGeometry.build3d(nx, ny, np.linspace(0.0, tc.Lz, nz + 1),
                                    tc.Lx, getattr(tc, "Ly", tc.Lx),
                                    cfg.get("nens", 1), dtype, device)
    thermo = thermo_from_string(cfg.get(
        "thermo", "constkappavirpottemp" if moist else "idealgaspottemp"))
    special_ref = None
    if moist:
        thermo = _moist_thermo(tc, thermo)
        vs = VariableSet(variant="MCE_rho", tracer_names=("water_vapor",),
                         tracer_positive=(True,), geom=geom, thermo=thermo)
        if getattr(tc, "needs_special_init", False):
            dens, v, w, geop, special_ref = tcs.setup_supercell_3d(
                tc, geom, thermo, vs)
        else:
            dens, v, w, geop = tcs.setup_testcase_3d(tc, geom, thermo)
    else:
        vs = VariableSet(variant="CE", geom=geom, thermo=thermo)
        dens, v, w, geop = tcs.setup_testcase_3d(tc, geom, thermo)
    tend = Tendencies3D(geom=geom, varset=vs, thermo=thermo, grav=tc.g)
    dt = idealized_dt(cfg)
    nsteps = int(np.ceil(cfg["sim_time"] / dt))
    if tstype == "si":
        ref = _si_reference(tc, geom, thermo, vs, special_ref, name)
        tend = _with_reference(tend, ref, dtype, geom.device)
        systems = {"pressure": si_mod.CompressiblePressureLinearSystem,
                   "pressure_gravity":
                       si_mod.CompressiblePressureGravityLinearSystem}
        linsys = cfg.get("linear_system", "pressure_gravity")
        if linsys not in systems:
            raise ValueError(f"linear_system {linsys!r}: a 3-D run takes "
                             f"one of {sorted(systems)}")
        lin = systems[linsys].build(geom, thermo, vs, ref, dt)
        iters, nquad = cfg.get("si_max_iters", 3), cfg.get("si_nquad", 2)

        def step(d, vv, ww):
            return si_mod.si_step(tend, lin, d, vv, ww, geop, dt, iters,
                                  nquad)
    else:
        def step(d, vv, ww):
            return tend.ssprk3_step(d, vv, ww, geop, dt)
    return tend, step, (dens, v, w), geop, dt, nsteps


def _anelastic(cfg, tc, moist, geom, thermo, vs, v, w):
    """The anelastic variants (PAMC_HAMIL=an | man;
    pam_tpu/driver/standalone.py:311-350): rho pinned to the reference
    profile, the pressure projection after every symplectic evaluation, no
    acoustic CFL. Returns (tend, dens, v, w): the tendencies, built
    without diffusion or numerics knobs as pam_tpu builds them, and the
    anelastic initial state, its winds (v, w) projected."""
    from ..spam import si as si_mod
    from ..spam import testcases as tcs
    from ..spam.anelastic import (AnelasticPressureSolver,
                                  AnelasticTendencies, ManTendencies,
                                  project_initial)
    name, hamil = cfg["init_data"], cfg["hamil"]
    if not hasattr(tc, "refrho_f"):
        raise ValueError(
            f"init_data {name!r} has no reference state for hamil=an")
    if hamil == "man" and not moist:
        raise ValueError("hamil=man needs a moist init_data")
    ref = si_mod.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: tc.refnsq_f(z, thermo), tc.g)
    psolver = AnelasticPressureSolver.build(geom, ref["rho_pi"],
                                            ref["rho_di"])
    cls = ManTendencies if hamil == "man" else AnelasticTendencies
    tend = _with_reference(cls(geom=geom, varset=vs, thermo=thermo,
                               grav=tc.g, psolver=psolver),
                           ref, geom.dtype, geom.device)
    # the anelastic initial condition: rho = refrho (extrudedmodel.h:
    # 5344-5347; MAN: MoistEulerTestCase rho_f -> refrho_f under
    # PAMC_MAN, :5550-5552)
    rows = [np.broadcast_to(ref["dens"][0][:, :, None],
                            (geom.nens, geom.nz, geom.nx)),
            tcs.project_n1form(lambda x, z: tc.refrho_f(z, thermo) *
                               tc.entropicvar_f(x, z, thermo), geom)]
    if moist:
        rows.append(tcs.project_n1form(
            lambda x, z: tc.rhov_f(x, z, thermo), geom))
    dens = torch.as_tensor(np.stack(rows), dtype=geom.dtype,
                           device=geom.device)
    v, w = project_initial(psolver, v, w)
    return tend, dens, v, w


def idealized_setup(cfg, device="cuda"):
    """The pieces of an idealized run of config ``cfg`` on ``device``
    (pam_tpu/driver/standalone.py:258-402): (tend, step, (dens, v, w),
    geop, dt, nsteps), where ``step(dens, v, w)`` takes one step of the
    config's integrator; crm_ny > 1 builds the 3-D run
    (idealized_setup_3d), hamil an or man the anelastic model
    (_anelastic). A layer test case raises: layer_setup builds it."""
    from ..spam import si as si_mod
    from ..spam import testcases as tcs
    from ..spam.geometry import ExtrudedGeometry
    from ..spam.tendencies import SpamTendencies
    from ..spam.thermo import thermo_from_string
    from ..spam.timesteppers import STEPPERS
    from ..spam.varset import VariableSet

    name = cfg["init_data"]
    if name in LAYER_CASES:
        raise ValueError(f"init_data {name!r} runs the layer model: "
                         "layer_setup or run_layer")
    if cfg.get("crm_ny", 1) > 1:
        return idealized_setup_3d(cfg, device)
    tc, moist = tcs.testcase_from_string(name)
    nx, nz = cfg["crm_nx"], cfg["crm_nz"]
    nens = cfg.get("nens", 1)
    dtype = torch.float64 if cfg.get("f64", True) else torch.float32
    geom = ExtrudedGeometry.build(nx, np.linspace(0.0, tc.Lz, nz + 1),
                                  tc.Lx, nens, dtype, device)
    thermo = thermo_from_string(cfg.get(
        "thermo", "constkappavirpottemp" if moist else "idealgaspottemp"))
    special_ref = None
    if moist:
        thermo = _moist_thermo(tc, thermo)
        vs = VariableSet(variant="MCE_rho", tracer_names=("water_vapor",),
                         tracer_positive=(True,), geom=geom, thermo=thermo)
        if getattr(tc, "needs_special_init", False):
            # supercell: ICs and reference state from the special column
            # init (extrudedmodel.h:7148-7287)
            dens, v, w, geop, special_ref = tcs.setup_supercell(
                tc, geom, thermo, vs)
        else:
            dens, v, w, geop = tcs.setup_moist_testcase(tc, geom, thermo)
    else:
        vs = VariableSet(variant="CE", geom=geom, thermo=thermo)
        dens, v, w, geop = tcs.setup_testcase(tc, geom, thermo)

    # diffusion and numerics knobs (compile-time in the reference,
    # common.h:72-111)
    knobs = {k: float(cfg[k]) for k in DIFFUSION_KEYS if k in cfg}
    tend = SpamTendencies(geom=geom, varset=vs, thermo=thermo, grav=tc.g,
                          **knobs, **_numerics_knobs(cfg))
    if cfg.get("hamil") in ("an", "man"):
        tend, dens, v, w = _anelastic(cfg, tc, moist, geom, thermo, vs, v,
                                      w)

    tstype = cfg.get("tstype", "ssprk3")
    dt = idealized_dt(cfg)
    nsteps = int(np.ceil(cfg["sim_time"] / dt))
    if tstype == "si":
        # the semi-implicit integrator needs the test case's reference
        # state (ref tstype="si", core/params.h:151 + SI_Newton.h)
        ref = _si_reference(tc, geom, thermo, vs, special_ref, name)
        tend = _with_reference(tend, ref, dtype, geom.device)
        lin = si_mod.CompressibleVelocityLinearSystem.build(
            geom, thermo, vs, ref, dt, grav=tc.g)
        iters, nquad = cfg.get("si_max_iters", 3), cfg.get("si_nquad", 2)

        def step(d, vv, ww):
            return si_mod.si_step(tend, lin, d, vv, ww, geop, dt, iters,
                                  nquad)
    elif tstype == "si_fixed":
        # fixed-point SI (SIFixedTimeIntegrator, SI_Fixed.h): no linear
        # solve
        iters, nquad = cfg.get("si_max_iters", 5), cfg.get("si_nquad", 2)

        def step(d, vv, ww):
            return si_mod.si_fixed_step(tend, d, vv, ww, geop, dt, iters,
                                        nquad)
    else:
        if tstype not in STEPPERS:
            raise ValueError(f"unknown tstype {tstype!r}")
        stepper = STEPPERS[tstype]

        def step(d, vv, ww):
            return stepper(lambda x: tend.compute_rhs(*x, geop, dt),
                           (d, vv, ww), dt)
    return tend, step, (dens, v, w), geop, dt, nsteps


def run_idealized(cfg: dict, verbose: bool = True, device="cuda"):
    """Idealized SPAM run (the idealized branch of driver.cpp, test case
    by init_data, extrudedmodel.h testcase_from_string) on ``device``;
    crm_ny > 1 runs the 3-D model (idealized_setup). Returns the final
    (dens, v, w); a layer test case (doublevortex, bickleyjet) runs
    through run_layer and returns (dens, v).
    With ``out_prefix`` set, writes the conservation statistics to
    ``<out_prefix>_stats.nc`` at t=0 and every stat_freq seconds of
    simulated time (not for the layer models, as in pam_tpu)."""
    if cfg["init_data"] in LAYER_CASES:
        return run_layer(cfg, verbose, device)
    return _run_idealized(cfg, idealized_setup(cfg, device), verbose)


def layer_setup(cfg, device="cuda"):
    """The pieces of a layer-model run of config ``cfg`` on ``device``
    (pam_tpu/driver/standalone.py:128-146): (model, step, (dens, v),
    (hs, coriolis), dt, nsteps), where ``step(dens, v)`` takes one SSPRK3
    step. The test case is init_data, the model swe or tswe; float64
    unless the config sets ``f64: false``."""
    from ..spam.layer import LAYER_TESTCASES, LayerModel, setup_double_vortex
    tc = LAYER_TESTCASES[cfg.get("init_data", "doublevortex")]()
    variant = cfg.get("model", "swe")
    if variant not in ("swe", "tswe"):
        raise ValueError(f"unknown layer model {variant!r} "
                         "(expected 'swe' or 'tswe')")
    m = LayerModel(nx=cfg["crm_nx"], ny=cfg.get("crm_ny", cfg["crm_nx"]),
                   nens=cfg.get("nens", 1), Lx=tc.Lx, Ly=tc.Ly, g=tc.g,
                   variant=variant, ndens=2 if variant == "tswe" else 1,
                   dtype=torch.float64 if cfg.get("f64", True)
                   else torch.float32, device=device)
    dens, v, hs, cor = setup_double_vortex(m, tc)
    dt = cfg.get("dtcrm", 120.0)
    nsteps = int(np.ceil(cfg["sim_time"] / dt))

    def step(d, vv):
        return m.ssprk3_step(d, vv, hs, cor, dt)
    return m, step, (dens, v), (hs, cor), dt, nsteps


def run_layer(cfg: dict, verbose: bool = True, device="cuda"):
    """Layer-model (SWE/TSWE) run, doublevortex or bickleyjet
    (layermodel.h:1272-1404; pam_tpu/driver/standalone.py:128-157), on
    ``device``; prints the energy and the mass every stat_freq seconds
    and returns the final (dens, v)."""
    m, step, (dens, v), (hs, cor), dt, nsteps = layer_setup(cfg, device)
    stats_every = max(1, int(cfg.get("stat_freq", cfg["sim_time"] / 10) /
                             dt))
    t0 = time.time()
    for n in range(nsteps):
        dens, v = step(dens, v)
        if verbose and (n + 1) % stats_every == 0:
            st = m.statistics(dens, v, hs, cor)
            print(f"step {n+1} t={dt*(n+1):9.2f}s  E={float(st['E'][0]):.8e} "
                  f"mass={float(st['mass'][0, 0]):.8e}", flush=True)
    if verbose:
        print(f"Run Time: {time.time() - t0}")
    return dens, v


def run_idealized_3d(cfg: dict, verbose: bool = True, device="cuda"):
    """3-D (ndims=2) idealized SPAM run of config ``cfg`` (crm_ny > 1) on
    ``device`` (pam_tpu/driver/standalone.py:160-246; idealized_setup_3d
    builds it); returns the final (dens, v, w), v stacked (vx, vy). The
    statistics file as in run_idealized, with three PV components."""
    return _run_idealized(cfg, idealized_setup_3d(cfg, device), verbose)


def _run_idealized(cfg, setup, verbose):
    from ..io.output import StatsWriter

    tend, step, (dens, v, w), geop, dt, nsteps = setup
    stats_every = max(1, int(cfg.get("stat_freq", cfg["sim_time"] / 10) /
                             dt))
    stats_writer = None
    if cfg.get("out_prefix"):
        st = tend.statistics(dens, v, w, geop)
        stats_writer = StatsWriter(st, dens.shape[1], cfg["out_prefix"])
        stats_writer.write(st, 0.0)
    t0 = time.time()
    try:
        for n in range(nsteps):
            dens, v, w = step(dens, v, w)
            if (n + 1) % stats_every == 0 and (stats_writer is not None
                                               or verbose):
                st = tend.statistics(dens, v, w, geop)
                if stats_writer is not None:
                    stats_writer.write(st, dt * (n + 1))
                if verbose:
                    print(f"step {n+1} t={dt*(n+1):9.2f}s  "
                          f"E={float(st['E'][0]):.8e} "
                          f"mass={float(st['densstat'][0, 0]):.8e}",
                          flush=True)
    finally:
        if stats_writer is not None:
            stats_writer.close()
    if verbose:
        print(f"Run Time: {time.time() - t0}")
    return dens, v, w


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m pam_tpu_torch.driver.standalone "
              "<config.yaml>")
        return 1
    cfg = load_config(argv[0])
    if is_idealized(cfg):
        run_idealized(cfg)
    else:
        run_mmf(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())

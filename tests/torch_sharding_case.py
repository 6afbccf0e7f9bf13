"""Rank workers of the sharding checks, for tests/test_torch_sharding.py
and chip_smoke.py phase 17. Each is run by
``pam_tpu_torch.parallel.mesh.spawn_ranks`` as ``fn(rank, world,
init_method, ...)`` in a process of its own, and returns picklable
results (numpy arrays, numbers). Imports torch and pam_tpu_torch,
nothing of JAX.
"""

import numpy as np
import torch

from pam_tpu_torch.ops import dft, weno_x
from pam_tpu_torch.parallel import comm
from pam_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from pam_tpu_torch.parallel.sharded_step import (sharded_crm_step,
                                                 sharded_dycore_step)

# the small configuration of pam_tpu's tests/test_halo.py
SMALL = dict(nx=16, ny=1, nz=12, nens=8, xlen=32000.0, ylen=64000.0,
             zlen=20000.0, dt_gcm=80.0, dt_crm_phys=20.0)
KEYS = ("temp", "uvel", "wvel", "water_vapor", "density_dry")


def _mesh(rank, world, init, shape, device):
    n_ens, n_y, n_x = shape
    return make_mesh(n_ens, n_x, n_y, device=device, init_method=init,
                     rank=rank, world_size=world)


def _xblock(a, mesh, axis=-1, kind="x"):
    n, c = (mesh.n_x, mesh.x) if kind == "x" else (mesh.n_y, mesh.y)
    b = a.shape[axis] // n
    return a.narrow(axis, c * b, b)


def _same(a, b):
    """0.0 where two tensors are equal bit for bit, else their largest
    difference (inf where the shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    return 0.0 if torch.equal(a, b) else float((a - b).abs().max())


def _rel(a, b):
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale


# ---------------------------------------------------------------------------
# the comm primitives
# ---------------------------------------------------------------------------

def primitives(rank, world, init, device="cpu", dtype=torch.float64):
    """Every primitive of parallel/comm.py and the sharded DFTs on meshes
    (2, 1, world/2), (1, 1, world) and (world/4, 2, 2), against the global
    computation on this rank's block. Returns {check: error}: 0.0 for the
    checks that must be bit-exact, relative errors for the transforms."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    err = {}
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)

    # mesh (2, 1, 4): ens 2 x x 4
    mesh = _mesh(rank, world, init, (2, 1, world // 2), device)
    a = T(rng.standard_normal((4, 3, 16)))
    loc = _xblock(a, mesh)
    with comm.axis_ctx(mesh, x=True):
        out = comm.proll(loc, 2) + 2.0 * comm.proll(loc, -3)
        err["proll"] = _same(out, _xblock(torch.roll(a, -2, -1) +
                                          2.0 * torch.roll(a, 3, -1), mesh))
        pad = comm.halo_pad(loc, 2)
        idx = torch.arange(-2, loc.shape[-1] + 2) + mesh.x * loc.shape[-1]
        err["halo_pad"] = _same(pad, a[..., idx % a.shape[-1]])
        # integer values: every sum is exact in any order
        c = T(rng.integers(-50, 50, (4, 3, 1, 16)))
        cl = _xblock(c, mesh)
        err["psum_h"] = _same(comm.psum_h(cl, (-2, -1)), c.sum((-2, -1)))
        err["pmean_h"] = _same(comm.pmean_h(cl, (-2, -1)),
                               c.mean((-2, -1)))
        err["pmax_h"] = _same(comm.pmax_h(cl), c.max())
        err["pmin_h"] = _same(comm.pmin_h(cl, (-2, -1)),
                              c.amin((-2, -1)))
        # transposes: (ens, z, x) with ens split over x, and back
        e = T(rng.standard_normal((8, 3, 16)))
        el = _xblock(e, mesh)
        t = comm.transpose_to_x_local(el, 0, 2)
        nb = 8 // mesh.n_x
        err["transpose_to_x_local"] = _same(
            t, e[mesh.x * nb:(mesh.x + 1) * nb])
        with comm.x_local():
            tab = T(np.arange(8.0))
            err["local_ens_xblock"] = _same(
                comm.local_ens_xblock(tab), tab[mesh.x * nb:(mesh.x + 1) * nb])
            t = torch.fft.irfft(torch.fft.rfft(t, dim=-1), n=16, dim=-1)
        back = comm.transpose_from_x_local(t, 0, 2)
        err["transpose_round_trip"] = _rel(back, el)
        # the psum-DFT against torch.fft on the whole axis
        err["fft_sh"] = _rel(dft.fft_sh(loc), torch.fft.fft(a))
        spec = torch.fft.fft(a)
        err["ifft_real_sh"] = _rel(dft.ifft_real_sh(spec),
                                   _xblock(torch.fft.ifft(spec).real, mesh))
        err["rfft_sh"] = _rel(dft.rfft_sh(loc), torch.fft.rfft(a))
        rs = torch.fft.rfft(a)
        err["irfft_sh"] = _rel(dft.irfft_sh(rs, 16),
                               _xblock(torch.fft.irfft(rs, n=16), mesh))
        err["local_xslice"] = _same(comm.local_xslice(a), loc)
    counts = dict(mesh.counts)

    # mesh (1, 1, world): every rank along x, shards of 2 columns
    mesh8 = _mesh(rank, world, init, (1, 1, world), device)
    b = T(rng.standard_normal((4, 2 * world)))
    bl = _xblock(b, mesh8)
    with comm.axis_ctx(mesh8, x=True):
        # a halo of 3: two hops
        idx = torch.arange(-3, 5) + mesh8.x * 2
        err["halo_pad_multihop"] = _same(comm.halo_pad(bl, 3),
                                         b[..., idx % b.shape[-1]])
        err["proll_all_x"] = _same(comm.proll(bl, -1),
                                   _xblock(torch.roll(b, 1, -1), mesh8))

    # mesh (world/4, 2, 2): y and x split, (nens, nz, ny, nx) fields
    mesh_yx = _mesh(rank, world, init, (world // 4, 2, 2), device)
    f = T(rng.standard_normal((2, 3, 8, 8)))
    fl = _xblock(_xblock(f, mesh_yx, -2, "y"), mesh_yx, -1, "x")
    with comm.axis_ctx(mesh_yx, x=True, y=True):
        err["proll_y"] = _same(comm.proll_y(fl, 1), _xblock(_xblock(
            torch.roll(f, -1, -2), mesh_yx, -2, "y"), mesh_yx, -1, "x"))
        g = T(rng.integers(-50, 50, (2, 3, 8, 8)))
        gl = _xblock(_xblock(g, mesh_yx, -2, "y"), mesh_yx, -1, "x")
        err["psum_h_yx"] = _same(comm.psum_h(gl, (-2, -1)), g.sum((-2, -1)))
        # a y halo on a view with y moved last
        pad = comm.halo_pad(fl.movedim(-2, -1), 2, axis=-1, kind="y")
        idx = torch.arange(-2, 6) + mesh_yx.y * 4
        ref = _xblock(f, mesh_yx, -1, "x")[..., idx % 8, :].movedim(-2, -1)
        err["halo_pad_y_view"] = _same(pad, ref)
    return dict(err=err, counts=counts)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def setup(device="cpu", dtype=torch.float64, state=None, **kw):
    """The port's driver and forced state at ``SMALL`` (updated by kw);
    ``state`` (numpy) replaces the port's own start state."""
    from pam_tpu_torch.convert import state_from_numpy
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    cfg = dict(SMALL, micro="kessler", dycore="spam")
    cfg.update(kw)
    drv, st = setup_supercell_mmf(**cfg, dtype=dtype, device=device)
    if state is not None:
        return drv, state_from_numpy(state, device, dtype)
    return drv, gcm_forcing.compute_gcm_forcing_tendencies(
        drv.coupler, st, drv.dt_gcm)


def explicit_3d(dycore):
    """The coupled 3-D SPAM dycore without its SI system: SSPRK3
    substeps at the acoustic CFL."""
    import dataclasses
    return dataclasses.replace(dycore, si_linsys=None)


def rain_in_x(state):
    """Heavy rain in one x column of levels 2-7 (pam_tpu's
    test_explicit_kessler_rainsplit_min_spans_shards)."""
    st = dict(state)
    pr = st["precip_liquid"].clone()
    pr[:, 2:8, :, 3] = 4e-3 * st["density_dry"][:, 2:8, :, 3]
    st["precip_liquid"] = pr
    return st


def rain_in_first_half(state):
    """Heavy rain only in the first half of the members
    (test_explicit_kessler_rainsplit_ens_varying)."""
    st = dict(state)
    h = st["temp"].shape[0] // 2
    pr = torch.zeros_like(st["precip_liquid"])
    pr[:h, 2:8, :, 3] = 4e-3 * st["density_dry"][:h, 2:8, :, 3]
    st["precip_liquid"] = pr
    return st


def layer_case(device="cpu", nx=8, ny=8):
    """The SWE double vortex with seeded noise on h, v and hs: (model,
    (dens, v, hs, coriolis))."""
    from pam_tpu_torch.spam import layer
    tc = layer.DoubleVortex()
    m = layer.LayerModel(nx=nx, ny=ny, nens=2, Lx=tc.Lx, Ly=tc.Ly, g=tc.g,
                         dtype=torch.float64, device=device)
    dens, v, hs, cor = layer.setup_double_vortex(m, tc)
    rng = np.random.default_rng(7)
    dens = dens * (1.0 + 1e-2 * torch.as_tensor(
        rng.standard_normal(tuple(dens.shape)), device=device))
    v = v * (1.0 + 0.1 * torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                         device=device))
    hs = 0.05 * dens[0] * torch.as_tensor(rng.random(tuple(hs.shape)),
                                          device=device)
    return m, (dens, v, hs, cor)


def _np(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


def _run(drv, state, mesh, nsteps=1, x_axis="x", y_axis=None,
         every=False):
    """nsteps sharded CRM steps from a global state; returns (the gathered
    global state, or with ``every`` the list of them after each step, the
    collective counts of the steps alone)."""
    step, place = sharded_crm_step(drv, mesh, x_axis=x_axis, y_axis=y_axis)
    st = place(state)
    counts = dict.fromkeys(mesh.counts, 0)
    outs = []
    for i in range(nsteps):
        mesh.reset_counts()
        st = step(st)
        for k, v in mesh.counts.items():
            counts[k] += v
        if every or i == nsteps - 1:
            outs.append(gather_state(mesh, st))
    return (outs if every else outs[-1]), counts


def steps(rank, world, init, kessler_state, device="cpu",
          dtype=torch.float64):
    """The CRM and dycore steps of pam_tpu's tests/test_halo.py on 8 ranks
    of one host. ``kessler_state``: the numpy start state of the SPAM+SI
    Kessler cases. Rank 0 returns the gathered outputs, every rank its
    collective counts and AWFL sub-cycles."""
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.spam.dycore import exact_inverse_avg
    out, counts = {}, {}
    m24 = _mesh(rank, world, init, (2, 1, 4), device)
    drv, st = setup(device, dtype, state=kessler_state)
    out["spam_kessler"], counts["x4"] = _run(drv, st, m24)
    out["rain_x"], _ = _run(drv, rain_in_x(st), m24)
    out["rain_ens"], _ = _run(drv, rain_in_first_half(st), m24)
    m_ens = _mesh(rank, world, init, (8, 1, 1), device)
    out["ens_only"], counts["ens_only"] = _run(drv, st, m_ens, x_axis=None)
    for nx_sh, shape in ((2, (4, 1, 2)), (8, (1, 1, 8))):
        _, counts[f"x{nx_sh}"] = _run(drv, st, _mesh(rank, world, init,
                                                     shape, device))
    m42 = _mesh(rank, world, init, (4, 1, 2), device)
    dstep = sharded_dycore_step(drv.dycore, m42, 20.0)
    out["dycore"] = gather_state(m42, dstep(shard_state(m42, st)))
    # exact_inverse_avg refuses x sharding
    with comm.axis_ctx(m24, x=True):
        try:
            exact_inverse_avg(st["uvel"][..., :3])
            counts["exact_inverse_refusal"] = ""
        except NotImplementedError as e:
            counts["exact_inverse_refusal"] = str(e)

    drv_p3, st_p3 = setup(device, dtype, micro="p3", sgs="shoc")
    out["p3_shoc"], _ = _run(drv_p3, st_p3, m24)
    drv_aw, st_aw = setup(device, dtype, dycore="awfl")
    c0 = AwflDycore.timestep.cycles
    out["awfl"], _ = _run(drv_aw, st_aw, m24)
    counts["awfl_cycles"] = AwflDycore.timestep.cycles - c0

    # 3-D: the coupled step on x 2, and the SI solve refusing y sharding
    drv3, st3 = setup(device, dtype, nx=8, ny=4, nz=8, nens=4, xlen=16000.0,
                      ylen=8000.0, zlen=16000.0)
    out["spam3d_x2"], _ = _run(drv3, st3, m42)
    m222 = _mesh(rank, world, init, (2, 2, 2), device)
    try:
        _run(drv3, st3, m222, y_axis="y")
        counts["y_si_refusal"] = ""
    except NotImplementedError as e:
        counts["y_si_refusal"] = str(e)
    # the explicit (SSPRK3) 3-D dycore runs with y sharded too
    dyc3 = explicit_3d(drv3.dycore)
    dstep = sharded_dycore_step(dyc3, m222, 20.0, y_axis="y")
    out["dycore3d_y2x2"] = gather_state(m222, dstep(shard_state(m222, st3)))
    # Tendencies3D.compute_rhs on (y 2, x 2), each ensemble half alike
    from torch_spam3d_case import oracle_case_3d
    tend, x3, _ = oracle_case_3d(device, nx=8, ny=8, nz=6)
    args = [torch.as_tensor(a, device=device) for a in x3]
    loc = [_xblock(_xblock(a, m222, -2, "y"), m222, -1, "x") for a in args]
    with comm.axis_ctx(m222, x=True, y=True):
        rhs = tend.compute_rhs(*loc, 0.5)
    counts["compute_rhs"] = [r.cpu().numpy() for r in rhs]
    counts["coords"] = (m222.y, m222.x)
    # the layer model (SWE, double vortex) on (y 2, x 2)
    lm, lx = layer_case(device)
    loc = [_xblock(_xblock(a, m222, -2, "y"), m222, -1, "x") for a in lx]
    with comm.axis_ctx(m222, x=True, y=True):
        counts["layer_rhs"] = [r.cpu().numpy()
                               for r in lm.compute_rhs(*loc)]
    # the anelastic model (AN, rising bubble) on x 2: the projection's
    # psum-DFT after the symplectic evaluation
    from torch_anelastic_case import an_case
    tend, xa, _, _ = an_case(device, "an", nx=8)
    loc = [_xblock(torch.as_tensor(a, device=device), m42) for a in xa]
    with comm.axis_ctx(m42, x=True):
        counts["an_rhs"] = [r.cpu().numpy()
                            for r in tend.compute_rhs(*loc, 0.5)]
        counts["an_project"] = [r.cpu().numpy()
                                for r in tend.psolver.project(*loc[1:3])]
    counts["x_coord42"] = m42.x
    result = dict(counts=counts)
    if rank == 0:
        result["out"] = {k: _np(v) for k, v in out.items()}
    return result


def host_chunks(rank, world, init, kessler_state):
    """Host micro-batching through the sharded step (pam_tpu's
    test_explicit_sharded_step_composes_with_host_chunking): the SMALL
    SPAM+SI Kessler state of 8 members split into 2 chunks of 4, each
    stepped by a driver built at 4 through ``sharded_crm_step`` on mesh
    (ens 2, x 2) and gathered. Rank 0 returns the joined state."""
    from pam_tpu_torch.driver.mmf import _join_ens, _split_ens
    mesh = _mesh(rank, world, init, (2, 1, 2), "cpu")
    drv, st = setup(state=kessler_state, nens=SMALL["nens"] // 2)
    step, place = sharded_crm_step(drv, mesh)
    out = _join_ens([gather_state(mesh, step(place(c)))
                     for c in _split_ens(st, 2)])
    return {"out": _np(out)} if rank == 0 else {}


def raise_on_rank_one(rank, world, init):
    """Rank 1 raises while the others wait in an all_reduce that it never
    joins (the launcher's fail-fast check)."""
    mesh = _mesh(rank, world, init, (1, 1, world), "cpu")
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    with comm.axis_ctx(mesh, x=True):
        return float(comm.pmax_h(torch.ones(3)))


def payload_bytes(rank, world, init):
    """Mesh.counts and Mesh.bytes after each of: one halo_pad (h 3) of a
    (2, 3, 1, 4) float64 block along x, the same of a float32 block, a
    halo_pad (h 6) wider than the block (fetched over two hops), and a
    pmean_h of a (2, 3, 1, 4) float64 block over (-2, -1); and after
    reset_counts. On mesh (1, 1, world)."""
    mesh = _mesh(rank, world, init, (1, 1, world), "cpu")
    out = []
    a = torch.arange(24, dtype=torch.float64).reshape(2, 3, 1, 4)
    with comm.axis_ctx(mesh, x=True):
        for fn in (lambda: comm.halo_pad(a, 3),
                   lambda: comm.halo_pad(a.float(), 3),
                   lambda: comm.halo_pad(a, 6),
                   lambda: comm.pmean_h(a, (-2, -1))):
            mesh.reset_counts()
            fn()
            out.append((dict(mesh.counts), dict(mesh.bytes)))
    mesh.reset_counts()
    out.append((dict(mesh.counts), dict(mesh.bytes)))
    return out


# ---------------------------------------------------------------------------
# chip_smoke.py phase 17: the ranks on one card
# ---------------------------------------------------------------------------

# 17c: (case, setup keywords, steps, mesh (ens, y, x)); f64, each held
# against the unsharded step on the card
CHIP_SLAB = dict(nx=64, ny=1, nz=50, nens=8, xlen=128000.0, ylen=64000.0,
                 zlen=20000.0, dt_gcm=900.0, dt_crm_phys=20.0)
CHIP_CASES = (
    ("spam_kessler", dict(CHIP_SLAB), 5, (2, 1, 2)),
    ("p3_shoc", dict(CHIP_SLAB, micro="p3", sgs="shoc"), 3, (2, 1, 2)),
    ("awfl_kessler", dict(CHIP_SLAB, dycore="awfl"), 3, (2, 1, 2)),
    ("spam3d_kessler", dict(CHIP_SLAB, nx=32, ny=32, nens=4, xlen=64000.0,
                            ylen=64000.0), 3, (1, 1, 4)),
)
RHS_3D = dict(nx=32, ny=32, nz=24)   # Tendencies3D.compute_rhs on (y 2, x 2)
PROD_STEPS = 10


def _counters():
    """The kernels' launch counters and AWFL's sub-cycles, by name."""
    from pam_tpu_torch.dycore.awfl import AwflDycore
    from pam_tpu_torch.ops import awfl_fct, awfl_flux, p3_part2
    return {"weno_x": (weno_x.weno_edges_x_cuda, "launches"),
            "weno_x_padded": (weno_x.weno_edges_x_cuda, "launches_padded"),
            "p3_part2": (p3_part2.p3_part2_cuda, "launches"),
            "awfl_flux": (awfl_flux.flux_direction_cuda, "launches"),
            "awfl_fct": (awfl_fct.fct_limit_cuda, "launches"),
            "sub_cycles": (AwflDycore.timestep, "cycles")}


def _reset():
    for obj, attr in _counters().values():
        setattr(obj, attr, 0)


def _read():
    return {k: getattr(obj, attr) for k, (obj, attr) in _counters().items()}


def chip_phase(rank, world, init, paths):
    """Phase 17 on ``world`` ranks (host-staged gloo on one card, NCCL on
    a card each): 17b the primitives on CUDA tensors; 17c the sharded
    f64 steps of CHIP_CASES and Tendencies3D.compute_rhs at RHS_3D from
    the start states saved at ``paths[case]`` (rank 0 returns the
    gathered state after each step); 17d the CRM step of
    ``paths["production_cfg"]`` ensemble-sharded, PROD_STEPS steps from
    ``paths["production"]``, each rank's members against the unsharded
    run saved at ``paths["production_ref"]`` and bit for bit against
    them stepped alone (``paths["production_block<e>"]``)."""
    import time
    import torch.distributed as dist
    from pam_tpu_torch.driver import standalone
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from torch_spam3d_case import oracle_case_3d
    res = {"prims": primitives(rank, world, init, device="cuda")}
    out = {}
    for name, kw, nsteps, shape in CHIP_CASES:
        mesh = _mesh(rank, world, init, shape, "cuda")
        drv, st = setup("cuda", torch.float64,
                        state=dict(np.load(paths[name])), **kw)
        torch.cuda.synchronize()
        _reset()
        got, counts = _run(drv, st, mesh, nsteps, every=True)
        res[name] = dict(counts=counts, launches=_read(),
                         backend=mesh.backend)
        if rank == 0:
            out[name] = [_np(g) for g in got]
        del drv, st, got
    m122 = _mesh(rank, world, init, (world // 4, 2, 2), "cuda")
    tend, x3, _ = oracle_case_3d("cuda", **RHS_3D)
    loc = [_xblock(_xblock(torch.as_tensor(a, device="cuda"), m122, -2, "y"),
                   m122, -1, "x") for a in x3]
    _reset()
    with comm.axis_ctx(m122, x=True, y=True):
        rhs = tend.compute_rhs(*loc, 0.5)
    torch.cuda.synchronize()
    res["rhs3d"] = dict(rhs=[r.cpu().numpy() for r in rhs],
                        coords=(m122.y, m122.x), launches=_read())
    # 17d: the production configuration, ensemble only
    cfg = standalone.load_config(paths["production_cfg"])
    drv, _ = setup_supercell_mmf(**standalone.mmf_setup_kwargs(cfg, "cuda"))
    mesh = _mesh(rank, world, init, (world, 1, 1), "cuda")
    step, place = sharded_crm_step(drv, mesh, x_axis=None)
    st = place({k: torch.as_tensor(v) for k, v in
                np.load(paths["production"]).items()})
    torch.cuda.synchronize()
    dist.barrier()
    mesh.reset_counts()
    _reset()
    t0 = time.perf_counter()
    ticks = [t0]
    for _ in range(PROD_STEPS):
        st = step(st)
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
    dist.barrier()
    t_all = time.perf_counter() - t0
    ref = place({k: torch.as_tensor(v) for k, v in
                 np.load(paths["production_ref"]).items()})
    err = {k: (float((st[k] - ref[k]).abs().max()),
               float(ref[k].abs().max()),
               bool(torch.isfinite(st[k]).all()))
           for k in st if st[k].is_floating_point()}
    # the block against the same members stepped alone
    alone = np.load(paths[f"production_block{mesh.e}"])
    block = all(torch.equal(st[k].cpu(), torch.as_tensor(alone[k]))
                for k in st)
    res["production"] = dict(counts=dict(mesh.counts), launches=_read(),
                             block_bit_equal=block,
                             ms_steps=np.diff(ticks) * 1e3,
                             ms_all=t_all / PROD_STEPS * 1e3, err=err,
                             nens_local=int(st["temp"].shape[0]))
    if rank == 0:
        res["out"] = out
    return res

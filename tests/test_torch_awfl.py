"""The port's AWFL dycore (PAM-A) against pam_tpu, against the numpy
oracle tests/awfl_oracle.py, and, on the card, its CUDA flux kernel
against the plain version.

Inputs are made with numpy from a seed and go through the JAX function
and its counterpart in the port; each test states its tolerance. f64
unless said. JAX is imported inside the tests that use it, so that the
card-side cases run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_awfl.py
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
from pam_tpu_torch.core.coupler import Coupler
from pam_tpu_torch.dycore import awfl_init
from pam_tpu_torch.dycore.awfl import AwflDycore
from pam_tpu_torch.ops import awfl_flux, recon_matrices as rm, weno, weno5

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import b3_inputs  # noqa: E402  (seeded flux inputs)
GOLDEN = os.path.join(HERE, "golden")
AX_Y, AX_Z, AX_X = awfl_flux.AX_Y, awfl_flux.AX_Z, awfl_flux.AX_X
# kernel vs plain, relative to each output's largest |value|: the kernel
# evaluates the limiter of csrc/weno5.cuh (merged constants, one
# reciprocal per normalisation, multiply-adds), so it agrees to rounding
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _stretched(nz):
    return 300.0 * (1.0 + 0.35 * np.sin(np.arange(nz)))


# ------------------------------------------------------------- matrices
@pytest.mark.parametrize("grid", ["uniform", "stretched"])
def test_recon_matrices_match_jax(grid):
    """sten_to_coefs / weno_lower_sten_to_coefs with edge locations and
    vertical_recon_matrices, at 1e-14 of each matrix's largest entry; on
    a uniform grid the integer-order form stays bit-equal to pam_tpu's."""
    from pam_tpu.ops import recon_matrices as jrm
    dz = np.full(7, 400.0) if grid == "uniform" else _stretched(7)
    locs = np.concatenate(([0.0], np.cumsum(dz[:5] / dz[2])))
    locs -= 0.5 * (locs[2] + locs[3])
    assert _rel(jrm.sten_to_coefs(locs), rm.sten_to_coefs(locs)) < 1e-14
    assert _rel(jrm.weno_lower_sten_to_coefs(locs),
                rm.weno_lower_sten_to_coefs(locs)) < 1e-14
    for dzin in (dz, np.stack([dz, 1.5 * dz[::-1]])):
        js2c, jwrl = jrm.vertical_recon_matrices(dzin, 5)
        s2c, wrl = rm.vertical_recon_matrices(dzin, 5)
        assert s2c.shape == dzin.shape[:-1] + (9, 5, 5)
        assert _rel(js2c, s2c) < 1e-14 and _rel(jwrl, wrl) < 1e-14
    np.testing.assert_array_equal(jrm.sten_to_coefs(5), rm.sten_to_coefs(5))
    np.testing.assert_array_equal(jrm.weno_lower_sten_to_coefs(5),
                                  rm.weno_lower_sten_to_coefs(5))
    if grid == "uniform":   # every level's matrix is the uniform one
        s2c, wrl = rm.vertical_recon_matrices(dz, 5)
        np.testing.assert_array_equal(s2c[3], rm.sten_to_coefs(5))
        np.testing.assert_array_equal(wrl[0], rm.weno_lower_sten_to_coefs(5))


# ------------------------------------------------- face reconstructions
def _recon_case(axis, per_level, seed):
    """A (2, nens, ny, nz, nx) field padded along ``axis`` and, for
    per_level, stretched-grid matrices with the level axis on ``axis``."""
    rng = np.random.default_rng(seed)
    nens, shape = 2, [3, 4, 6]
    n = shape[axis - 2]
    shape[axis - 2] = n + 6
    u = rng.standard_normal([2, nens] + shape) + 3.0 * np.sin(
        np.arange(shape[2]) / 3.0)
    upw = rng.random([1, nens] + [s - 5 if i == axis - 2 else s
                                  for i, s in enumerate(shape)]) < 0.5
    mats = None
    if per_level:
        s2c, wrl = rm.vertical_recon_matrices(
            np.stack([_stretched(n), 1.3 * _stretched(n)[::-1]]), 5)
        # matrix dims leading, then (nens, ., ., .) with the levels on axis
        tail = tuple(n + 2 if i == axis - 2 else 1 for i in range(3))
        lead = lambda a, k: np.moveaxis(
            a, tuple(range(2, 2 + k)), tuple(range(k))).reshape(
                a.shape[2:] + (nens,) + tail)
        mats = (lead(s2c, 2), lead(wrl, 3))
    return u, upw, mats, axis - 5


@pytest.mark.parametrize("per_level", [False, True])
@pytest.mark.parametrize("axis", [AX_Y, AX_Z, AX_X])
def test_face_reconstructions_match_jax(axis, per_level):
    """reconstruct_faces_both / _upwind, uniform and per-level matrices,
    along x, y and z: 1e-13 of the field's largest |value|."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    u, upw, mats, lev = _recon_case(axis, per_level, seed=axis)
    jt = jweno.weno_tables(5, dtype=jnp.float64)
    tt = weno.weno_tables(5, torch.float64)
    jm = None if mats is None else tuple(jnp.asarray(m) for m in mats)
    tm = None if mats is None else tuple(torch.from_numpy(
        np.ascontiguousarray(m)) for m in mats)
    ref = jweno.reconstruct_faces_both(jnp.asarray(u), axis, jt, per_level=jm,
                                       per_level_axis=lev)
    got = weno.reconstruct_faces_both(torch.from_numpy(u), axis, tt,
                                      per_level=tm, per_level_axis=lev)
    scale = float(np.abs(u).max())
    for r, g in zip(ref, got):
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-13 * scale
    ref = jweno.reconstruct_faces_upwind(jnp.asarray(u), axis, jt,
                                         jnp.asarray(upw), per_level=jm,
                                         per_level_axis=lev)
    got = weno.reconstruct_faces_upwind(torch.from_numpy(u), axis, tt,
                                        torch.from_numpy(upw), per_level=tm,
                                        per_level_axis=lev)
    assert np.abs(np.asarray(ref) - got.numpy()).max() < 1e-13 * scale


# ---------------------------------------------------- the flux, one call
def _jnp_direction(prim, trac, pres, axis, jt, per_level):
    """direction(axis) of pam_tpu/dycore/awfl.py:336-389 on sliced
    inputs, through pam_tpu's weno.reconstruct_faces_* as it calls them."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    cs = 350.0
    mom_id = {AX_X: 1, AX_Y: 2, AX_Z: 3}[axis]
    kw = dict(per_level=per_level if axis == AX_Z else None,
              per_level_axis=-2)
    ru_fld = prim[0] * prim[mom_id]
    ruL, ruR = jweno.reconstruct_faces_both(ru_fld[None], axis, jt, **kw)
    ppL, ppR = jweno.reconstruct_faces_both(pres[None], axis, jt, **kw)
    ruL, ruR, ppL, ppR = ruL[0], ruR[0], ppL[0], ppR[0]
    if axis == AX_Z:
        nf = ruL.shape[2]
        mask = jnp.zeros((nf,), bool).at[0].set(True).at[-1].set(True)
        mask = mask[None, None, :, None]
        ruL = jnp.where(mask, 0.0, ruL)
        ruR = jnp.where(mask, 0.0, ruR)
    w1 = 0.5 * (ppR - cs * ruR)
    w2 = 0.5 * (ppL + cs * ruL)
    pp = w1 + w2
    ru = (w2 - w1) / cs
    if axis == AX_Z:
        ru = jnp.where(mask, 0.0, ru)
    upw = ru > 0
    q = jnp.concatenate([prim[1:], trac], axis=0)
    vals = jweno.reconstruct_faces_upwind(q, axis, jt, upw[None], **kw)
    flux_q = (ru[None] * vals).at[mom_id - 1].add(pp)
    return jnp.concatenate([ru[None], flux_q[:4]]), flux_q[4:]


@pytest.mark.parametrize("ntr", [0, 3])
@pytest.mark.parametrize("axis", [AX_Y, AX_Z, AX_X])
def test_flux_reference_matches_jnp_direction(axis, ntr):
    """flux_direction_reference against the jnp path of pam_tpu's
    ``direction``, x, y and z (stretched dz, per-level matrices, rigid-lid
    mask), with and without tracers: 1e-12 of each output's max."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    prim, trac, pres, levels = b3_inputs(
        2, 3, 5, 7, ntr, axis, torch.float64, "cpu", seed=10 * axis + ntr)
    jl = None if levels is None else (jnp.asarray(levels.s2c.numpy()),
                                      jnp.asarray(levels.wrl.numpy()))
    sref, tref = _jnp_direction(
        jnp.asarray(prim.numpy()), jnp.asarray(trac.numpy()),
        jnp.asarray(pres.numpy()), axis, jweno.weno_tables(5, jnp.float64),
        jl)
    before = awfl_flux.flux_direction_cuda.launches
    sgot, tgot = awfl_flux.flux_direction(
        prim, trac, pres, axis, weno.weno_tables(5, torch.float64), levels)
    assert awfl_flux.flux_direction_cuda.launches == before
    assert tgot.shape[0] == ntr
    for v in range(5):
        assert _rel(sref[v], sgot[v].numpy()) < 1e-12, v
    for v in range(ntr):
        assert _rel(tref[v], tgot[v].numpy()) < 1e-12, v
    # winds of both signs: both upwind branches are taken
    frac = float((sgot[0] > 0).double().mean())
    assert 0.1 < frac < 0.9


def test_flux_reference_matches_pallas_kernel():
    """flux_direction_reference against the TPU kernel itself,
    pam_tpu/ops/awfl_pallas.py::flux_direction_fused in interpret mode:
    the z direction (per-level matrices, mask on) in float32, rtol 2e-5 of
    each output's max as tests/test_awfl_pallas.py holds it."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from pam_tpu.ops import awfl_pallas
    nens, ny, nz, nx, ntr = 2, 1, 6, 8, 3
    prim, trac, pres, levels = b3_inputs(
        nens, ny, nz, nx, ntr, AX_Z, torch.float32, "cpu", seed=5)
    sgot, tgot = awfl_flux.flux_direction_reference(
        prim, trac, pres, AX_Z, weno.weno_tables(5, torch.float32), levels)
    # the TPU layout: stencil axis last, everything else flattened to rows
    rows = lambda a: np.ascontiguousarray(
        np.swapaxes(a.numpy(), -1, -2)).reshape(a.shape[0], -1, nz + 6)
    # one set for all members: (nz+2, 25) s2c[c][s] and (nz+2, 27) wrl
    s2c = levels.s2c[:, :, 0, 0, :, 0].permute(2, 0, 1).reshape(nz + 2, 25)
    wrl = levels.wrl[:, :, :, 0, 0, :, 0].permute(3, 0, 1, 2).reshape(
        nz + 2, 27)
    s2c, wrl = s2c.numpy(), wrl.numpy()
    nf = nz + 1
    mats = (s2c[:nf].T, s2c[1:nf + 1].T, wrl[:nf].T, wrl[1:nf + 1].T)
    with pltpu.force_tpu_interpret_mode():
        sref, tref = awfl_pallas.flux_direction_fused(
            jnp.asarray(rows(prim)), jnp.asarray(rows(trac)),
            jnp.asarray(rows(pres[None])[0]), ord=5, cs=350.0, mom_q_idx=2,
            zmask=True, per_level=tuple(jnp.asarray(np.ascontiguousarray(m))
                                        for m in mats))
    back = lambda a, n: np.swapaxes(
        np.asarray(a).reshape(n, nens, ny, nx, nf), -1, -2)
    sref, tref = back(sref, 5), back(tref, ntr)
    for v in range(5):
        assert _rel(sref[v], sgot[v].numpy()) < 2e-5, v
    for v in range(ntr):
        assert _rel(tref[v], tgot[v].numpy()) < 2e-5, v


# ------------------------------------------------------- routing, layout
def test_cuda_wrapper_refuses_cpu_tensor_and_bad_shapes():
    prim, trac, pres, levels = b3_inputs(
        1, 1, 4, 6, 2, AX_Z, torch.float64, "cpu")
    tb = weno.weno_tables(5, torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        awfl_flux.flux_direction_cuda(prim, trac, pres, AX_Z, tb, levels)
    with pytest.raises(ValueError, match="directions"):
        awfl_flux.flux_direction(prim, trac, pres, 1, tb)
    with pytest.raises(ValueError, match="does not match"):
        awfl_flux.flux_direction(prim, trac[:, :, :, 1:], pres, AX_Z, tb)
    with pytest.raises(ValueError, match="face needs"):
        awfl_flux.flux_direction(prim, trac, pres, AX_Y, tb)


def test_member_varying_dz_takes_the_plain_version():
    """dz that differs between members: the dycore carries one matrix set
    per member (one in all where dz is shared), and on the CPU its
    tendencies, through the plain version, equal those of per-member
    dycores."""
    nz = 6
    dz = np.stack([_stretched(nz), 1.2 * _stretched(nz)[::-1]])
    cpl = Coupler(nz=nz, ny=1, nx=8, nens=2, xlen=16000.0, ylen=2000.0,
                  dtype=torch.float64, device=torch.device("cpu"))
    cpl = cpl.add_tracer("water_vapor")
    dyc = AwflDycore.build(cpl, dz)
    assert dyc.levels.packed.shape == (2, nz + 2, 52)
    assert AwflDycore.build(cpl, dz[0]).levels.packed.shape == (1, nz + 2, 52)
    zint = np.concatenate([np.zeros((2, 1)), np.cumsum(dz, axis=1)], axis=1)
    rng = np.random.default_rng(0)
    state = cpl.allocate_state(zint)
    shape = (2, nz, 1, 8)
    state["density_dry"] = torch.from_numpy(1.0 + 0.05 * rng.random(shape))
    state["temp"] = torch.from_numpy(290.0 + rng.random(shape))
    state["uvel"] = torch.from_numpy(5.0 * rng.standard_normal(shape))
    state["wvel"] = torch.from_numpy(rng.standard_normal(shape))
    state["water_vapor"] = torch.from_numpy(0.01 * rng.random(shape))
    state = dyc.declare_current_profile_as_hydrostatic(state)
    dyn, trac = dyc.coupler_to_dynamics(state)
    st, tt = dyc.tendencies(dyn, trac, trac, 1.0, state)
    for e in range(2):
        cpl1 = Coupler(nz=nz, ny=1, nx=8, nens=1, xlen=16000.0, ylen=2000.0,
                       dtype=torch.float64, device=torch.device("cpu"))
        cpl1 = cpl1.add_tracer("water_vapor")
        dyc1 = AwflDycore.build(cpl1, dz[e])
        s1 = {k: v[e:e + 1] for k, v in state.items()}
        st1, tt1 = dyc1.tendencies(dyn[:, e:e + 1], trac[:, e:e + 1],
                                   trac[:, e:e + 1], 1.0, s1)
        assert _rel(st1.numpy(), st[:, e:e + 1].numpy()) < 1e-13
        assert _rel(tt1.numpy(), tt[:, e:e + 1].numpy()) < 1e-13


def test_kernel_layout_numbers_match_source():
    """The argument-array length, the table length, the per-level stride
    and the largest tile of ops/awfl_flux.py are those of
    csrc/awfl_flux.cu and csrc/weno5.cuh."""
    csrc = os.path.join(os.path.dirname(awfl_flux.__file__), "..", "csrc")
    src = open(os.path.join(csrc, "awfl_flux.cu")).read()
    hdr = open(os.path.join(csrc, "weno5.cuh")).read()
    const = lambda text, name: "(" + re.search(
        rf"constexpr int {name} =\s*([^;]+);", text).group(1) + ")"
    env = {"ORD": 5, "HS": 3}
    assert eval(const(src, "N_ARGS"), env) == awfl_flux.N_ARGS
    assert eval(const(src, "MAX_TF"), env) == awfl_flux.MAX_TILE_FACES
    env["NMAT"] = eval(const(hdr, "NMAT"), env)
    assert env["NMAT"] == awfl_flux.LEVEL_STRIDE == weno5.NMAT == 52
    tb = weno.weno_tables(5, torch.float32)
    assert eval(const(hdr, "NTAB"), env) == weno5.prepare_tables(tb).size
    assert "N_ARGS * 1000000 + weno5::NTAB * 1000 + NMAT" in src
    # the struct the argument array fills: 6 pointers, the matrices'
    # member stride, ntr, 4 extents, dir, 5 + 5 + 4 strides, the tile
    fields = re.search(r"struct FluxArgs \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"void\*", fields)) == 6
    assert len(re.findall(r"long long \w+", fields)) == 8
    assert 6 + 1 + 1 + 4 + 1 + 5 + 5 + 4 + 1 == awfl_flux.N_ARGS
    # packed level matrices: the bridge matrix row-major, then wrl
    s2c, wrl = rm.vertical_recon_matrices(_stretched(4), 5)
    lv = awfl_flux.LevelMatrices.build(s2c[None], wrl[None], torch.float64,
                                       "cpu")
    assert lv.packed.shape == (1, 6, 52)
    idl, _ = rm.weno_ideal_weights(5)
    bridge = weno5.bridge_matrix(s2c, wrl, idl)
    assert float(lv.packed[0, 2, 1 * 5 + 3]) == bridge[2, 1, 3]
    assert float(lv.packed[0, 2, 4 * 5 + 0]) == s2c[2, 4, 0] / idl[3]
    assert float(lv.packed[0, 4, 25 + (2 * 3 + 1) * 3 + 0]) == wrl[4, 2, 1, 0]
    assert float(lv.s2c[1, 3, 0, 0, 2, 0]) == s2c[2, 1, 3]
    assert float(lv.wrl[2, 1, 0, 0, 0, 4, 0]) == wrl[4, 2, 1, 0]


@pytest.mark.parametrize("nfaces", [1, 3, 8, 9, 13, 19, 51, 66, 200])
def test_tile_faces_spread_evenly(nfaces):
    """ops/awfl_flux.py::tile_faces: the fewest tiles of at most
    TILE_FACES faces (no more than the kernel's MAX_TF), the faces spread
    evenly over them."""
    tf = awfl_flux.tile_faces(nfaces)
    assert 1 <= tf <= awfl_flux.TILE_FACES <= awfl_flux.MAX_TILE_FACES
    tiles = -(-nfaces // tf)
    assert tiles == -(-nfaces // awfl_flux.TILE_FACES)
    assert tf == -(-nfaces // tiles)


@pytest.mark.parametrize("axis,ntr", [(AX_X, 0), (AX_Z, 3), (AX_Y, 2)])
def test_kernel_order_of_operations_matches_flux_reference(axis, ntr):
    """csrc/awfl_flux.cu's arithmetic in numpy, from ops/weno5.py's
    transcription of the shared limiter: each cell's limiters of rho*u_n
    and p once with both edges taken from them, the characteristic split,
    the wall mask, then one upwind limiter per advected field with the
    upwind cell's level matrices; against flux_direction_reference at
    1e-13 of each output's largest value (float64)."""
    prim, trac, pres, levels = b3_inputs(2, 3, 5, 7, ntr, axis,
                                         torch.float64, "cpu", seed=3 + axis)
    tb = weno.weno_tables(5, torch.float64)
    sref, tref = awfl_flux.flux_direction_reference(prim, trac, pres, axis,
                                                    tb, levels)
    p = weno5.prepare_tables(tb)
    ax = axis - 1                        # axis of a (nens, ny, nz, nx) field
    ncell = prim.shape[axis] - 4         # cells 0 .. nf
    nf = ncell - 1

    def stencil(f):                      # five views over cells 0 .. nf
        f = np.moveaxis(f.numpy(), ax, -1)
        return [f[..., s:s + ncell] for s in range(5)]

    mat = None
    if levels is not None:               # (52, nlev) against a trailing axis
        mat = np.moveaxis(levels.packed[0].numpy(), -1, 0)[:, None, None,
                                                            None]
    ru_c = weno5.cell_limiter(
        stencil(prim[0] * prim[1 + awfl_flux._MOM_Q[axis]]), p, mat)
    pp_c = weno5.cell_limiter(stencil(pres), p, mat)
    ru_left, ru_right = weno5.edges(ru_c, p)
    pp_left, pp_right = weno5.edges(pp_c, p)
    ru_l, ru_r = ru_right[..., :nf].copy(), ru_left[..., 1:].copy()
    pp_l, pp_r = pp_right[..., :nf], pp_left[..., 1:]
    wall = np.zeros(nf, bool)
    if axis == AX_Z:
        wall[[0, -1]] = True
        ru_l[..., wall] = 0.0
        ru_r[..., wall] = 0.0
    w1 = 0.5 * (pp_r - awfl_flux.CS * ru_r)
    w2 = 0.5 * (pp_l + awfl_flux.CS * ru_l)
    pp = w1 + w2
    ru = np.where(wall, 0.0, (w2 - w1) * (1.0 / awfl_flux.CS))
    upw = ru > 0
    got = [ru]
    for q, f in enumerate(list(prim[1:]) + list(trac)):
        sten = stencil(f)
        left_cell = [v[..., :nf] for v in sten]
        right_cell = [v[..., 1:] for v in sten]
        u = [np.where(upw, a, b) for a, b in zip(left_cell, right_cell)]
        m = None if mat is None else np.where(upw, mat[..., :nf],
                                              mat[..., 1:])
        val = weno5.edge(weno5.cell_limiter(u, p, m), p, upw)
        got.append(ru * val + (pp if q == awfl_flux._MOM_Q[axis] else 0.0))
    ref = [np.moveaxis(r.numpy(), ax, -1) for r in list(sref) + list(tref)]
    assert len(ref) == len(got) == 5 + ntr
    for v, (r, g) in enumerate(zip(ref, got)):
        assert _rel(r, g) < 1e-13, v
    assert 0.1 < upw.mean() < 0.9


def test_flux_work_counts():
    """Bytes and operations of one call at the main path's x shape: 9
    fields of 6,400 x 71 cells read, 8 of 6,400 x 66 faces written."""
    tb = weno.weno_tables(5, torch.float32)
    nbytes, flops = awfl_flux.flux_work((5, 128, 1, 50, 71), 3, AX_X, 4, tb)
    assert nbytes == 4 * (9 * 6400 * 71 + 8 * 6400 * 66)
    assert flops == 6400 * 66 * (11 * awfl_flux.weno_flops(tb) + 6 + 13 + 14)
    assert 200 < awfl_flux.weno_flops(tb) < 300
    from pam_tpu_torch.ops import weno_x
    nbytes, flops = weno_x.weno_x_work(32000, 65, 4, tb)
    assert nbytes == 3 * 32000 * 65 * 4
    assert flops == 32000 * 65 * (weno.limiter_flops(tb) + 2 * 31)


@pytest.mark.parametrize("axis,shape,sets,mbytes,gflop", [
    (AX_X, (5, 128, 1, 50, 71), 0, 29.9, 1.162),
    (AX_Z, (5, 128, 1, 56, 65), 1, 30.4, 1.167)], ids=["x", "z"])
def test_flux_work_at_the_main_path_shapes(axis, shape, sets, mbytes, gflop):
    """The yardstick stays the plain version's count (8 + ntr evaluations
    of 247 operations per face) whatever the kernel shares: at 65x1x50,
    nens 128, 3 tracers, float32, x is 29.9 MB and 1.162 Gflop, z (with
    its one set of level matrices) 30.4 MB and 1.167 Gflop."""
    tb = weno.weno_tables(5, torch.float32)
    assert awfl_flux.weno_flops(tb) == 247
    nbytes, flops = awfl_flux.flux_work(shape, 3, axis, 4, tb,
                                        matrix_sets=sets)
    assert round(nbytes / 1e6, 1) == mbytes
    assert round(flops / 1e9, 3) == gflop
    faces = 128 * 50 * 66 if axis == AX_X else 128 * 51 * 65
    assert flops == faces * (11 * 247 + 6 + 13 + 14)


# ------------------------------------------------- the dycore's pieces
def _oracle_pair(nx, ny, nz, nens, seed, grav_balance=False):
    """tests/test_awfl_oracle.py's stretched-grid setup (FCT limiters
    firing, one blob on the periodic seam) in pam_tpu and in the port."""
    import jax.numpy as jnp
    from pam_tpu.dycore.awfl import AwflDycore as JaxDycore
    sys.path.insert(0, HERE)
    import test_awfl_oracle as jorc
    jcpl, jdyc, jstate, dzc = jorc._setup(nx, ny, nz, nens, seed)
    if grav_balance:
        jdyc = JaxDycore.build(jcpl, dzc, use_pallas=False, grav_balance=True)
        jstate = jdyc.declare_current_profile_as_hydrostatic(jstate)
    cpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=jcpl.xlen,
                  ylen=jcpl.ylen, dtype=torch.float64,
                  device=torch.device("cpu"))
    for t in jcpl.tracers:
        cpl = cpl.add_tracer(t.name, t.desc, t.positive, t.adds_mass)
    dyc = AwflDycore.build(cpl, dzc, grav_balance=grav_balance)
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             "cpu", torch.float64)
    return jorc, jcpl, jdyc, jstate, cpl, dyc, state, dzc


def test_coupler_round_trip_and_time_step():
    """coupler_to_dynamics, dynamics_to_coupler and compute_time_step
    against pam_tpu at 1e-13, and the round trip back to the state."""
    _, _, jdyc, jstate, cpl, dyc, state, _ = _oracle_pair(8, 3, 6, 2, seed=1)
    jdyn, jtrac = jdyc.coupler_to_dynamics(jstate)
    dyn, trac = dyc.coupler_to_dynamics(state)
    assert dyn.shape == (5, 2, 3, 6, 8) and trac.shape == (3, 2, 3, 6, 8)
    for v in range(5):
        assert _rel(jdyn[v], dyn[v].numpy()) < 1e-13
    assert _rel(jtrac, trac.numpy()) < 1e-13
    back = dyc.dynamics_to_coupler(state, dyn, trac)
    jback = jdyc.dynamics_to_coupler(jstate, jdyn, jtrac)
    for k in ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor",
              "puff", "chi"):
        assert _rel(jback[k], back[k].numpy()) < 1e-13, k
        assert _rel(state[k].numpy(), back[k].numpy()) < 1e-13, k
    dt = dyc.compute_time_step(state)
    assert dt.ndim == 0
    assert abs(float(dt) / float(jdyc.compute_time_step(jstate)) - 1) < 1e-13


@pytest.mark.parametrize("grav_balance", [False, True])
def test_pad_all_and_hydrostatic_declaration_match_jax(grav_balance):
    """_pad_all (periodic x/y, hydrostatic rho halo through two pows,
    zero w, edge copies, the grav_balance pressure halo) at 1e-13, and
    declare_current_profile_as_hydrostatic in both modes."""
    import jax.numpy as jnp
    _, _, jdyc, jstate, cpl, dyc, state, _ = _oracle_pair(
        6, 4, 5, 1, seed=2, grav_balance=grav_balance)
    for k in ("hy_dens_cells", "hy_pressure_cells", "variable_gravity"):
        assert _rel(jstate[k], state[k].numpy()) == 0.0    # carried across
        got = dyc.declare_current_profile_as_hydrostatic(state)[k].numpy()
        if np.abs(np.asarray(jstate[k])).max() > 0:
            assert _rel(jstate[k], got) < 1e-13, k
    jdyn, jtrac = jdyc.coupler_to_dynamics(jstate)
    jprim = jdyn.at[1:].divide(jdyn[0][None])
    jpres = cpl.const.C0 * jdyn[4] ** cpl.const.gamma_d
    jout = jdyc._pad_all(jprim, jtrac / jdyn[0][None], jpres,
                         jstate["vertical_cell_dz"])
    t = lambda a: torch.from_numpy(np.asarray(a))
    out = dyc._pad_all(t(jprim), t(jtrac / jdyn[0][None]), t(jpres),
                       state["vertical_cell_dz"])
    for name, r, g in zip(("dyn", "tracers", "pressure"), jout, out):
        r, g = np.asarray(r), g.numpy()
        for v in range(r.shape[0]) if r.ndim == 5 else [slice(None)]:
            assert _rel(r[v], g[v]) < 1e-13, (name, v)


def test_pad_all_2d_keeps_one_y_row():
    """In 2-D pam_tpu edge-pads y to 7 equal rows that feed no flux; the
    port keeps the one row, equal to pam_tpu's interior row."""
    _, _, jdyc, jstate, cpl, dyc, state, _ = _oracle_pair(8, 1, 6, 2, seed=3)
    jdyn, jtrac = jdyc.coupler_to_dynamics(jstate)
    jprim = jdyn.at[1:].divide(jdyn[0][None])
    jout = jdyc._pad_all(jprim, jtrac, jdyn[4], jstate["vertical_cell_dz"])
    t = lambda a: torch.from_numpy(np.asarray(a))
    out = dyc._pad_all(t(jprim), t(jtrac), t(jdyn[4]),
                       state["vertical_cell_dz"])
    assert jout[0].shape[2] == 7 and out[0].shape[2] == 1
    assert _rel(np.asarray(jout[0])[:, :, 3:4], out[0].numpy()) < 1e-13
    assert _rel(np.asarray(jout[2])[:, 3:4], out[2].numpy()) < 1e-13


def _to_orc(a):
    """internal (v, nens, ny, nz, nx) -> oracle (v, nz, ny, nx, nens)."""
    return np.transpose(np.asarray(a), (0, 3, 2, 4, 1))


@pytest.mark.parametrize("dims", [(8, 1, 6, 2, 3), (6, 4, 5, 1, 7)],
                         ids=["2d", "3d"])
def test_tendencies_match_jax_and_oracle(dims):
    """One tendencies evaluation on a stretched grid against pam_tpu and
    against the independent numpy oracle, 2-D and 3-D, at the oracle
    test's own tolerance (rtol 1e-10), with the FCT limiter firing."""
    nx, ny, nz, nens, seed = dims
    jorc, _, _, _, cpl, dyc, state, _ = _oracle_pair(nx, ny, nz, nens, seed)
    st_j, tt_j, st_o, tt_o, ctx = jorc._run_both(nx, ny, nz, nens, seed)
    dyn, trac = dyc.coupler_to_dynamics(state)
    st, tt = dyc.tendencies(dyn, trac, trac, ctx["dt"], state)
    st, tt = _to_orc(st.numpy()), _to_orc(tt.numpy())
    jorc._assert_close(st, st_j, "state tendencies vs pam_tpu")
    jorc._assert_close(tt, tt_j, "tracer tendencies vs pam_tpu")
    jorc._assert_close(st, st_o, "state tendencies vs oracle")
    jorc._assert_close(tt, tt_o, "tracer tendencies vs oracle")
    # the limiter fired: unlimited availability changes the port's result
    _, tt_free = dyc.tendencies(dyn, trac, torch.full_like(trac, 1e30),
                                ctx["dt"], state)
    assert float((tt_free - torch.from_numpy(
        np.transpose(tt, (0, 4, 2, 1, 3)))).abs().max()) > 0.0


def test_tendencies_grav_balance_match_jax():
    """The grav_balance option (full pressure, its halo from rho*theta,
    variable gravity source) in 3-D against pam_tpu at rtol 1e-10."""
    import jax
    jorc, _, jdyc, jstate, cpl, dyc, state, _ = _oracle_pair(
        6, 4, 5, 1, seed=4, grav_balance=True)
    assert float(state["variable_gravity"].abs().max()) > 1.0
    jdyn, jtrac = jdyc.coupler_to_dynamics(jstate)
    st_j, tt_j = jax.jit(
        lambda d, t: jdyc.tendencies(d, t, t, 30.0, jstate))(jdyn, jtrac)
    dyn, trac = dyc.coupler_to_dynamics(state)
    st, tt = dyc.tendencies(dyn, trac, trac, 30.0, state)
    jorc._assert_close(st.numpy(), np.asarray(st_j), "state tendencies")
    jorc._assert_close(tt.numpy(), np.asarray(tt_j), "tracer tendencies")


def test_timestep_matches_jax_and_oracle():
    """timestep with dt_phys = 2.5 dt_dyn (3 sub-cycles of SSPRK3 with the
    per-stage FCT starting points) against pam_tpu's and the oracle's, as
    tests/test_awfl_oracle.py::test_awfl_full_timestep_matches_oracle
    holds pam_tpu (rtol 1e-8), and against pam_tpu at 1e-10."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.ops import recon_matrices as jrm
    jorc, jcpl, jdyc, jstate, cpl, dyc, state, dzc = _oracle_pair(
        8, 1, 6, 2, seed=5)
    orc = jorc.orc
    c = cpl.const
    C = {"gamma_d": c.gamma_d, "C0": c.C0, "grav": c.grav, "R_d": c.R_d,
         "R_v": c.R_v}
    nz, nens = 6, 2
    dz2 = np.broadcast_to(dzc[:, None], (nz, nens)).copy()
    dt_dyn = float(dyc.compute_time_step(state))
    dt_dyn_o = orc.compute_time_step_oracle(
        *(state[k].numpy() for k in ("density_dry", "uvel", "vvel", "wvel",
                                     "temp", "water_vapor")),
        cpl.dx, cpl.dy, dz2, C, cfl=dyc.cfl)
    np.testing.assert_allclose(dt_dyn, dt_dyn_o, rtol=1e-14)
    dt_phys = 2.5 * dt_dyn_o
    before = AwflDycore.timestep.cycles
    out = dyc.timestep(state, dt_phys)
    assert AwflDycore.timestep.cycles == before + 3
    jout = jax.jit(lambda s: jdyc.timestep(s, dt_phys))(jstate)

    dyn, trac = dyc.coupler_to_dynamics(state)
    hy_dens = state["hy_dens_cells"].numpy().T
    hy_pres = state["hy_pressure_cells"].numpy().T
    s2c_v, wrl_v = jrm.vertical_recon_matrices(
        np.broadcast_to(dzc, (nens, nz)), 5)
    idl, sigma = jrm.weno_ideal_weights(5)
    mats = dict(s2c=jrm.sten_to_coefs(5), wrl=jrm.weno_lower_sten_to_coefs(5),
                c2g=jrm.coefs_to_gll_lower(5), idl=idl, sigma=sigma,
                vert_s2c=s2c_v, vert_wrl=wrl_v)
    dyn_o, trac_o = orc.time_step_oracle(
        _to_orc(dyn.numpy()), _to_orc(trac.numpy()), dt_phys, dt_dyn_o,
        cpl.dx, cpl.dy, dz2, hy_dens, hy_pres, list(cpl.tracer_positive), C,
        mats, seam_rule="uniform")
    from_orc = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.transpose(a, (0, 4, 2, 1, 3))))
    out_o = dyc.dynamics_to_coupler(state, from_orc(dyn_o), from_orc(trac_o))
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor", "puff",
              "chi"):
        a = out[k].numpy()
        for ref, tol in ((np.asarray(jout[k]), 1e-10),
                         (out_o[k].numpy(), 1e-8)):
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(a, ref, rtol=tol, atol=tol * scale,
                                       err_msg=f"timestep {k}")


def test_timestep_float32_takes_pam_tpu_sub_cycle_count():
    """In float32 the sub-cycle count and the sub-cycle's dt are computed
    in the state's dtype as pam_tpu does: the same count, and the same
    state to float32 rounding over the sub-cycles (1e-4)."""
    import jax
    import jax.numpy as jnp
    _, _, jdyc0, jstate, cpl, _, state, dzc = _oracle_pair(8, 1, 6, 2,
                                                           seed=6)
    from pam_tpu.dycore.awfl import AwflDycore as JaxDycore
    import dataclasses
    jcpl32 = dataclasses.replace(jdyc0.coupler, dtype=jnp.float32)
    jdyc = JaxDycore.build(jcpl32, dzc, use_pallas=False)
    js32 = {k: jnp.asarray(v, jnp.float32) for k, v in jstate.items()}
    cpl32 = dataclasses.replace(cpl, dtype=torch.float32)
    dyc = AwflDycore.build(cpl32, dzc)
    s32 = {k: v.float() for k, v in state.items()}
    dt_phys = 3.0 * float(dyc.compute_time_step(s32))   # on the ceil's edge
    jn = int(np.ceil(np.float32(dt_phys) / np.float32(
        jdyc.compute_time_step(js32))))
    before = AwflDycore.timestep.cycles
    out = dyc.timestep(s32, dt_phys)
    assert AwflDycore.timestep.cycles - before == jn
    jout = jax.jit(lambda s: jdyc.timestep(s, dt_phys))(js32)
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor"):
        assert out[k].dtype == torch.float32
        a, b = np.asarray(jout[k], np.float64), out[k].double().numpy()
        assert np.abs(a - b).max() < 1e-4 * max(1.0, np.abs(a).max()), k


# ------------------------------------------------- initial conditions
def _thermal(dtype=torch.float64, nens=1):
    cpl = Coupler(nz=20, ny=1, nx=40, nens=nens, xlen=20000.0, ylen=20000.0,
                  dtype=dtype, device=torch.device("cpu"))
    cpl = cpl.add_tracer("water_vapor")
    zint = np.linspace(0.0, 10000.0, 21)
    state = awfl_init.init_thermal(cpl, cpl.allocate_state(zint))
    return cpl, zint, state


@pytest.mark.parametrize("case", ["thermal", "thermal3d", "supercell"])
def test_initial_conditions_match_jax(case):
    """init_thermal (2-D and 3-D) and init_supercell on a stretched,
    member-varying grid against pam_tpu: 1e-13 per field."""
    import jax.numpy as jnp
    from pam_tpu.core import Coupler as JaxCoupler
    from pam_tpu.dycore import awfl_init as jinit
    ny = 3 if case == "thermal3d" else 1
    kw = dict(nz=8, ny=ny, nx=10, nens=2, xlen=10000.0, ylen=6000.0)
    dz = np.stack([np.full(8, 1250.0), 1250.0 + 300.0 * np.sin(np.arange(8))])
    zint = np.concatenate([np.zeros((2, 1)), np.cumsum(dz, axis=1)], axis=1)
    jcpl = JaxCoupler(**kw, dtype=jnp.float64).add_tracer("water_vapor")
    cpl = Coupler(**kw, dtype=torch.float64,
                  device=torch.device("cpu")).add_tracer("water_vapor")
    name = "init_supercell" if case == "supercell" else "init_thermal"
    ref = getattr(jinit, name)(jcpl, jcpl.allocate_state(zint))
    got = getattr(awfl_init, name)(cpl, cpl.allocate_state(zint))
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].dtype == torch.float64
        assert _rel(ref[k], got[k].numpy()) < 1e-13, k
    if case != "supercell":   # the bubble is there
        assert float(got["temp"].max() - got["temp"][:, :, :, 0].max()) > 0.2


def test_thermal_bubble_matches_jax_and_conserves_mass():
    """The canonical drive: the rising thermal at 40x1x20, 18 steps of
    10 s. Against pam_tpu's jitted steps at 1e-9 per field; after the
    first acoustic adjustment w grows monotonically to a few m/s;
    sum(density_dry * dz) conserved to 1e-13; two members with identical
    initial state stay bit-identical."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.core import Coupler as JaxCoupler
    from pam_tpu.dycore import AwflDycore as JaxDycore, awfl_init as jinit
    cpl, zint, state = _thermal(nens=2)
    dyc = AwflDycore.build(cpl, np.diff(zint))
    jcpl = JaxCoupler(nz=20, ny=1, nx=40, nens=2, xlen=20000.0, ylen=20000.0,
                      dtype=jnp.float64).add_tracer("water_vapor")
    jstate = jinit.init_thermal(jcpl, jcpl.allocate_state(zint))
    jdyc = JaxDycore.build(jcpl, np.diff(zint), use_pallas=False)
    jstep = jax.jit(lambda s: jdyc.timestep(s, 10.0))
    dz = state["vertical_cell_dz"][:, :, None, None]
    mass0 = float((state["density_dry"] * dz).sum())
    wmax = [0.0]
    for _ in range(18):
        state = dyc.timestep(state, 10.0)
        jstate = jstep(jstate)
        wmax.append(float(state["wvel"].max()))
    assert all(b > a for a, b in zip(wmax[2:], wmax[3:])) and wmax[-1] > 4.0
    assert float(state["wvel"].min()) < 0.0
    mass = float((state["density_dry"] * dz).sum())
    assert abs(mass / mass0 - 1.0) < 1e-13
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor"):
        assert bool(torch.isfinite(state[k]).all())
        assert torch.equal(state[k][0], state[k][1]), k
        assert _rel(jstate[k], state[k].numpy()) < 1e-9 or (
            float(np.abs(np.asarray(jstate[k])).max()) == 0.0
            and float(state[k].abs().max()) == 0.0), k


# ------------------------------------------------- the MMF step on AWFL
MMF_KW = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
              zlen=20000.0, dt_gcm=200.0, dt_crm_phys=20.0, dycore="awfl")


def test_awfl_golden_init_file_is_current():
    """tests/golden/awfl_kessler_init.npz is what pam_tpu builds today,
    every state leaf (hy_dens_cells and hy_pressure_cells included), and
    the port's own setup builds the same deterministic state."""
    sys.path.insert(0, os.path.join(HERE, "..", "tools"))
    try:
        from make_torch_golden_init import initial_state
    finally:
        sys.path.pop(0)
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    fresh = initial_state("awfl_kessler")
    committed = np.load(os.path.join(GOLDEN, "awfl_kessler_init.npz"))
    assert sorted(fresh) == sorted(committed.files)
    assert float(np.abs(committed["hy_pressure_cells"]).min()) > 1e3
    for k in committed.files:
        np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    _, ts = setup_supercell_mmf(**MMF_KW, dtype=torch.float64, device="cpu",
                                state_only=True)
    assert sorted(ts) == sorted(k for k in committed.files
                                if not k.startswith("gcm_forcing_tend_"))
    for k, v in ts.items():
        assert _rel(committed[k], v.numpy()) < 1e-12, k


def test_awfl_kessler_trajectory_from_jax_initial_state():
    """AWFL end to end: setup_supercell_mmf(dycore="awfl") on the
    carried-across initial state, 5 CRM steps of 6 sub-cycles each,
    against pam_tpu's op-by-op run and its jitted run at 1e-9 per field
    (the two pam_tpu runs lie 6e-11 apart in wvel, the port between)."""
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    drv, _ = setup_supercell_mmf(**MMF_KW, micro="kessler",
                                 dtype=torch.float64, device="cpu")
    assert isinstance(drv.dycore, AwflDycore)
    init = dict(np.load(os.path.join(GOLDEN, "awfl_kessler_init.npz")))
    state = state_from_numpy(init, "cpu", torch.float64)
    before = AwflDycore.timestep.cycles
    for _ in range(5):
        state = drv.crm_phys_step(state)
    assert AwflDycore.timestep.cycles - before == 30
    out = state_to_numpy(state)
    opbyop = np.load(os.path.join(GOLDEN, "awfl_kessler_opbyop.npz"))
    jitted = np.load(os.path.join(GOLDEN, "awfl_kessler.npz"))
    assert sorted(opbyop.files) == sorted(jitted.files)
    assert len(opbyop.files) == 7
    assert float(np.abs(out["wvel"]).max()) > 0.01
    for k in opbyop.files:
        assert _rel(opbyop[k], out[k]) < 1e-9, k
        assert _rel(jitted[k], out[k]) < 1e-9, k
        assert _rel(jitted[k], opbyop[k]) < 1e-9, k


def test_awfl_kessler_shoc_steps_match_jax():
    """Kessler with SHOC under AWFL: hy_pressure_cells is a real profile,
    so SHOC's PBL search runs over several levels (npbl > 1, where SPAM
    leaves it at 1). Two CRM steps from pam_tpu's initial state against
    pam_tpu's jitted step: 1e-9 per field."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
    from pam_tpu.modules import gcm_forcing as jforcing
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    kw = dict(MMF_KW, micro="kessler", sgs="shoc")
    jd, js = jax_setup(**kw, dtype=jnp.float64)
    js = jforcing.compute_gcm_forcing_tendencies(jd.coupler, js, jd.dt_gcm)
    td, _ = setup_supercell_mmf(**kw, dtype=torch.float64, device="cpu")
    assert td.sgs.npbl == jd.sgs.npbl and td.sgs.npbl > 1
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu",
                          torch.float64)
    jstep = jax.jit(jd.crm_phys_step)
    for _ in range(2):
        js = jstep(js)
        ts = td.crm_phys_step(ts)
    got = state_to_numpy(ts)
    assert sorted(js) == sorted(got)
    for k in js:
        a = np.asarray(js[k])
        err = float(np.abs(a - got[k]).max())
        assert err < 1e-9 * max(float(np.abs(a).max()), 1e-9), k


def test_awfl_step_emits_its_spans():
    """One CRM step on AWFL under torch.profiler: pam:dycore holds one
    pam:awfl.tendencies per SSPRK3 stage and, in each, flux_x, flux_z and
    fct (2-D: no flux_y); profile_step takes it with --dycore awfl."""
    from torch.profiler import ProfilerActivity, profile
    from pam_tpu_torch import profile_step
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    from pam_tpu_torch.modules import gcm_forcing
    drv, state = setup_supercell_mmf(
        nx=8, ny=1, nz=8, nens=1, xlen=16000.0, ylen=64000.0, zlen=16000.0,
        dt_gcm=40.0, dt_crm_phys=20.0, dtype=torch.float64, device="cpu",
        dycore="awfl")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       40.0)
    before = AwflDycore.timestep.cycles
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.crm_phys_step(state)
    cycles = AwflDycore.timestep.cycles - before
    counts = {}
    for e in prof.events():
        if e.name.startswith("pam:"):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"pam:forcing": 1, "pam:dycore": 1, "pam:sponge": 1,
                      "pam:micro": 1, "pam:awfl.tendencies": 3 * cycles,
                      "pam:awfl.flux_x": 3 * cycles,
                      "pam:awfl.flux_z": 3 * cycles,
                      "pam:awfl.fct": 3 * cycles}
    with pytest.raises(SystemExit, match="cuda"):
        profile_step.main(["--dycore", "awfl"])


def test_unknown_dycore_is_refused():
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    with pytest.raises(ValueError, match="unknown dycore"):
        setup_supercell_mmf(**dict(MMF_KW, dycore="sam"),
                            dtype=torch.float64, device="cpu")


# ------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", [
    (128, 1, 50, 65, 3, AX_X), (128, 1, 50, 65, 3, AX_Z),
    (4, 9, 11, 13, 10, AX_Y), (3, 5, 7, 37, 0, AX_Z),
    (1, 1, 3, 129, 2, AX_X), (5, 3, 9, 37, 3, AX_Z, True),
    (3, 2, 5, 300, 0, AX_X), (2, 3, 12, 37, 10, AX_Z), (2, 18, 4, 33, 3, AX_Y),
    (128, 1, 50, 65, 10, AX_Z, True)],
    ids=["x-full", "z-full", "y-3d", "z-ragged-notracer", "x-ragged",
         "z-member-dz", "x-two-blocks-a-row-notracer", "z-13-faces",
         "y-19-faces", "z-full-member-dz-10-tracers"])
def test_cuda_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nens, ny, nz, nx, ntr, axis = case[:6]
    prim, trac, pres, levels = b3_inputs(
        nens, ny, nz, nx, ntr, axis, dtype, "cuda", seed=axis,
        member_dz=len(case) > 6)
    tb = weno.weno_tables(5, dtype)
    before = awfl_flux.flux_direction_cuda.launches
    sgot, tgot = awfl_flux.flux_direction(prim, trac, pres, axis, tb, levels)
    torch.cuda.synchronize()
    assert awfl_flux.flux_direction_cuda.launches == before + 1
    sref, tref = awfl_flux.flux_direction_reference(prim, trac, pres, axis,
                                                    tb, levels)
    assert sgot.is_contiguous() and sgot.shape == sref.shape
    for name, ref, got in (("state", sref, sgot), ("tracer", tref, tgot)):
        for v in range(ref.shape[0]):
            assert _rel(ref[v].cpu().numpy(), got[v].cpu().numpy()) \
                < KERNEL_TOL[dtype], (name, v)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [AX_X, AX_Z], ids=["x", "z"])
def test_cuda_kernel_on_every_second_member_and_every_tile(axis):
    """A member stride that is not the array's own (every second member
    of a larger array), and every tile size along z: the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prim, trac, pres, levels = b3_inputs(6, 2, 9, 21, 3, axis, torch.float64,
                                         "cuda", seed=2)
    prim, trac, pres = prim[:, ::2], trac[:, ::2], pres[::2]
    assert not prim.is_contiguous()
    tb = weno.weno_tables(5, torch.float64)
    ref = awfl_flux.flux_direction_reference(prim, trac, pres, axis, tb,
                                             levels)
    for tf in (None, 1, 3, awfl_flux.MAX_TILE_FACES):
        got = awfl_flux.flux_direction_cuda(prim, trac, pres, axis, tb,
                                            levels, faces_per_tile=tf)
        torch.cuda.synchronize()
        for r, g in zip(torch.cat(ref), torch.cat(got)):
            assert _rel(r.cpu().numpy(), g.cpu().numpy()) \
                < KERNEL_TOL[torch.float64], tf

"""Periodic-x WENO edge reconstruction: the port's plain version against
pam_tpu (the XLA path of spam/tendencies._edge_recon_x and both Pallas
kernels in interpret mode), and the CUDA kernel against the plain version
on the card.

Tolerance, relative to the largest |edge value|: 1e-12 in float64 and
2e-5 in float32. The Pallas kernels compute the coefficient form of the
limiter and the port the reassociated edge form (ops/weno.py:144-147),
and the CUDA kernel divides where PyTorch's CUDA path multiplies by a
reciprocal, so the sides agree to rounding, not bitwise.

JAX is imported inside the tests that use it, so that the card-side case
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_weno.py
"""

import numpy as np
import pytest
import torch

from pam_tpu_torch.ops import weno, weno_x
from pam_tpu_torch.spam import tendencies as ttend

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 2e-5}
TDT = {"float64": torch.float64, "float32": torch.float32}


def _field(rows, nx, dtype, seed=0):
    """A rough field: smooth waves plus jumps, so the limiter's weights
    move away from their ideal values."""
    rng = np.random.default_rng(seed)
    x = np.arange(nx) / nx
    f = np.sin(2 * np.pi * (x[None, :] + rng.random((rows, 1))))
    f += np.where(rng.random((rows, nx)) < 0.15,
                  rng.standard_normal((rows, nx)), 0.0)
    return f.astype(dtype)


def _check(ref, got, dtype):
    for r, g in zip(ref, got):
        r, g = np.asarray(r), np.asarray(g)
        assert r.shape == g.shape
        scale = max(float(np.abs(r).max()), 1e-300)
        assert float(np.abs(r - g).max()) / scale < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_jax_edge_recon_x(dtype, nx):
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    from pam_tpu.spam import tendencies as jtend
    f = _field(37, nx, dtype)
    jt = jweno.weno_tables(5, dtype=jnp.dtype(dtype))
    ref = jtend._edge_recon_x(jnp.asarray(f), jt)
    tt = weno.weno_tables(5, TDT[dtype])
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f), tt)
    assert got[0].dtype == TDT[dtype]
    _check(ref, got, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_pallas_edge_recon_x_pallas(dtype, nx):
    """B1: pam_tpu/ops/weno_x_pallas.py on a periodically padded field."""
    import jax.numpy as jnp
    from pam_tpu.ops.weno_x_pallas import edge_recon_x_pallas
    f = _field(37, nx, dtype, seed=1)
    pad = np.concatenate([f[:, -2:], f, f[:, :2]], axis=-1)
    ref = edge_recon_x_pallas(jnp.asarray(pad), ord=5, interpret=True)
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f),
                                        weno.weno_tables(5, TDT[dtype]))
    _check(ref, got, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 65])
def test_reference_matches_pallas_weno_pallas(dtype, nx):
    """B2: pam_tpu/ops/weno_pallas.py (pads x and rows in its wrapper)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from pam_tpu.ops import weno_pallas
    f = _field(37, nx, dtype, seed=2).reshape(37, 1, nx)
    with pltpu.force_tpu_interpret_mode():
        ref = weno_pallas.edge_recon_x(jnp.asarray(f), ord=5)
    got = weno_x.weno_edges_x_reference(torch.from_numpy(f),
                                        weno.weno_tables(5, TDT[dtype]))
    _check(ref, got, dtype)


@pytest.mark.parametrize("recon_type", ["cfv", "wenofunc"])
def test_tendencies_edge_recons_match_jax(recon_type):
    """The port's _edge_recon_x and _edge_recon_z (z stays plain torch on
    every device) against pam_tpu's, limited and centred (CFV)."""
    import jax.numpy as jnp
    from pam_tpu.ops import weno as jweno
    from pam_tpu.spam import tendencies as jtend
    f = _field(3 * 2 * 9, 16, "float64", seed=3).reshape(3, 2, 9, 16)
    jt = jweno.weno_tables(5, dtype=jnp.float64)
    tt = weno.weno_tables(5, torch.float64)
    _check(jtend._edge_recon_x(jnp.asarray(f), jt, recon_type),
           ttend._edge_recon_x(torch.from_numpy(f), tt, recon_type),
           "float64")
    _check(jtend._edge_recon_z(jnp.asarray(f), jt, 5, recon_type),
           ttend._edge_recon_z(torch.from_numpy(f), tt, 5, recon_type),
           "float64")


def test_tendencies_route_cpu_tensor_to_plain_version():
    """On a CPU tensor the port's _edge_recon_x is the plain version,
    bit for bit, and launches no kernel."""
    f = torch.from_numpy(_field(3 * 2 * 5, 16, "float64").reshape(3, 2, 5,
                                                                  16))
    tb = weno.weno_tables(5, torch.float64)
    before = weno_x.weno_edges_x_cuda.launches
    got = ttend._edge_recon_x(f, tb)
    ref = weno_x.weno_edges_x_reference(f, tb)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert weno_x.weno_edges_x_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensor():
    f = torch.from_numpy(_field(4, 16, "float64"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        weno_x.weno_edges_x_cuda(f, weno.weno_tables(5, torch.float64))


def test_packed_tables_match_kernel_layout():
    """The kernel reads 101 values: s2c 25, wrl 27, tv_hi 25, tv_lo 9,
    c2g 10, idl 4, sigma."""
    tb = weno.weno_tables(5, torch.float32)
    packed = weno_x._packed_tables(tb)
    assert packed.shape == (101,) and packed.dtype == np.float64
    assert packed[0] == tb[0][0, 0] and packed[-1] == np.float32(tb[6])
    assert packed[25] == tb[1][0, 0, 0] and packed[96] == tb[5][0]
    with pytest.raises(ValueError, match="order"):
        weno_x._packed_tables(weno.weno_tables(3, torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rows,nx", [(32000, 65), (6272, 65), (37, 16)])
def test_cuda_kernel_matches_plain_version(dtype, rows, nx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.from_numpy(_field(rows, nx, dtype, seed=4)).cuda()
    tb = weno.weno_tables(5, TDT[dtype])
    before = weno_x.weno_edges_x_cuda.launches
    got = weno_x.weno_edges_x_cuda(f, tb)
    torch.cuda.synchronize()
    assert weno_x.weno_edges_x_cuda.launches == before + 1
    ref = weno_x.weno_edges_x_reference(f, tb)
    _check([r.cpu() for r in ref], [g.cpu() for g in got], dtype)

"""Seeded temperature perturbations to break CRM ensemble symmetry (port
of pam_tpu/modules/perturb.py; ref pam_core/modules/
perturb_temperature.h:10-64).

Uniform noise in [-1, 1) in the bottom nz/4 levels, amplitude tapered
with height, then a per-level multiplicative rescale that conserves the
horizontal-mean temperature. Each member draws from its own seed the
bits that ``jax.random.uniform(jax.random.PRNGKey(seed), (nz, ny, nx),
dtype, -1.0, 1.0)`` draws, so the port builds ``pam_tpu``'s perturbed
state. That is JAX 0.9's threefry2x32 in its partitionable mode
(``jax_threefry_partitionable`` True, the default since JAX 0.5) with a
64-bit seed, as under ``jax_enable_x64``; the draw runs once a run, on
the host, in numpy's wrapping uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coupler import Coupler, hmean

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2), 20 rounds (jax/_src/prng.py::_threefry2x32_lowering)."""
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def random_bits(seed: int, shape, nbits: int) -> np.ndarray:
    """``nbits``-wide (32 or 64) random bits of ``shape`` from the key of
    ``seed`` (prng.py::_threefry_seed: the seed's high and low 32 bits;
    ::_threefry_random_bits_partitionable: the counter of each element is
    its flat index, split into high and low words, and the two hashed
    words are xored for 32 bits or joined high:low for 64)."""
    s = int(seed) & (2**64 - 1)
    count = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(s >> 32, s & 0xFFFFFFFF, hi, lo)
    if nbits == 32:
        return (b1 ^ b2).reshape(shape)
    return ((b1.astype(np.uint64) << np.uint64(32)) |
            b2.astype(np.uint64)).reshape(shape)


def uniform(seed: int, shape, dtype: torch.dtype, minval: float = -1.0,
            maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform(PRNGKey(seed), shape, dtype, minval, maxval),
    bit for bit (jax/_src/random.py::_uniform: the top nmant bits of the
    draw under 1.0's exponent, minus 1, scaled, no less than minval), in
    float32 or float64."""
    ft = np.dtype({torch.float32: np.float32,
                   torch.float64: np.float64}[dtype])
    nbits, nmant = ft.itemsize * 8, np.finfo(ft).nmant
    ut = np.dtype(f"uint{nbits}")
    bits = random_bits(seed, shape, nbits).astype(ut)
    one = np.array(1.0, ft).view(ut)
    floats = ((bits >> ut.type(nbits - nmant)) | one).view(ft) - ft.type(1.0)
    lo, hi = ft.type(minval), ft.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def perturb_temperature(coupler: Coupler, state, seeds,
                        magnitude: float = 0.1, noise_dtype=None):
    """seeds: (nens,) integers, one per CRM (unique within the batch).
    The noise is drawn in ``noise_dtype`` (the temperature's by default):
    the draw's bits depend on it."""
    out = dict(state)
    nz = coupler.nz
    num_levels = nz // 4
    temp = state["temp"]
    hmean1 = hmean(temp)
    rand = np.stack([uniform(s, (nz, coupler.ny, coupler.nx),
                             noise_dtype or temp.dtype)
                     for s in np.asarray(seeds).reshape(-1)])
    rand = torch.as_tensor(rand, dtype=temp.dtype, device=temp.device)
    k = torch.arange(nz, device=temp.device)
    scaling = torch.where(k < num_levels,
                          (num_levels - k.to(temp.dtype)) / num_levels,
                          torch.zeros((), dtype=temp.dtype,
                                      device=temp.device))
    temp = temp + rand * magnitude * scaling[None, :, None, None]
    # per-level conservation rescale (ref: perturb_temperature.h:57-61)
    hmean2 = hmean(temp)
    ratio = torch.where((k < num_levels)[None, :], hmean1 / hmean2,
                        torch.ones_like(hmean1))
    out["temp"] = temp * ratio[:, :, None, None]
    return out

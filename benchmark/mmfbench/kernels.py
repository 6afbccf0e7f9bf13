"""The work of the program's hand-written kernels on the main path, from
the shapes of their calls, and the published peaks of the card: frozen
copies of ``pam_tpu_torch/ops/weno_x.py::weno_x_work`` (B1), of
``pam_tpu_torch/ops/awfl_flux.py::flux_work`` and ``weno_flops`` (B3)
and of the count of P3 part 2 (B4) that ``chip_smoke.py::plain_ops``
made, so a roofline share reads the same work whatever implements it.

A configuration file lists, under ``kernel_calls``, the calls that one
CRM step makes per ensemble member: B1 ``{"rows": r, "nx": n}`` (a call
on a chunk of m members reconstructs r*m rows of n cells), B4
``{"points": p}``. B3, the AWFL dycore's directional flux, runs in the
acoustic sub-cycles, whose number a step the device decides, so its
entry lists the calls of one sub-cycle (3 SSPRK3 stages, each the x then
the z direction): ``{"axis": "x" | "z", "cells": [ny, nz, nx],
"tracers": t, "matrix_sets": s}``, ``cells`` a member's input, padded
by 3 cells on each side along ``axis`` (faces: that extent less 5),
``t`` the tracers fluxed, ``s`` the sets of per-level matrices read (1
for a z call whose members share their levels, 0 along x), which a
chunk does not multiply. B3's least time over a stretch is then
:func:`least_s_per_cycle` times its launches over the calls listed."""

from __future__ import annotations

import numpy as np
import torch

from mmfref.ops import weno

from .spec import dtype_name

# NVIDIA H100 SXM data sheet: HBM3 rate, dense float32 and float64 rates
# outside the tensor cores (the kernels use none)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
ITEMSIZE = {"float32": 4, "float64": 8}

# kernel names as the profiler's trace holds them
B1_KERNEL = "weno_x_kernel"
B3_KERNEL = "awfl_flux_kernel"
B4_KERNEL = "p3_part2_kernel"

# B3: the WENO order, and the values of one level's packed matrices
# (pam_tpu_torch/ops/weno5.py::NMAT: ord*ord + hs**3)
B3_ORD = 5
B3_LEVEL_STRIDE = 52
B3_AXES = {"x": 4, "z": 3}      # axes of (nvar, nens, ny, nz, nx)

# P3 part 2 (B4): 36 arrays read and 28 written, one value a point each;
# 1,614 elementwise operations a point (the plain version's count at half
# the species present, chip_smoke.py phase 5)
B4_ARRAYS_IN, B4_ARRAYS_OUT, B4_OPS = 36, 28, 1614


def _quadform_flops(M) -> int:
    M = np.asarray(M)
    n = M.shape[0]
    terms = sum(M[i, i] != 0.0 for i in range(n)) + sum(
        M[i, d] + M[d, i] != 0.0 for i in range(n) for d in range(i + 1, n))
    return 3 * int(terms) - 1    # two products per term, then the sum


def limiter_flops(tables) -> int:
    """Floating-point operations per point of the WENO limiter (the
    candidates and their weights; adds, multiplies, divisions and
    reciprocals counted as one each)."""
    s2c, _, tv_hi, tv_lo = tables[:4]
    ord = s2c.shape[-1]
    hs = (ord + 1) // 2
    n = hs * hs * (2 * hs - 1) + ord * (2 * ord - 1)       # a_lo, a_hi
    n += hs * (2 * hs + 1) + (ord - hs)                    # bridge
    n += hs * _quadform_flops(tv_lo) + _quadform_flops(tv_hi)
    n += hs + 3                                            # lo_avg, blend
    n += 4 * (hs + 1) + (hs + 1) + (hs + 1)                # w, sum, convexify
    n += 8 * (hs + 1) + (hs + 1) + (hs + 1)                # map, sum, convexify
    return n


def weno_x_work(rows: int, nx: int, itemsize: int, ord: int = 5,
                padded: bool = False) -> tuple:
    """(bytes, flops) of one B1 call: the field read once (with its halos
    in the padded mode), both edge arrays written once; per cell the
    limiter, then per edge the candidates evaluated there and their
    weighted sum."""
    tables = weno.weno_tables(ord, torch.float64)
    hs = (ord + 1) // 2
    per_edge = hs * (2 * hs - 1) + (2 * ord - 1) + (2 * (hs + 1) - 1)
    nread = nx + (ord - 1 if padded else 0)
    return (rows * (nread + 2 * nx) * itemsize,
            rows * nx * (limiter_flops(tables) + 2 * per_edge))


def weno_flops(tables) -> int:
    """Floating-point operations of one limited edge value: the limiter,
    the weighted sum of the candidates, the evaluation at the edge."""
    ord = tables[0].shape[-1]
    hs = (ord + 1) // 2
    return (limiter_flops(tables)
            + hs * (2 * hs + 1) + (ord - hs)    # weighted sum of candidates
            + 2 * ord - 1)                      # evaluation at the edge


def b3_work(prim_shape, ntr: int, axis: int, itemsize: int,
            matrix_sets: int = 0) -> tuple:
    """(bytes, flops) of one B3 call on a (5, nens, ny, nz, nx) state
    padded along ``axis``: every input element read once and every
    output element written once (``matrix_sets`` sets of per-level
    matrices among the inputs); 4 two-sided and 4 + ntr upwind WENO
    evaluations per face plus the characteristic split."""
    tables = weno.weno_tables(B3_ORD, torch.float64)
    cells = int(np.prod(prim_shape[1:]))
    faces = cells // prim_shape[axis] * (prim_shape[axis] - B3_ORD)
    nbytes = itemsize * ((5 + ntr + 1) * cells + (5 + ntr) * faces)
    nbytes += (itemsize * matrix_sets * B3_LEVEL_STRIDE
               * (prim_shape[B3_AXES["z"]] - B3_ORD + 1))
    flops = faces * ((8 + ntr) * weno_flops(tables) + (B3_ORD + 1) + 13
                     + 2 * (4 + ntr))
    return nbytes, flops


def b3_call_work(call: dict, chunk: int, itemsize: int) -> tuple:
    """(bytes, flops) of the ``kernel_calls["b3"]`` entry ``call`` on a
    chunk of ``chunk`` members."""
    return b3_work([5, chunk] + list(call["cells"]), call["tracers"],
                   B3_AXES[call["axis"]], itemsize,
                   call["matrix_sets"])


def p3_part2_work(points: int, itemsize: int) -> tuple:
    """(bytes, flops) of one B4 call over ``points`` points."""
    return ((B4_ARRAYS_IN + B4_ARRAYS_OUT) * points * itemsize,
            B4_OPS * points)


def least_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


def least_s_per_step(config: dict, kernel: str, nens: int, chunk: int
                     ) -> float:
    """The least time of ``kernel`` ("b1" or "b4") in one CRM step of
    ``nens`` members stepped in chunks of ``chunk``: every call the
    configuration lists, once a chunk."""
    dtype = dtype_name(config)
    size = ITEMSIZE[dtype]
    total = 0.0
    for call in config["kernel_calls"].get(kernel, []):
        if kernel == "b1":
            work = weno_x_work(call["rows"] * chunk, call["nx"], size,
                               call.get("ord", 5))
        else:
            work = p3_part2_work(call["points"] * chunk, size)
        total += least_s(*work, dtype) * (nens // chunk)
    return total


def least_s_per_cycle(config: dict, chunk: int) -> float:
    """The least time of B3's calls in one acoustic sub-cycle of a chunk
    of ``chunk`` members: every call that ``kernel_calls["b3"]`` lists,
    once. Over a stretch in which B3 launched n times, B3's least time is
    this times n over the number of calls listed."""
    dtype = dtype_name(config)
    return sum(least_s(*b3_call_work(call, chunk, ITEMSIZE[dtype]), dtype)
               for call in config["kernel_calls"].get("b3", []))

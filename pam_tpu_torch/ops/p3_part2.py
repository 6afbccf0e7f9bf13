"""P3 part 2 in one launch: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel of ``pam_tpu/physics/p3/main.py:780``
(``p3_main_part2``, its ``use_pallas`` branch, body ``kernel`` :832) with
``csrc/p3_part2.cu`` (kernel B4). ``pam_tpu`` runs part 2 in two stages:
``_part2_tables`` (DSD precursors, index walks, table lookups as dense
hat-weight contractions) and the pointwise ``_part2_core``, which alone
is its kernel. Here the kernel runs both stages from part 1's state, the
lookups as gathers (``csrc/p3_tables.cuh``), so the table values never
reach device memory. :func:`p3_part2` routes by device: a CUDA tensor
goes to the kernel (or raises), a CPU tensor to
:func:`p3_part2_reference`, the port's ``_part2_tables`` followed by
``_part2_core``.

The work is pointwise over every point of the column batch, so the
wrapper hands the kernel flat views of any contiguous shape: 36 input
arrays (10 arguments, the 18 ``_PART2_ST_KEYS`` fields of part 1, its 8
in-cloud ratios), the three lookup tables and seven per-call scalars,
and 28 output arrays (the 12 ``_PART2_OUT_KEYS`` fields, the 8 new
in-cloud ratios, the 7 ``_PART2_DIAG_KEYS`` diagnostics and ``lamr``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..physics.p3 import main as p3main
from ..physics.p3 import tables as tbl
from ..physics.p3.constants import (CONST, QSMALL, NSMALL, MINCLD,
                                    INCLOUD_LIMIT, PRECIP_LIMIT,
                                    MU_R_CONSTANT, LOOKUP_TABLE_1A_DUM1_C)

# every input array is read once and every output written once: the
# kernel's bytes are (N_IN + N_OUT) arrays of one value per point
N_IN = 10 + len(p3main._PART2_ST_KEYS) + 8
N_OUT = len(p3main._PART2_OUT_KEYS) + 8 + len(p3main._PART2_DIAG_KEYS) + 1
N_TABLES = 4


def p3_part2_reference(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                       cld_frac_r, inv_cl, inv_ci, inv_cr, qv_prev, t_prev,
                       st, ccn_mode="prescribed"):
    """The plain version of kernel B4: the port's table stage (hat-weight
    contractions and all) followed by its pointwise core. ``st`` is part
    1's output; returns (state dict, diagnostics)."""
    return p3main._part2_core(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                              cld_frac_r, inv_cl, inv_ci, inv_cr, qv_prev,
                              t_prev, st, p3main._part2_tables(st), ccn_mode)


def _constants() -> np.ndarray:
    """The constants the kernel reads, in the order of ``struct P3Consts``
    of csrc/p3_part2.cu, as float64: the scheme's constants and the
    products and sums of them that the plain version takes in Python
    floats before they meet a tensor."""
    C = CONST
    if C.bcn != 2.0:   # the kernel writes lamc**bcn as lamc*lamc
        raise ValueError(f"csrc/p3_part2.cu assumes bcn == 2, got {C.bcn}")
    mu_r = MU_R_CONSTANT
    gam_mur1 = p3main._gamma(mu_r + 1.0)   # rain_dsd's Python-float factors
    return np.array([
        C.latent_heat_vapor, C.latent_heat_sublim, C.latent_heat_fusion,
        C.rv, C.cp, C.inv_cp, C.T_zerodegc, C.T_rainfrz, C.T_icenuc,
        C.eci, C.eri, C.inv_dropmass, C.cpw, C.aimm, C.cons3,
        C.cons5, C.cons6, C.f1r, C.f2r, C.mi0, C.nmltratio,
        C.inv_rho_rimeMax, C.nccnst, C.ep_2, C.max_total_ni, C.rho_h2o,
        QSMALL, MINCLD, INCLOUD_LIMIT, PRECIP_LIMIT,
        NSMALL, mu_r, C.cons1, C.rho_rimeMin, C.rho_rimeMax,
        LOOKUP_TABLE_1A_DUM1_C, gam_mur1, math.log(gam_mur1),
        math.log(p3main._gamma(mu_r + 4.0)), math.log10(gam_mur1),
        mu_r + 1.0, mu_r + 2.0, mu_r + 3.0, (mu_r + 1.0) * 1.0e5,
        (mu_r + 1.0) * 500.0, np.pi * C.rho_h2o,
        C.latent_heat_sublim * C.inv_cp, C.latent_heat_sublim ** 2,
        C.cp * C.rv, 2.0 * np.pi], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def kernel_tables(device: torch.device, dtype: torch.dtype):
    """What the kernel reads beside its arrays, on ``device`` in ``dtype``,
    built once: the ice, collection and rain-evaporation tables of
    ``tables.device_tables``, and the values of the plain version that
    are one number a call, computed as it computes them (in ``dtype``, on
    ``device``, by the same PyTorch calls): exp(lgamma(mu_r + {2, 4, 7}))
    of ``_part2_tables``, the logarithms of the last two (rain immersion
    freezing), and log(T) and tanh(0.0415 (T - 218.8)) at T = T_zerodegc
    (``qv_sat`` at the melting point)."""
    ice, collect, _, _, revap = tbl.device_tables(device, dtype)
    mu_r = torch.full((3,), MU_R_CONSTANT, dtype=dtype, device=device)
    gam = p3main._gamma(mu_r + torch.tensor([2.0, 4.0, 7.0], dtype=dtype,
                                            device=device))
    t0 = torch.full((1,), CONST.T_zerodegc, dtype=dtype, device=device)
    scalars = torch.cat([gam, torch.log(gam[1:]), torch.log(t0),
                         torch.tanh(0.0415 * (t0 - 218.8))])
    return tuple(t.contiguous() for t in (ice, collect, revap, scalars))


def p3_part2_cuda(dt, pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r,
                  inv_cl, inv_ci, inv_cr, qv_prev, t_prev, st,
                  ccn_mode="prescribed"):
    """Launch ``csrc/p3_part2.cu`` on CUDA tensors of one shape and dtype
    (float32 or float64); the arguments and results are those of
    :func:`p3_part2_reference`. Allocates its 28 outputs and ``mu_r``
    (a constant fill) and nothing else."""
    ins = ([pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r, inv_cl,
            inv_ci, inv_cr, qv_prev, t_prev]
           + [st[k] for k in p3main._PART2_ST_KEYS] + list(st["inc"]))
    ref = ins[0]
    if not ref.is_cuda:
        raise ValueError(f"p3_part2_cuda needs CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"p3_part2_cuda takes float32/float64, got "
                        f"{ref.dtype}")
    if ccn_mode not in ("prescribed", "const"):
        raise ValueError(f"p3_part2_cuda: ccn_mode {ccn_mode!r}")
    for i, a in enumerate(ins):
        if (a.shape != ref.shape or a.dtype != ref.dtype
                or a.device != ref.device or not a.is_contiguous()):
            raise ValueError(
                f"p3_part2_cuda: input {i} is {tuple(a.shape)} {a.dtype} "
                f"{a.device} contiguous={a.is_contiguous()}; every input "
                f"must be a contiguous {tuple(ref.shape)} {ref.dtype} "
                f"tensor on {ref.device}")
    if len(ins) != N_IN:
        raise ValueError(f"p3_part2_cuda: {len(ins)} inputs, not {N_IN}")
    from .. import _cuda
    lib = _cuda.library()
    tabs = kernel_tables(ref.device, ref.dtype)
    for k, t in enumerate(tabs):
        if t.numel() != lib.pam_p3_part2_table_size(k):
            raise ValueError(f"p3_part2_cuda: table {k} has {t.numel()} "
                             f"elements, csrc/p3_tables.cuh expects "
                             f"{lib.pam_p3_part2_table_size(k)}")
    outs = [torch.empty_like(ref) for _ in range(N_OUT)]
    fn = lib.pam_p3_part2_f32 if ref.dtype == torch.float32 \
        else lib.pam_p3_part2_f64
    in_ptrs, out_ptrs, tab_ptrs = (
        np.array([a.data_ptr() for a in arrs], dtype=np.uint64)
        for arrs in (ins, outs, tabs))
    consts = _constants()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = fn(in_ptrs.ctypes.data, out_ptrs.ctypes.data,
                tab_ptrs.ctypes.data, ref.numel(), float(dt),
                int(ccn_mode == "const"), consts.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"p3_part2 kernel launch failed: CUDA error {rc}")
    p3_part2_cuda.launches += 1

    k_o = len(p3main._PART2_OUT_KEYS)
    o = dict(st)
    o.update(zip(p3main._PART2_OUT_KEYS, outs[:k_o]))
    o["inc"] = tuple(outs[k_o:k_o + 8])
    o["lamr"] = outs[-1]
    o["mu_r"] = torch.full_like(ref, MU_R_CONSTANT)
    return o, dict(zip(p3main._PART2_DIAG_KEYS, outs[k_o + 8:-1]))


p3_part2_cuda.launches = 0


def sample_inputs(shape, dtype, device, seed=0, dt=20.0, present=0.5):
    """Consistent inputs of :func:`p3_part2` at any shape, for comparing
    the kernel with its plain version: seeded points between 250 m and
    14.75 km (T from about 300 K down to 200 K, as in
    tests/test_p3.py:64-94) with cloud, rain and ice each there with
    probability ``present`` (0.5: no warp of the kernel is uniform; 0.02:
    the species are as rare as in the model's own states), over- and
    under-saturated vapour and partial cloud fractions, passed through
    the port's part 1. Returns the argument tuple
    (dt, pres, ..., t_prev, st); ``main._part2_tables(st)`` gives the
    table values of the plain version's first stage."""
    rng = np.random.default_rng(seed)

    def u(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    def some(mag_lo, mag_hi, p):
        """log-uniform magnitudes where a draw < p, else 0."""
        return np.where(u() < p, 10.0 ** u(np.log10(mag_lo),
                                           np.log10(mag_hi)), 0.0)

    z = u(250.0, 14750.0)
    T = np.maximum(300.0 - 6.5e-3 * z, 200.0) + u(-2.0, 2.0)
    p = 1e5 * np.exp(-z / 8500.0)
    rho = p / (287.042 * T)
    dz = u(200.0, 500.0)
    exner = (p / 1e5) ** (287.042 / 1004.64)
    qv = 0.017 * np.exp(-z / 2500.0) * u(0.5, 1.5) + 1e-6
    qc = some(1e-9, 2e-3, present)
    qr = some(1e-9, 4e-3, present)
    qi = some(1e-9, 2e-3, present)
    qm = qi * u()
    bm = qm / u(100.0, 900.0)
    f = dict(qc=qc, nc=u(0.2, 2.0) * 1e8 / rho, qr=qr,
             nr=u(0.2, 2.0) * 1e5 / rho, qi=qi, ni=u(0.2, 2.0) * 1e5 / rho,
             qm=qm, bm=bm, qv=qv, th=T / exner, pres=p, dz=dz,
             dpres=rho * 9.80616 * dz, exner=exner, inv_exner=1.0 / exner,
             qv_prev=qv * u(0.98, 1.02), t_prev=T + u(-0.5, 0.5),
             cld_frac_l=u(0.2, 1.0), cld_frac_i=u(0.2, 1.0),
             cld_frac_r=u(0.2, 1.0))
    t = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in f.items()}
    inv_cl, inv_ci, inv_cr = (1.0 / t[k] for k in
                              ("cld_frac_l", "cld_frac_i", "cld_frac_r"))
    zero = torch.zeros_like(t["qc"])
    st = p3main.p3_main_part1(
        dt, t["pres"], t["dpres"], t["dz"], zero, t["inv_exner"],
        t["exner"], inv_cl, inv_ci, inv_cr, t["th"] * t["exner"], t["qv"],
        t["th"], t["qc"], t["nc"], t["qr"], t["nr"], t["qi"], t["ni"],
        t["qm"], t["bm"], zero)
    return (dt, t["pres"], t["inv_exner"], t["cld_frac_l"], t["cld_frac_i"],
            t["cld_frac_r"], inv_cl, inv_ci, inv_cr, t["qv_prev"],
            t["t_prev"], st)


def cast_inputs(args, dtype):
    """:func:`sample_inputs`' tuple with every tensor cast to ``dtype``."""
    dt, *arrs, st = args
    st = {k: (tuple(v.to(dtype) for v in st[k]) if k == "inc"
              else st[k].to(dtype)) for k in st}
    return (dt, *(a.to(dtype) for a in arrs), st)


def outputs(o, d):
    """The 28 results of part 2 (the kernel's outputs) by name."""
    out = {k: o[k] for k in p3main._PART2_OUT_KEYS + ("lamr",)}
    out.update({f"inc{i}": v for i, v in enumerate(o["inc"])})
    out.update({k: d[k] for k in p3main._PART2_DIAG_KEYS})
    return out


def p3_part2(dt, pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r,
             inv_cl, inv_ci, inv_cr, qv_prev, t_prev, st,
             ccn_mode="prescribed"):
    """P3 part 2 from part 1's state ``st``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pres.is_cuda:
        return p3_part2_cuda(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                             cld_frac_r, inv_cl, inv_ci, inv_cr, qv_prev,
                             t_prev, st, ccn_mode)
    if pres.device.type != "cpu":
        raise ValueError(f"p3_part2: no route for device {pres.device}")
    return p3_part2_reference(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                              cld_frac_r, inv_cl, inv_ci, inv_cr, qv_prev,
                              t_prev, st, ccn_mode)

"""P3 lookup tables: the ice process table read from the shipped data
file, the generated rain fall-speed/ventilation tables, the index walks
and the multilinear interpolation (port of pam_tpu/physics/p3/tables.py;
ref micro_p3.F90 p3_init_a :134-206, p3_init_b :236-361,
access_lookup_table* :1508-1615, find_lookupTable_indices_* :1620-1770).

The data file is ``p3_lookup_table_1.dat-v4.gz`` beside this module, the
gzip of the table file the program ships. The interpolation is a
hat-weight contraction (``access_*_table_multi``), ``torch.einsum``
products: every fractional index x lies between its floor and floor + 1,
so linear interpolation along an axis of n entries is exactly the
contraction with the weights max(0, 1 - |k - x|). The caller decides
TF32 (the benchmark's ``check.matmul_precision``).
"""

from __future__ import annotations

import functools
import gzip
from pathlib import Path

import numpy as np
import torch

from .constants import (ISIZE, DENSIZE, RIMSIZE, RCOLLSIZE, ICE_TABLE_SIZE,
                        COLLECT_TABLE_SIZE, MU_R_CONSTANT, CONST,
                        LOOKUP_TABLE_1A_DUM1_C)

TABLE_FILE = Path(__file__).resolve().parent / "p3_lookup_table_1.dat-v4.gz"


@functools.cache
def load_ice_tables():
    """Parse the ice lookup table file -> (ice_table, collect_table),
    float64 numpy.

    ice_table: (DENSIZE, RIMSIZE, ISIZE, 12); collect_table:
    (DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, 2) with log10 applied to the
    collection entries (p3_init_a:178-195).
    """
    ice = np.zeros((DENSIZE, RIMSIZE, ISIZE, ICE_TABLE_SIZE))
    coll = np.zeros((DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, COLLECT_TABLE_SIZE))
    with gzip.open(TABLE_FILE, "rt") as f:
        lines = (ln for ln in f if ln.strip() and not
                 ln.lstrip().startswith("VERSION"))
        for jj in range(DENSIZE):
            for ii in range(RIMSIZE):
                for i in range(ISIZE):
                    nums = [float(v) for v in next(lines).split()[2:]]
                    # row: dum,dum,k1..k8,dum,k9..k12  (p3_init_a:181-184)
                    ice[jj, ii, i, 0:8] = nums[2:10]
                    ice[jj, ii, i, 8:12] = nums[11:15]
                for i in range(ISIZE):
                    for j in range(RCOLLSIZE):
                        nums = [float(v) for v in next(lines).split()[2:]]
                        coll[jj, ii, i, j, 0] = np.log10(max(nums[3], 1e-300))
                        coll[jj, ii, i, j, 1] = np.log10(max(nums[4], 1e-300))
    return ice, coll


@functools.cache
def build_rain_tables():
    """Generate rain fallspeed/ventilation tables by PSD integration
    (p3_init_b:288-358). Returns (vn, vm, revap): each (300, 10) numpy."""
    mu_r = MU_R_CONSTANT
    jjs = np.arange(1, 301)
    dm = np.where(jjs <= 20, (jjs * 10.0 - 5.0) * 1e-6,
                  ((jjs - 20) * 30.0 + 195.0) * 1e-6)
    lamr = (mu_r + 1.0) / dm                       # (300,)
    kk = np.arange(1, 10001)
    dd = 2.0
    dia = (kk * dd - dd * 0.5) * 1e-6              # (10000,)
    amg = (np.pi / 6.0) * 997.0 * dia ** 3 * 1000.0  # grams
    vt = np.where(dia * 1e6 <= 134.43, 4.5795e3 * amg ** (2.0 / 3.0),
                  np.where(dia * 1e6 < 1511.64, 4.962e1 * amg ** (1.0 / 3.0),
                           np.where(dia * 1e6 < 3477.84,
                                    1.732e1 * amg ** (1.0 / 6.0), 9.17)))
    ex = np.exp(-lamr[:, None] * dia[None, :])     # (300, 10000)
    w_n = 10.0 ** (mu_r * np.log10(dia) + 4.0 * mu_r)[None, :] * ex * dd * 1e-6
    w_m = 10.0 ** ((mu_r + 3.0) * np.log10(dia) + 4.0 * mu_r)[None, :] * ex * dd * 1e-6
    w_v = ((vt * dia) ** 0.5 *
           10.0 ** ((mu_r + 1.0) * np.log10(dia) + 3.0 * mu_r))[None, :] * ex * dd * 1e-6
    dum1 = (vt[None, :] * w_n).sum(1)
    dum2 = np.maximum(w_n.sum(1), 1e-30)
    dum3 = (vt[None, :] * w_m).sum(1)
    dum4 = np.maximum(w_m.sum(1), 1e-30)
    dum5 = np.maximum(w_v.sum(1), 1e-30)
    vn_col = dum1 / dum2
    vm_col = dum3 / dum4
    revap_col = 10.0 ** (np.log10(dum5) + (mu_r + 1.0) * np.log10(lamr) -
                         3.0 * mu_r)
    # constant mu_r -> all 10 mu columns identical (p3_init_b mu_r_loop)
    vn = np.repeat(vn_col[:, None], 10, axis=1)
    vm = np.repeat(vm_col[:, None], 10, axis=1)
    revap = np.repeat(revap_col[:, None], 10, axis=1)
    return vn, vm, revap


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device, dtype: torch.dtype):
    """(ice, collect, vn, vm, revap) as tensors on ``device`` in
    ``dtype``, built once per (device, dtype)."""
    ice, coll = load_ice_tables()
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (ice, coll, *build_rain_tables()))


# ---------------------------------------------------------------------------
# index computation (zero-based integer indices; the interpolation below
# reads only the fractional positions)
# ---------------------------------------------------------------------------

def _floor_int(x):
    return torch.floor(x).to(torch.int32)


def indices_1a(qi, ni, qm, rhop):
    """Ice-table fractional indices (find_lookupTable_indices_1a,
    micro_p3.F90:1620-1677). Returns (dumi, dumjj, dumii, dum1, dum4, dum5)
    with integer indices ZERO-based."""
    dum1 = (torch.log10(qi / torch.clamp(ni, min=1e-300)) + 18.0) * \
        LOOKUP_TABLE_1A_DUM1_C - 10.0
    dumi = _floor_int(dum1)
    dum1 = torch.clamp(dum1, 1.0, float(ISIZE))
    dumi = torch.clamp(dumi, 1, ISIZE - 1)
    dum4 = (qm / torch.clamp(qi, min=1e-300)) * 3.0 + 1.0
    dumii = _floor_int(dum4)
    dum4 = torch.clamp(dum4, 1.0, float(RIMSIZE))
    dumii = torch.clamp(dumii, 1, RIMSIZE - 1)
    dum5 = torch.where(rhop <= 650.0, (rhop - 50.0) * 0.005 + 1.0,
                       (rhop - 650.0) * 0.004 + 4.0)
    dumjj = _floor_int(dum5)
    dum5 = torch.clamp(dum5, 1.0, float(DENSIZE))
    dumjj = torch.clamp(dumjj, 1, DENSIZE - 1)
    return dumi - 1, dumjj - 1, dumii - 1, dum1 - 1, dum4 - 1, dum5 - 1


def indices_1b(qr, nr):
    """Rain-collection fractional index (find_lookupTable_indices_1b,
    :1681-1720). Zero-based."""
    active = (qr >= 1e-14) & (nr > 0.0)
    dumlr = (qr / (np.pi * CONST.rho_h2o * torch.clamp(nr, min=1e-300))) \
        ** (1.0 / 3.0)
    dum3 = (torch.log10(torch.clamp(dumlr, min=1e-300)) + 5.0) * 10.70415
    dumj = _floor_int(dum3)
    dum3 = torch.clamp(dum3, 1.0, float(RCOLLSIZE))
    dumj = torch.clamp(dumj, 1, RCOLLSIZE - 1)
    dumj = torch.where(active, dumj, 1)
    dum3 = torch.where(active, dum3, 1.0)
    return dumj - 1, dum3 - 1


def indices_3(mu_r, lamr):
    """Rain-table fractional indices (find_lookupTable_indices_3,
    :1725-1770). Zero-based."""
    dum1 = (mu_r + 1.0) / torch.clamp(lamr, min=1e-300)
    small = dum1 <= 195.0e-6
    rdumii_s = torch.clamp((dum1 * 1e6 + 5.0) * 0.1, 1.0, 20.0)
    rdumii_l = torch.clamp((dum1 * 1e6 - 195.0) / 30.0 + 20.0, 20.0, 300.0)
    rdumii = torch.where(small, rdumii_s, rdumii_l)
    dumii = _floor_int(rdumii)
    dumii = torch.where(small, torch.clamp(dumii, 1, 20),
                        torch.clamp(dumii, 20, 299))
    rdumjj = torch.clamp(mu_r + 1.0, 1.0, 10.0)
    dumjj = torch.clamp(_floor_int(rdumjj), 1, 9)
    return dumii - 1, dumjj - 1, rdumii - 1, rdumjj - 1


# ---------------------------------------------------------------------------
# interpolation as hat-weight contractions
# ---------------------------------------------------------------------------

def _hat(n, x):
    """(..., n) dense linear-interp weights for fractional position x."""
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - (k - x[..., None]).abs(), min=0.0)


def _entries(tab, indices):
    """tab[..., indices] as views stacked on the device: a list index
    would be a host copy, which a captured step cannot make."""
    return torch.stack([tab[..., i] for i in indices], dim=-1)


def access_ice_table_multi(tab, indices, dum1, dum4, dum5):
    """Trilinear interpolation of several table entries at one set of
    fractional positions, one batched contraction (micro_p3.F90:
    1508-1545). Returns a tuple in the order of ``indices``."""
    t = _entries(tab, indices)                   # (5, 4, ISIZE, K)
    wi = _hat(t.shape[2], dum1)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    T1 = torch.einsum('...i,jkie->...jke', wi, t)
    T2 = torch.einsum('...k,...jke->...je', wii, T1)
    out = torch.einsum('...j,...je->...e', wjj, T2)
    return tuple(out[..., n] for n in range(len(indices)))


def access_collect_table_multi(tab, indices, dum1, dum3, dum4, dum5):
    """Quadrilinear interpolation of several collection-table entries at
    one set of fractional positions (access_lookup_table_coll,
    :1548-1615). The size axis is contracted first, then the rain-size
    axis, so no (points, ISIZE, RCOLLSIZE) outer product is formed.
    Returns a tuple in the order of ``indices``."""
    t = _entries(tab, indices)                   # (5, 4, ISIZE, J, K)
    wi = _hat(t.shape[2], dum1)
    wj = _hat(t.shape[3], dum3)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    T0 = torch.einsum('...i,abije->...abje', wi, t)
    T1 = torch.einsum('...j,...abje->...abe', wj, T0)
    T2 = torch.einsum('...b,...abe->...ae', wii, T1)
    out = torch.einsum('...a,...ae->...e', wjj, T2)
    return tuple(out[..., n] for n in range(len(indices)))


def access_rain_table(tab, dumii, dumjj, rdumii, rdumjj):
    """Bilinear interpolation in a rain (size, mu) table
    (compute_rain_fall_velocity, :3893-3907)."""
    return access_rain_table_multi((tab,), rdumii, rdumjj)[0]


def access_rain_table_multi(tabs, rdumii, rdumjj):
    """Bilinear interpolation of several (300, 10) rain tables at one
    fractional position in one contraction. Returns a tuple."""
    t = torch.stack(list(tabs), dim=-1)           # (300, 10, K)
    wi = _hat(t.shape[0], rdumii)
    wj = _hat(t.shape[1], rdumjj)
    T1 = torch.einsum('...i,ije->...je', wi, t)
    out = torch.einsum('...j,...je->...e', wj, T1)
    return tuple(out[..., n] for n in range(t.shape[-1]))

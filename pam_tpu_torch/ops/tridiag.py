"""Tridiagonal solves along axis 0: the sequential Thomas recurrence and
parallel cyclic reduction (PCR) (port of pam_tpu/ops/tridiag.py and of
the sequential branches of pam_tpu/spam/si.py::_tridiag:439-467 and
::_tridiag_real:767-800; ref extrudedmodel.h:3025-3050 and
solve_for_pressure:3806-3830).

Thomas takes n dependent steps, a few small operations each, so on the
card a 50-level solve is hundreds of launches issued one after another.
PCR does ceil(log2 n) whole-tensor sweeps instead: more arithmetic, far
fewer steps; it is stable for the diagonally dominant (I + dt L) systems
the callers build.

``PAM_TRIDIAG=thomas|pcr|auto``, read at import as ``pam_tpu`` reads it;
auto (the default) takes PCR for a tensor that is not on the CPU and
Thomas on the CPU, ``pam_tpu``'s rule (there: PCR on every backend but
the CPU).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

_TRIDIAG_MODE = os.environ.get("PAM_TRIDIAG", "auto")


def use_pcr(x: torch.Tensor) -> bool:
    """True when the solve for tensor ``x`` takes PCR (by ``_TRIDIAG_MODE``
    and, under auto, by the device ``x`` lies on)."""
    if _TRIDIAG_MODE == "pcr":
        return True
    if _TRIDIAG_MODE == "thomas":
        return False
    return x.device.type != "cpu"


def shift0(a: torch.Tensor, off: int, fill: float = 0.0) -> torch.Tensor:
    """a[i + off] along axis 0, ``fill`` where i + off is out of range."""
    if off == 0:
        return a
    n = abs(off)
    lead = (0, 0) * (a.dim() - 1)
    if off > 0:
        return F.pad(a[off:], lead + (0, n), value=fill)
    return F.pad(a[:off], lead + (n, 0), value=fill)


def pcr(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor,
        R: torch.Tensor) -> torch.Tensor:
    """Parallel cyclic reduction of L[k] x[k-1] + D[k] x[k] + U[k] x[k+1]
    = R[k] along axis 0 (L[0] and U[n-1] zero), in ``pam_tpu``'s order of
    operations. L/D/U broadcast against R (the SHOC solve gives them a
    trailing dim of 1 against a stacked R (n, ..., m)). Returns x with
    R's shape."""
    n = L.shape[0]
    k = 1
    while k < n:
        Dm = shift0(D, -k, 1.0)
        Dp = shift0(D, k, 1.0)
        alpha = -L / Dm
        beta = -U / Dp
        newD = D + alpha * shift0(U, -k) + beta * shift0(L, k)
        newR = R + alpha * shift0(R, -k) + beta * shift0(R, k)
        newL = alpha * shift0(L, -k)
        newU = beta * shift0(U, k)
        L, D, U, R = newL, newD, newU, newR
        k *= 2
    return R / D


def thomas(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor,
           R: torch.Tensor) -> torch.Tensor:
    """Solve L[k] x[k-1] + D[k] x[k] + U[k] x[k+1] = R[k] for k along axis
    0 (L[0] and U[n-1] ignored), batched over the trailing axes. The
    elimination factors c take the coefficients' dtype, so real
    coefficients with a complex right-hand side keep c real (the pressure
    systems), as pam_tpu's scan carries them."""
    n = R.shape[0]
    c_prev = torch.zeros_like(D[0])
    y_prev = torch.zeros_like(R[0])
    cs, ys = [], []
    for k in range(n):
        denom = D[k] - L[k] * c_prev
        c_prev = U[k] / denom
        y_prev = (R[k] - L[k] * y_prev) / denom
        cs.append(c_prev)
        ys.append(y_prev)
    x = [None] * n
    x_next = torch.zeros_like(R[0])
    for k in range(n - 1, -1, -1):
        x_next = ys[k] - cs[k] * x_next
        x[k] = x_next
    return torch.stack(x)

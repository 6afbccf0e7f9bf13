"""The tridiagonal solve along axis 0 by the sequential Thomas recurrence
(port of the sequential branches of pam_tpu/ops/tridiag.py and
pam_tpu/spam/si.py::_tridiag:439-467; ref extrudedmodel.h:3025-3050).
"""

from __future__ import annotations

import torch


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

"""Plotting and analysis utilities (port of pam_tpu/utils/plotting.py;
ref utils/plotting/{ke_spectra.py, tracer_min.py, skewt.py, plot.py}).

The analysis functions (running mean, KE spectra, tracer minima, dew
point) take tensors or arrays and compute on the tensors' device, in
float64 where pam_tpu does. The figures need matplotlib, imported when a
``plot_*`` function is called (the card's installation has none), and
the skew-T uses metpy where it imports, else a plain T / log-p plot.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def running_mean(x, N: int) -> torch.Tensor:
    """Boundary-shrinking running mean along the first axis
    (utils/plotting/ke_spectra.py rm), in float64: a centred N-window
    [i - N//2, i - N//2 + N) clipped to the array, so it shrinks
    symmetrically at both ends. As in pam_tpu, a window of an array of
    more dims averages over its trailing axes too. Each window is summed
    on its own (a spectrum spans many decades, which differences of a
    cumulative sum would not resolve)."""
    x = _tensor(x, torch.float64)
    n = x.shape[0]
    rows = x.reshape(n, -1).mean(dim=1)
    h = N // 2
    i = torch.arange(n, device=x.device)
    lo = (i - h).clamp(min=0)
    cnt = torch.maximum((i + (N - h)).clamp(max=n), lo + 1) - lo
    j = torch.arange(max(N, 1), device=x.device)
    inside = j[None, :] < cnt[:, None]
    idx = torch.where(inside, lo[:, None] + j[None, :], 0)
    win = torch.where(inside, rows[idx], 0.0).sum(dim=1) / cnt
    return win.reshape((n,) + (1,) * (x.ndim - 1)).expand(x.shape).clone()


def ke_spectra(u, v, w, dx: float = 500.0):
    """1-D kinetic-energy spectrum along the last axis
    (utils/plotting/ke_spectra.py ke_spectra), with ``torch.fft`` on the
    fields' device. Returns (freq, power): E(k) = 0.5 (|u_k|^2 + |v_k|^2
    + |w_k|^2) per row, averaged over the leading axes (the spectra of
    the rows, not the spectrum of averaged fields, which opposite-phase
    levels would cancel)."""
    rows = [_tensor(a) for a in (u, v, w)]
    rows = [r.reshape(-1, r.shape[-1]) for r in rows]
    nx = rows[0].shape[-1]
    spd = sum(0.5 * (torch.fft.rfft(r, dim=-1).abs() ** 2).mean(dim=0)
              for r in rows)
    freq = torch.fft.rfftfreq(nx, d=dx, dtype=spd.real.dtype,
                              device=spd.device)
    return freq, spd


def tracer_min(state, names=None) -> dict:
    """Global minimum of each tracer field (utils/plotting/tracer_min.py),
    the positivity monitor of FCT; every field but the velocities and
    temperature unless ``names`` are given."""
    names = names or [k for k in state
                      if k not in ("uvel", "vvel", "wvel", "temp")]
    return {n: float(_tensor(state[n]).min()) for n in names}


def dew_point(temp, rho_v) -> torch.Tensor:
    """Dew point (C) from temperature (K) and vapour density (kg/m3) by
    inverting the Magnus saturation formula of the moist initial states
    (extrudedmodel.h:5209-5212): e = rho_v Rv T; Td solves svp(Td) = e."""
    Rv = 461.0
    e = torch.clamp(_tensor(rho_v) * Rv * _tensor(temp), min=1e-10)
    ln = torch.log(e / 610.94)
    return 243.04 * ln / (17.625 - ln)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_ke_spectra(freqs_spds, labels=None, smooth: int = 3, out=None):
    """Log-log overlay of KE spectra (ke_spectra.py main)."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    for i, (f, s) in enumerate(freqs_spds):
        lbl = labels[i] if labels else None
        ax.loglog(_numpy(f)[1:], _numpy(running_mean(s, smooth))[1:],
                  label=lbl)
    ax.set_xlabel("wavenumber [1/m]")
    ax.set_ylabel("KE power")
    if labels:
        ax.legend()
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig


def plot_skewt(pressure, temp, dew=None, out=None):
    """Skew-T of a sounding with metpy where it imports, else T against
    log p (utils/plotting/skewt.py)."""
    plt = _pyplot()
    p_hpa = _numpy(pressure) / 100
    t_c = _numpy(temp) - 273.15
    dew = None if dew is None else _numpy(dew)
    try:
        from metpy.plots import SkewT
    except ImportError:
        fig, ax = plt.subplots(figsize=(6, 8))
        ax.semilogy(t_c, p_hpa, "r", label="T")
        if dew is not None:
            ax.semilogy(dew, p_hpa, "g", label="Td")
        ax.invert_yaxis()
        ax.set_xlabel("T [C]")
        ax.set_ylabel("p [hPa]")
        ax.legend()
    else:
        fig = plt.figure(figsize=(9, 11))
        skew = SkewT(fig, rotation=45)
        skew.plot(p_hpa, t_c, "r")
        if dew is not None:
            skew.plot(p_hpa, dew, "g")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig


def plot_field_panels(field2d_by_name, out=None, ncols: int = 2):
    """Panels of 2-D (z, x) fields (utils/plotting/plot.py,
    plot_extrudedmodel2D*.py)."""
    plt = _pyplot()
    names = list(field2d_by_name)
    n = len(names)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 3.5 * nrows),
                             squeeze=False)
    for i, name in enumerate(names):
        ax = axes[i // ncols][i % ncols]
        im = ax.imshow(_numpy(field2d_by_name[name]), origin="lower",
                       aspect="auto", cmap="RdBu_r")
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig

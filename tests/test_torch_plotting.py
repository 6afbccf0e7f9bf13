"""The port's analysis and plotting utilities (pam_tpu_torch/utils/
plotting.py) against pam_tpu's (pam_tpu/utils/plotting.py): the four
analysis functions on seeded numpy inputs in float64 at 1e-12, and each
plot_* rendered to a temporary file where matplotlib imports."""

import numpy as np
import pytest
import torch

from pam_tpu.utils import plotting as jplo
from pam_tpu_torch.utils import plotting as tplo

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0.0)


@pytest.mark.parametrize("n, N", [(10, 3), (33, 4), (7, 1), (5, 9), (64, 6)])
def test_running_mean_matches_pam_tpu(n, N):
    x = np.random.default_rng(n * 10 + N).standard_normal(n) * 10.0 ** \
        np.linspace(6, -6, n)    # a spectrum's dynamic range
    _close(tplo.running_mean(torch.as_tensor(x), N), jplo.running_mean(x, N))


def test_running_mean_of_rows_matches_pam_tpu():
    """A window of an array of more dims averages its trailing axes too."""
    x = np.random.default_rng(3).standard_normal((12, 5))
    _close(tplo.running_mean(torch.as_tensor(x), 3), jplo.running_mean(x, 3))


@pytest.mark.parametrize("shape, dx", [((128,), 500.0), ((3, 4, 65), 2000.0),
                                       ((2, 50, 1, 64), 250.0)])
def test_ke_spectra_matches_pam_tpu(shape, dx):
    rng = np.random.default_rng(len(shape))
    u, v, w = (rng.standard_normal(shape) for _ in range(3))
    f_t, s_t = tplo.ke_spectra(*(torch.as_tensor(a) for a in (u, v, w)),
                               dx=dx)
    f_j, s_j = jplo.ke_spectra(u, v, w, dx=dx)
    _close(f_t, f_j)
    _close(s_t, s_j)


def test_ke_spectra_single_mode_and_phase():
    """A single mode peaks at its wavenumber, and opposite-phase rows
    keep their power (pam_tpu's tests/test_plotting.py case)."""
    nx, dx = 128, 500.0
    u = torch.sin(2 * np.pi * 4 * torch.arange(nx, dtype=torch.float64) / nx)
    _, spd = tplo.ke_spectra(u, 0 * u, 0 * u, dx=dx)
    assert int(torch.argmax(spd[1:])) + 1 == 4
    u2 = torch.stack([u, -u])
    _, spd2 = tplo.ke_spectra(u2, 0 * u2, 0 * u2, dx=dx)
    _close(spd2, spd.numpy())


def test_tracer_min_matches_pam_tpu():
    rng = np.random.default_rng(5)
    state = {k: rng.standard_normal((2, 6, 1, 8)) for k in
             ("water_vapor", "cloud_liquid", "precip_liquid", "uvel",
              "wvel", "temp")}
    want = jplo.tracer_min(state)
    got = tplo.tracer_min({k: torch.as_tensor(v) for k, v in state.items()})
    assert got == want and sorted(got) == ["cloud_liquid", "precip_liquid",
                                           "water_vapor"]
    assert tplo.tracer_min({k: torch.as_tensor(v) for k, v in state.items()},
                           ["temp"]) == jplo.tracer_min(state, ["temp"])


def test_dew_point_matches_pam_tpu():
    rng = np.random.default_rng(6)
    temp = 220.0 + 90.0 * rng.random((50, 65))
    rho_v = 0.02 * rng.random((50, 65)) ** 3
    rho_v[0, :5] = 0.0                  # the floor on e
    _close(tplo.dew_point(torch.as_tensor(temp), torch.as_tensor(rho_v)),
           jplo.dew_point(temp, rho_v))


def _sounding():
    p = torch.linspace(1.0e5, 1.0e4, 30, dtype=torch.float64)
    t = 300.0 - 60.0 * (1.0 - p / 1.0e5)
    return p, t, tplo.dew_point(t, 0.01 * p / 1.0e5)


@pytest.mark.parametrize("what", ["ke_spectra", "skewt", "field_panels"])
def test_plots_render(tmp_path, what):
    """Each figure renders to a file (where matplotlib imports); the
    skew-T takes metpy's plot where metpy imports, else T against log
    p, as pam_tpu's does."""
    pytest.importorskip("matplotlib")
    out = tmp_path / f"{what}.png"
    if what == "ke_spectra":
        u = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 64)))
        fig = tplo.plot_ke_spectra([tplo.ke_spectra(u, u, u)], labels=["a"],
                                   out=str(out))
    elif what == "skewt":
        fig = tplo.plot_skewt(*_sounding(), out=str(out))
    else:
        z = torch.arange(24.0, dtype=torch.float64).reshape(4, 6)
        fig = tplo.plot_field_panels({"a": z, "b": -z, "c": z * z},
                                     out=str(out))
        assert sum(ax.axison for ax in fig.axes) == 3 + 3   # + colorbars
    assert out.exists() and out.stat().st_size > 1000
    import matplotlib.pyplot as plt
    plt.close(fig)

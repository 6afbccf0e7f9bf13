"""Explicit time integrators of the SPAM dycore (port of
pam_tpu/spam/timesteppers.py; ref dynamics/spam/src/timesteppers/
SSPRK.h ssprk2/3/34 :33-82, KGRK.h Kinnmark-Gray stages :57-130, LSRK.h
low-storage RK :29-125). The semi-implicit integrators are in si.py.

Every stepper takes ``rhs(x) -> F`` with dx/dt = -F (the reference's
waxpy(-dt, F, x)) and a state x that is a tuple of tensors.
"""

from __future__ import annotations


def _axpy(a, F, x):
    """x + a*F, field by field."""
    return tuple(xi + a * fi for xi, fi in zip(x, F))


def _lincomb(ax, x, ay, y, az, F):
    return tuple(ax * xi + ay * yi + az * fi for xi, yi, fi in zip(x, y, F))


def ssprk2_step(rhs, x, dt):
    """(SSPRK.h:34-44)."""
    F = rhs(x)
    x1 = _axpy(-dt, F, x)
    F = rhs(x1)
    return _lincomb(0.5, x, 0.5, x1, -0.5 * dt, F)


def ssprk3_step(rhs, x, dt):
    """(SSPRK.h:45-60)."""
    F = rhs(x)
    x1 = _axpy(-dt, F, x)
    F = rhs(x1)
    x2 = _lincomb(0.75, x, 0.25, x1, -0.25 * dt, F)
    F = rhs(x2)
    return _lincomb(1.0 / 3.0, x, 2.0 / 3.0, x2, -(2.0 / 3.0) * dt, F)


def ssprk34_step(rhs, x, dt):
    """4-stage 3rd-order SSPRK (Spiteri-Ruuth SSP(4,3), SSPRK.h:61-79)
    with all stages forward, as pam_tpu takes it: the reference's first
    stage waxpy(+dt/2, F, x) (SSPRK.h:64) is a backward half-step under its
    dx/dt = -F convention, an apparent sign typo (no reference config uses
    ssprk34)."""
    F = rhs(x)
    x1 = _axpy(-0.5 * dt, F, x)
    F = rhs(x1)
    x2 = _axpy(-0.5 * dt, F, x1)
    F = rhs(x2)
    x3 = _lincomb(2.0 / 3.0, x, 1.0 / 3.0, x2, -(1.0 / 6.0) * dt, F)
    F = rhs(x3)
    return _axpy(-0.5 * dt, F, x3)


_KGRK_COEFFS = {
    2: (1 / 2, 1.0),
    3: (1 / 3, 1 / 2, 1.0),
    4: (1 / 4, 1 / 3, 1 / 2, 1.0),
    5: (1 / 5, 1 / 5, 1 / 3, 1 / 2, 1.0),
    6: (1 / 6, 2 / 15, 1 / 4, 1 / 3, 1 / 2, 1.0),
    7: (1 / 7, 2 / 21, 1 / 5, 8 / 35, 1 / 3, 1 / 2, 1.0),
    8: (1 / 8, 1 / 14, 1 / 6, 1 / 6, 1 / 4, 1 / 3, 1 / 2, 1.0),
    9: (1 / 9, 1 / 18, 1 / 7, 8 / 63, 1 / 5, 5 / 21, 1 / 3, 1 / 2, 1.0),
    10: (1 / 10, 2 / 45, 1 / 8, 1 / 10, 1 / 6, 9 / 50, 1 / 4, 1 / 3,
         1 / 2, 1.0),
}


def kgrk_step(rhs, x, dt, nstages: int = 4):
    """Kinnmark-Gray RK: xtemp = x - c_i dt F(xtemp) (KGRK.h:38-53)."""
    xt = x
    for c in _KGRK_COEFFS[nstages]:
        xt = _axpy(-c * dt, rhs(xt), x)
    return xt


_LSRK_COEFFS = {
    5: (
        (0.0, -567301805773.0 / 1357537059087.0,
         -2404267990393.0 / 2016746695238.0,
         -3550918686646.0 / 2091501179385.0,
         -1275806237668.0 / 842570457699.0),
        (1432997174477.0 / 9575080441755.0,
         5161836677717.0 / 13612068292357.0,
         1720146321549.0 / 2090206949498.0,
         3134564353537.0 / 4481467310338.0,
         2277821191437.0 / 14882151754819.0),
    ),
    12: (
        (0, -0.0923311242368072, -0.9441056581158819, -4.3271273247576394,
         -2.1557771329026072, -0.9770727190189062, -0.7581835342571139,
         -1.7977525470825499, -2.6915667972700770, -4.6466798960268143,
         -0.1539613783825189, -0.5943293901830616),
        (0.0650008435125904, 0.0161459902249842, 0.5758627178358159,
         0.1649758848361671, 0.3934619494248182, 0.0443509641602719,
         0.2074504268408778, 0.6914247433015102, 0.3766646883450449,
         0.0757190350155483, 0.2027862031054088, 0.2167029365631842),
    ),
    13: (
        (0, -0.6160178650170565, -0.4449487060774118, -1.0952033345276178,
         -1.2256030785959187, -0.2740182222332805, -0.0411952089052647,
         -0.1797084899153560, -1.1771530652064288, -0.4078831463120878,
         -0.8295636426191777, -4.7895970584252288, -0.6606671432964504),
        (0.0271990297818803, 0.1772488819905108, 0.0378528418949694,
         0.6086431830142991, 0.2154313974316100, 0.2066152563885843,
         0.0415864076069797, 0.0219891884310925, 0.9893081222650993,
         0.0063199019859826, 0.3749640721105318, 1.6080235151003195,
         0.0961209123818189),
    ),
    14: (
        (0, -0.7188012108672410, -0.7785331173421570, -0.0053282796654044,
         -0.8552979934029281, -3.9564138245774565, -1.5780575380587385,
         -2.0837094552574054, -0.7483334182761610, -0.7032861106563359,
         0.0013917096117681, -0.0932075369637460, -0.9514200470875948,
         -7.1151571693922548),
        (0.0367762454319673, 0.3136296607553959, 0.1531848691869027,
         0.0030097086818182, 0.3326293790646110, 0.2440251405350864,
         0.3718879239592277, 0.6204126221582444, 0.1524043173028741,
         0.0760894927419266, 0.0077604214040978, 0.0024647284755382,
         0.0780348340049386, 5.5059777270269628),
    ),
}


def lsrk_step(rhs, x, dt, nstages: int = 5):
    """Low-storage RK (Carpenter-Kennedy family): dx = a_s dx + F(x);
    x = x - b_s dt dx (LSRK.h:114-123)."""
    rka, rkb = _LSRK_COEFFS[nstages]
    dx = None
    for a, b in zip(rka, rkb):
        F = rhs(x)
        dx = F if dx is None else tuple(a * di + fi for di, fi in zip(dx, F))
        x = _axpy(-b * dt, dx, x)
    return x


STEPPERS = {
    "ssprk2": ssprk2_step,
    "ssprk3": ssprk3_step,
    "ssprk34": ssprk34_step,
    **{f"kgrk{n}": (lambda rhs, x, dt, n=n: kgrk_step(rhs, x, dt, n))
       for n in _KGRK_COEFFS},
    **{f"lsrk{n}": (lambda rhs, x, dt, n=n: lsrk_step(rhs, x, dt, n))
       for n in _LSRK_COEFFS},
}

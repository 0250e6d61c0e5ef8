"""Explicit Runge-Kutta Butcher tableaus: a copy of the JAX package's
``ode/tableaus.py`` (plain Python data). ``midpoint`` is the production
setting."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class ButcherTableau(NamedTuple):
    """Explicit RK tableau. ``a`` is strictly lower triangular (list of rows)."""

    name: str
    order: int
    c: Tuple[float, ...]  # stage times (fractions of h)
    a: Tuple[Tuple[float, ...], ...]  # stage coupling, row i has i entries
    b: Tuple[float, ...]  # solution weights
    b_err: Optional[Tuple[float, ...]] = None  # embedded-error weights (b - b*)
    c_mid: Optional[Tuple[float, ...]] = None  # dense-output midpoint weights


EULER = ButcherTableau(name="euler", order=1, c=(0.0,), a=((),), b=(1.0,))

MIDPOINT = ButcherTableau(
    name="midpoint",
    order=2,
    c=(0.0, 0.5),
    a=((), (0.5,)),
    b=(0.0, 1.0),
)

HEUN = ButcherTableau(
    name="heun",
    order=2,
    c=(0.0, 1.0),
    a=((), (1.0,)),
    b=(0.5, 0.5),
)

RK4 = ButcherTableau(
    name="rk4",
    order=4,
    c=(0.0, 0.5, 0.5, 1.0),
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
)

# Dormand-Prince 5(4). b_err = b5 - b4 (error estimate weights).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600,
    0.0,
    7571 / 16695,
    393 / 640,
    -92097 / 339200,
    187 / 2100,
    1 / 40,
)
_DP_BERR = tuple(b5 - b4 for b5, b4 in zip(_DP_B, _DP_B4))
# 4th-order dense-output midpoint weights for dopri5 (Shampine).
_DP_CMID = (
    6025192743 / 30085553152 / 2,
    0.0,
    51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2,
    187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2,
    11237099 / 235043384 / 2,
)

DOPRI5 = ButcherTableau(
    name="dopri5",
    order=5,
    c=_DP_C,
    a=_DP_A,
    b=_DP_B,
    b_err=_DP_BERR,
    c_mid=_DP_CMID,
)

TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "heun": HEUN,
    "rk4": RK4,
    "dopri5": DOPRI5,
}


def get_tableau(method: str) -> ButcherTableau:
    try:
        return TABLEAUS[method]
    except KeyError as e:
        raise ValueError(
            f"Unknown ODE method {method!r}; available: {sorted(TABLEAUS)}"
        ) from e


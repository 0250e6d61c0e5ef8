"""Semilinear solve of production-degradation dynamics
``dx/dt = a(t) - d(t) * x`` (the JAX package's ``ode/semilinear.py``).

The dynamics net never sees the state, so (as in the JAX package) the net is
evaluated at all RK stage times at once, every explicit RK step is extracted
exactly as an elementwise affine map ``x_{n+1} = A_n x_n + B_n`` by running the
RK recurrence at ``x = 0`` and ``x = 1``, and the recurrence is solved by a
scan. PyTorch has no associative scan, so the scan is either the plain loop
(``backend='seq'``) or kernel K1 (``backend='kernel'``, ops/recurrence.py),
which on the CPU is K1's plain version.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from structured_latent_odes_tpu_torch.ode.tableaus import ButcherTableau, get_tableau
from structured_latent_odes_tpu_torch.ops.recurrence import affine_scan, affine_scan_plain

Tensor = torch.Tensor


def stage_time_grid(ts: Tensor, tableau: ButcherTableau) -> Tensor:
    """All RK stage times, shape (T-1, S): ``ts[n] + c_i * (ts[n+1] - ts[n])``.

    The c_i enter as Python scalars: a tensor of them built on the card would
    be a host-to-device copy, which stalls the host on every request."""
    h = ts[1:] - ts[:-1]
    return torch.stack([ts[:-1] + h * c for c in tableau.c], dim=1)


def rk_affine_coeffs(
    a_stages: Tensor, d_stages: Tensor, h: Tensor, tableau: ButcherTableau
) -> Tuple[Tensor, Tensor]:
    """Exact per-step affine map (A, B) of the RK step for
    ``dx/dt = a - d * x``.

    a_stages, d_stages: ``(..., T-1, S, D)``; h: ``(T-1,)`` (or a scalar for
    one step with ``(..., S, D)`` stages). Returns (A, B) of shape
    ``(..., T-1, D)``: B is the update run from ``x = 0``, A + B the update run
    from ``x = 1``.
    """
    hh = h.unsqueeze(-1)

    def run(x0: Tensor) -> Tensor:
        ks = []
        for i, ai_row in enumerate(tableau.a):
            yi = x0
            for aij, kj in zip(ai_row, ks):
                if aij != 0.0:
                    yi = yi + (hh * aij) * kj
            ks.append(a_stages[..., i, :] - d_stages[..., i, :] * yi)
        x1 = x0
        for bi, ki in zip(tableau.b, ks):
            if bi != 0.0:
                x1 = x1 + (hh * bi) * ki
        return x1

    zeros = torch.zeros_like(a_stages[..., 0, :])
    B = run(zeros)
    A = run(zeros + 1.0) - B
    return A, B


def solve_affine_sequential(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Sequential scan over time axis 0, trajectory including x0."""
    return affine_scan_plain(A, B, x0)


def solve_semilinear(
    prod_degr_fn: Callable[[Tensor], Tuple[Tensor, Tensor]],
    x0: Tensor,
    ts,
    method: str = "midpoint",
    *,
    backend: str = "kernel",
) -> Tensor:
    """Integrate ``dx/dt = a(t) - d(t) x``.

    prod_degr_fn maps the stage-time grid ``(T-1, S)`` to ``(a, d)`` of shape
    ``(B, T-1, S, D)`` (or ``(T-1, S, D)`` unbatched); x0 is ``(B, D)`` (or
    ``(D,)``); ts is ``(T,)``. backend: 'kernel' (K1; its plain version on the
    CPU) or 'seq' (the plain loop). Returns ``(B, T, D)``.
    """
    tableau = get_tableau(method)
    ts = torch.as_tensor(ts, dtype=x0.dtype, device=x0.device)
    stage_ts = stage_time_grid(ts, tableau)
    a, d = prod_degr_fn(stage_ts)
    A, B = rk_affine_coeffs(a, d, ts[1:] - ts[:-1], tableau)
    if backend == "kernel":
        return affine_scan(A, B, x0)
    if backend == "seq":
        if A.ndim == 3:
            sol = solve_affine_sequential(A.movedim(1, 0), B.movedim(1, 0), x0)
            return sol.movedim(0, 1)
        return solve_affine_sequential(A, B, x0)
    raise ValueError(f"unknown backend {backend!r}")

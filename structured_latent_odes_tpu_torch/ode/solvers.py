"""Batched ODE integrators (the JAX package's ``ode/solvers.py``) in plain
PyTorch: no Pallas kernel backs them in JAX, so none backs them here.

- :func:`rk_step`: one explicit RK step of any tableau (with the embedded
  error estimate where the tableau has one).
- :func:`odeint`: one fixed RK step per interval of ``ts`` (non-uniform and
  decreasing grids alike), differentiated by autograd; ``remat=True``
  checkpoints each step and ``remat='chunked'`` chunks of about sqrt(T)
  steps (``torch.utils.checkpoint``), trading recompute for memory.
- :func:`odeint_adaptive`: Dormand-Prince 5(4) with dense output at ``ts``,
  one step schedule for the whole batch (the error norm is a mean over every
  element).
- :func:`odeint_adaptive_per_sample`: the same with a step schedule per row
  of ``y0`` (per-row error norms, masks for rows done or rejected).
- :func:`solve`: the front door over the three.

The adaptive loops test their condition on the host once a trip (one device
sync a trip; on the card each trip past the second is one replay of a CUDA
graph of it), with the JAX package's float32 arithmetic: ``t_next + h``
accumulated in float32, ``t_next < target_t`` compared in float32, the same
defaults (rtol 1e-6, atol 1e-8, 4,096 trips per output interval). Each
solve's trips (accepted and rejected steps) are counted in the solver's
``trips`` counter. Their gradients come from the continuous adjoint
(``ode/adjoint.py``), as in the JAX package, where the while loop's step
control is not reverse-differentiable.
"""

from __future__ import annotations

import collections
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from structured_latent_odes_tpu_torch.ode.tableaus import ButcherTableau, get_tableau
from structured_latent_odes_tpu_torch.utils.graphs import Replayed

Tensor = torch.Tensor
ODEFunc = Callable[[Tensor, Tensor], Tensor]  # f(t, y) -> dy/dt


def rk_step(f: ODEFunc, tableau: ButcherTableau, t0: Tensor, y0: Tensor, h: Tensor):
    """One explicit RK step. Returns (y1, stage derivatives ks, y1's error
    estimate or None)."""
    ks = []
    for ci, ai in zip(tableau.c, tableau.a):
        ti = t0 + ci * h
        yi = y0
        for aij, kj in zip(ai, ks):
            if aij != 0.0:
                yi = yi + (h * aij) * kj
        ks.append(f(ti, yi))
    y1 = y0
    for bi, ki in zip(tableau.b, ks):
        if bi != 0.0:
            y1 = y1 + (h * bi) * ki
    y_err = None
    if tableau.b_err is not None:
        y_err = torch.zeros_like(y0)
        for bi, ki in zip(tableau.b_err, ks):
            if bi != 0.0:
                y_err = y_err + (h * bi) * ki
    return y1, ks, y_err


def odeint(f: ODEFunc, y0: Tensor, ts, method: str = "midpoint", *, remat: "bool | str" = False,
           chunk_size: int = 0) -> Tensor:
    """Integrate ``dy/dt = f(t, y)`` with one ``method`` step per interval of
    ``ts``; returns ``y`` at every time, time-major ``(len(ts), *y0.shape)``.

    ``remat=True`` checkpoints each step (its stages are recomputed in the
    backward, the states kept); ``remat='chunked'`` checkpoints chunks of
    ``chunk_size`` steps (default about sqrt(T)): O(sqrt(T)) live
    activations. Values and gradients equal the plain solve's."""
    tableau = get_tableau(method)
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    n_steps = ts.shape[0] - 1

    def steps(y: Tensor, lo: int, hi: int) -> Tensor:
        out = []
        for i in range(lo, hi):
            y, _, _ = rk_step(f, tableau, ts[i], y, ts[i + 1] - ts[i])
            out.append(y)
        return torch.stack(out)

    if remat == "chunked" or remat is True:
        chunk = 1 if remat is True else (chunk_size or max(1, math.isqrt(n_steps)))
        ys, y = [y0[None]], y0
        for lo in range(0, n_steps, chunk):
            part = checkpoint(steps, y, lo, min(lo + chunk, n_steps), use_reentrant=False)
            ys.append(part)
            y = part[-1]
        return torch.cat(ys)
    if n_steps == 0:
        return y0[None]
    return torch.cat([y0[None], steps(y0, 0, n_steps)])


# ---------------------------------------------------------------------------
# Adaptive dopri5 with dense output (torchdiffeq-style error control)
# ---------------------------------------------------------------------------


def _error_ratio(y_err: Tensor, y0: Tensor, y1: Tensor, rtol: float, atol: float) -> Tensor:
    tol = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    r = y_err / tol
    return torch.sqrt(torch.mean(r * r))


def _initial_step(f: ODEFunc, t0: Tensor, y0: Tensor, order: int, rtol: float, atol: float) -> Tensor:
    f0 = f(t0, y0)
    scale = atol + y0.abs() * rtol
    d0 = torch.sqrt(torch.mean((y0 / scale) ** 2))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + h0 * f0
    f1 = f(t0 + h0, y1)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / scale) ** 2)) / h0
    h1 = torch.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0)),
    )
    return torch.minimum(100.0 * h0, h1)


def _interp_fit_dopri(y0: Tensor, y1: Tensor, ks, c_mid, h: Tensor) -> Tensor:
    """A quartic through y0, y1, f0, f1 and the c_mid midpoint: its five
    coefficients stacked, highest power first."""
    f0, f1 = ks[0], ks[-1]
    y_mid = y0 + h * sum(c * k for c, k in zip(c_mid, ks) if c != 0.0)
    a = 2.0 * h * (f1 - f0) - 8.0 * (y1 + y0) + 16.0 * y_mid
    b = h * (5.0 * f0 - 3.0 * f1) + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = h * (f1 - 4.0 * f0) - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    d = h * f0
    e = y0
    return torch.stack([a, b, c, d, e])


def _interp_eval(coeffs: Tensor, t0: Tensor, t1: Tensor, t: Tensor) -> Tensor:
    theta = torch.clamp((t - t0) / (t1 - t0), 0.0, 1.0)
    a, b, c, d, e = coeffs
    return e + theta * (d + theta * (c + theta * (b + theta * a)))


class _Dopri5:
    """Adaptive dopri5 of ``f`` on states shaped like ``y_like``: the loop
    state in tensors the solver keeps and one graph of a loop trip, reused by
    every :meth:`solve` (the adjoint's interval solves of one sweep share
    them). ``per_row``: one step schedule per row of a ``(B, D)`` state
    (``f`` then takes per-row times ``(B, 1)``), else one for the whole
    state."""

    def __init__(self, f: ODEFunc, y_like: Tensor, rtol: float, atol: float, safety: float = 0.9,
                 ifactor: float = 10.0, dfactor: float = 0.2, per_row: bool = False):
        self.f, self.rtol, self.atol = f, rtol, atol
        self.safety, self.ifactor, self.dfactor, self.per_row = safety, ifactor, dfactor, per_row
        self.tableau = get_tableau("dopri5")
        clock = (y_like.shape[0], 1) if per_row else ()
        self.t_prev, self.t_next, self.h = (y_like.new_zeros(clock) for _ in range(3))
        self.target = y_like.new_zeros(())
        self.y = torch.zeros_like(y_like)
        self.coeffs = y_like.new_zeros((5,) + tuple(y_like.shape))
        self.accepted = torch.zeros((), dtype=torch.int64, device=y_like.device)
        # one loop trip, which reads and writes the loop state: on a CUDA device
        # the first two trips run eagerly on a side stream, the third is
        # captured as a CUDA graph over no inputs, and every trip from then on
        # replays it (utils/graphs.py): the trip's several hundred small
        # operations (seven stages, each a vector-Jacobian product in the
        # adjoint) in one launch, without the host's cost per operation, which
        # otherwise bounds the solve. On the CPU each trip runs eagerly (the
        # graph's plain version).
        self.run = Replayed(lambda _: self._trip(), {}, y_like.device, plain=y_like.device.type != "cuda", warm=2)

    def _trip(self) -> None:
        y, t_prev, t_next, h, coeffs = self.y, self.t_prev, self.t_next, self.h, self.coeffs
        y1, ks, y_err = rk_step(self.f, self.tableau, t_next, y, h)
        if self.per_row:
            alive = t_next < self.target  # (B, 1)
            tol = self.atol + self.rtol * torch.maximum(y.abs(), y1.abs())
            ratio = torch.sqrt(torch.mean((y_err / tol) ** 2, dim=1, keepdim=True))
            accept = (ratio <= 1.0) & alive
        else:
            ratio = _error_ratio(y_err, y, y1, self.rtol, self.atol)
            accept = ratio <= 1.0
        factor = torch.clamp(self.safety * torch.pow(torch.clamp(ratio, min=1e-10), -1.0 / self.tableau.order),
                             self.dfactor, self.ifactor)
        h_new = torch.where(alive, h * factor, h) if self.per_row else h * factor
        new_coeffs = _interp_fit_dopri(y, y1, ks, self.tableau.c_mid, h)
        t_prev_n = torch.where(accept, t_next, t_prev)
        y_n = torch.where(accept, y1, y)
        t_next_n = torch.where(accept, t_next + h, t_next)
        coeffs_n = torch.where(accept[None] if self.per_row else accept, new_coeffs, coeffs)
        for state, value in ((t_prev, t_prev_n), (y, y_n), (t_next, t_next_n), (coeffs, coeffs_n), (h, h_new)):
            state.copy_(value)
        self.accepted.add_(accept.sum())

    def _start(self, y0: Tensor, t0: Tensor) -> None:
        """The loop state at t0: the initial step, from the scalar heuristic
        (per row, its first half)."""
        if self.per_row:
            t0 = t0.expand(y0.shape[0], 1)
            f0 = self.f(t0, y0)
            scale = self.atol + y0.abs() * self.rtol
            d0 = torch.sqrt(torch.mean((y0 / scale) ** 2, dim=1, keepdim=True))
            d1 = torch.sqrt(torch.mean((f0 / scale) ** 2, dim=1, keepdim=True))
            h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
        else:
            h0 = _initial_step(self.f, t0, y0, self.tableau.order, self.rtol, self.atol)
        for state, value in ((self.t_prev, t0), (self.t_next, t0), (self.h, h0), (self.y, y0)):
            state.copy_(value)
        self.coeffs.zero_()
        self.coeffs[4].copy_(y0)
        self.accepted.zero_()

    @torch.no_grad()
    def solve(self, y0: Tensor, ts: Tensor, max_steps: int = 4096) -> Tensor:
        """``y`` at every time of ``ts`` (time-major), from ``y0`` at ts[0];
        each output interval at most ``max_steps`` trips. Not differentiated
        by autograd (the adjoints give the gradients)."""
        self._start(y0, ts[0])
        ys, trips = [y0], 0
        for target in ts[1:]:
            self.target.copy_(target)
            n = 0
            while n < max_steps and bool(torch.any(self.t_next < self.target)):
                self.run({})
                n += 1
            trips += n
            t_prev, t_next = self.t_prev, self.t_next
            if self.per_row:  # a row that took no step yet divides by 1, not by 0
                theta_den = torch.where(t_next == t_prev, 1.0, t_next - t_prev)
                theta = torch.clamp((target - t_prev) / theta_den, 0.0, 1.0)
                a, b, c, d, e = self.coeffs
                y_interp = e + theta * (d + theta * (c + theta * (b + theta * a)))
            else:
                y_interp = _interp_eval(self.coeffs, t_prev, t_next, target)
            # no step taken yet (target == t0): the state itself
            ys.append(torch.where(t_next == t_prev, self.y, y_interp))
        counter = odeint_adaptive_per_sample.trips if self.per_row else odeint_adaptive.trips
        counter.update(solves=1, trips=trips, accepted=int(self.accepted))
        return torch.stack(ys)


def odeint_adaptive(f: ODEFunc, y0: Tensor, ts, *, rtol: float = 1e-6, atol: float = 1e-8, max_steps: int = 4096,
                    safety: float = 0.9, ifactor: float = 10.0, dfactor: float = 0.2) -> Tensor:
    """Adaptive Dormand-Prince 5(4) with dense output at ``ts``: one step
    schedule for the whole of ``y0`` (the error norm is a mean over every
    element), as ``torchdiffeq.odeint(..., method='dopri5')``. Returns
    time-major ``(len(ts), *y0.shape)``."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    return _Dopri5(f, y0, rtol, atol, safety, ifactor, dfactor).solve(y0, ts, max_steps)


odeint_adaptive.trips = collections.Counter()  # solves, loop trips, accepted steps


def odeint_adaptive_per_sample(f: ODEFunc, y0: Tensor, ts, *, rtol: float = 1e-6, atol: float = 1e-8,
                               max_steps: int = 4096, safety: float = 0.9, ifactor: float = 10.0,
                               dfactor: float = 0.2) -> Tensor:
    """Adaptive dopri5 with a step schedule per row (torchode-style): each
    row of ``y0 (B, D)`` keeps its own clock, step and dense output, in
    lockstep; rows done or rejected are masked. ``f(t, y)`` takes a per-row
    time column ``t (B, 1)``. Returns ``(len(ts), B, D)``."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    return _Dopri5(f, y0, rtol, atol, safety, ifactor, dfactor, per_row=True).solve(y0, ts, max_steps)


odeint_adaptive_per_sample.trips = collections.Counter()  # solves, loop trips, accepted (row-)steps


def solve(f: ODEFunc, y0: Tensor, ts, method: str = "midpoint", *, adaptive: bool = False, adjoint: bool = False,
          remat: bool = False, rtol: float = 1e-6, atol: float = 1e-8) -> Tensor:
    """Front door: fixed-step, adaptive, or fixed-step with the continuous
    adjoint's backward."""
    if adjoint:
        from structured_latent_odes_tpu_torch.ode.adjoint import odeint_adjoint

        return odeint_adjoint(lambda t, y, _: f(t, y), y0, ts, (), method=method)
    if adaptive:
        return odeint_adaptive(f, y0, ts, rtol=rtol, atol=atol)
    return odeint(f, y0, ts, method=method, remat=remat)

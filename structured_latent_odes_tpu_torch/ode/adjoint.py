"""Continuous-adjoint backward passes (the JAX package's ``ode/adjoint.py``):
O(1)-memory backprop through a solve, as ``torchdiffeq.odeint_adjoint``.

The forward keeps only the solution at the output times. The backward
integrates the augmented system ``(y, a_y, a_args)`` in reverse between
consecutive output times, with ``dy = f(t, y, args)``, ``da_y = -a_y^T df/dy``
and ``da_args = -a_y^T df/dargs`` (``torch.func.vjp`` of ``f``), adding each
output time's cotangent to ``a_y``:

- :func:`odeint_adjoint`: one fixed step of the forward's method per interval.
- :func:`odeint_adaptive_adjoint`: the forward adaptive (dopri5, or the
  ``forward=`` override such as the per-sample solver); each interval's
  augmented solve adaptive too, in ``s = -t`` so that it runs forward. Its
  error norm is a mean over every element of the flat augmented state, so
  the state holds what the JAX package's ``ravel_pytree((y, a_y,
  (params, z)))`` holds: every leaf of ``args``, the ones ``f`` never reads
  (zero cotangents) included.

Both are ``torch.autograd.Function``s. ``args`` is any pytree of tensors,
passed as its leaves; gradients flow to ``y0`` and to every leaf, never to
``ts``. Under ``torch.func.vmap`` (an ensemble's members) the fixed-step
adjoint is batched as it stands. The adaptive solves, whose trip count
depends on each member's data, take no vmap: an ensemble runs them one
member at a time (``nn/ode_model.py::solve_is_per_member``,
``train/svi.py::over_members``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from structured_latent_odes_tpu_torch.ode.solvers import _Dopri5, odeint, odeint_adaptive, rk_step
from structured_latent_odes_tpu_torch.ode.tableaus import get_tableau

Tensor = torch.Tensor


def _flat(tensors) -> Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split_like(flat: Tensor, like) -> list:
    out, k = [], 0
    for t in like:
        out.append(flat[k:k + t.numel()].view_as(t))
        k += t.numel()
    return out


def _augmented(f, spec, leaves, y_like: Tensor, sign: float = 1.0):
    """The augmented dynamics on the flat state ``[y, a_y, a_args]``, times
    ``sign``; ``t`` enters as ``sign * t`` (``sign = -1``: the system in
    ``s = -t``). Its vector-Jacobian products come from ``torch.func.vjp``
    where the tensors belong to a ``torch.func`` transform (the fixed-step
    adjoint batched by vmap), else from ``torch.autograd.grad`` on leaves
    detached once for the whole solve, which costs the host half as much a
    call."""
    n = y_like.numel()
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in (y_like, *leaves)):
        def vjp(t, y, a_y):
            dy, vjp_fn = torch.func.vjp(lambda y_, *l: f(t, y_, tree_unflatten(list(l), spec)), y, *leaves)
            return (dy, *vjp_fn(-a_y))
    else:
        live = [t.detach().requires_grad_() for t in leaves]
        args = tree_unflatten(live, spec)
        zeros = [torch.zeros_like(t) for t in leaves]

        def vjp(t, y, a_y):
            with torch.enable_grad():
                y = y.detach().requires_grad_()
                dy = f(t, y, args)
                grads = torch.autograd.grad(dy, [y, *live], -a_y, allow_unused=True)
            return (dy.detach(), *(z if g is None else g for g, z in zip(grads, [torch.zeros_like(y_like)] + zeros)))

    def aug_f(t: Tensor, s: Tensor) -> Tensor:
        out = _flat(vjp(t if sign == 1.0 else -t, s[:n].view_as(y_like), s[n:2 * n].view_as(y_like)))
        return out if sign == 1.0 else -out

    return aug_f


def _adjoint_sweep(interval, ys: Tensor, g: Tensor, leaves) -> tuple:
    """The reverse sweep over the output intervals: ``interval(t_idx, aug0)``
    maps the flat augmented state at ``ts[t_idx + 1]`` to its value at
    ``ts[t_idx]``. Returns (dy0, the gradient of every leaf)."""
    a_y = g[-1]
    a_args = torch.zeros(sum(t.numel() for t in leaves), dtype=g.dtype, device=g.device)
    n = a_y.numel()
    for i in range(ys.shape[0] - 2, -1, -1):
        s1 = interval(i, _flat([ys[i + 1], a_y, a_args]))
        a_y = s1[n:2 * n].view_as(a_y) + g[i]
        a_args = s1[2 * n:]
    return a_y, _split_like(a_args, leaves)


class _OdeintAdjoint(torch.autograd.Function):
    """Fixed-step forward, continuous-adjoint backward. Its forward and
    backward are plain tensor code, so ``torch.func.vmap`` batches them as
    they stand."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y0, ts, f, method, spec, *leaves):
        args = tree_unflatten(list(leaves), spec)
        return odeint(lambda t, y: f(t, y, args), y0, ts, method=method)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ts, f, method, spec, *leaves = inputs
        ctx.save_for_backward(output, ts, *leaves)
        ctx.f, ctx.method, ctx.spec = f, method, spec

    @staticmethod
    def backward(ctx, g):
        ys, ts, *leaves = ctx.saved_tensors
        tableau = get_tableau(ctx.method)
        aug_f = _augmented(ctx.f, ctx.spec, leaves, ys[0])

        def interval(i, aug0):  # one step of the method from ts[i+1] back to ts[i]
            return rk_step(aug_f, tableau, ts[i + 1], aug0, ts[i] - ts[i + 1])[0]

        dy0, dleaves = _adjoint_sweep(interval, ys, g, leaves)
        return (dy0, None, None, None, None, *dleaves)


def odeint_adjoint(f: Callable[[Tensor, Tensor, Any], Tensor], y0: Tensor, ts, args: Any = (),
                   method: str = "midpoint") -> Tensor:
    """:func:`~structured_latent_odes_tpu_torch.ode.solvers.odeint` of
    ``f(t, y, args)`` with the continuous adjoint as its backward: one step
    of ``method`` per interval of the augmented system, in reverse.
    Time-major ``(len(ts), *y0.shape)``; gradients to ``y0`` and ``args``."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    leaves, spec = tree_flatten(args)
    return _OdeintAdjoint.apply(y0, ts, f, method, spec, *leaves)


def _adaptive_adjoint_bwd(ys, g, ts, f, rtol, atol, spec, leaves):
    """The adaptive adjoint's sweep for one model: each interval's augmented
    system solved adaptively from ``-ts[i+1]`` to ``-ts[i]`` in ``s = -t``,
    every interval by one solver (its loop state, and on the card its CUDA
    graph of a trip, shared)."""
    aug_f_neg = _augmented(f, spec, leaves, ys[0], sign=-1.0)
    solver = None

    def interval(i, aug0):
        nonlocal solver
        solver = solver or _Dopri5(aug_f_neg, aug0, rtol, atol)
        return solver.solve(aug0, torch.stack([-ts[i + 1], -ts[i]]))[-1]

    dy0, dleaves = _adjoint_sweep(interval, ys, g, leaves)
    return (dy0, *dleaves)


class _OdeintAdaptiveAdjointBwd(torch.autograd.Function):
    """The adaptive adjoint's backward as a function of its own: under
    ``torch.func.grad`` (the dual step) a backward sees the transform's
    wrapped tensors, and this forward sees plain ones, so the sweep takes
    ``_augmented``'s ``torch.autograd.grad`` path (and on the card its CUDA
    graph of a trip)."""

    @staticmethod
    def forward(ys, g, ts, f, rtol, atol, spec, *leaves):
        return _adaptive_adjoint_bwd(ys, g, ts, f, rtol, atol, spec, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the adaptive adjoint's backward has no derivative")


def _adaptive_forward(y0, ts, f, forward, rtol, atol, spec, leaves):
    args = tree_unflatten(list(leaves), spec)
    if forward is not None:
        return forward(y0, args)
    return odeint_adaptive(lambda t, y: f(t, y, args), y0, ts, rtol=rtol, atol=atol)


class _OdeintAdaptiveAdjoint(torch.autograd.Function):
    """Adaptive forward, adaptive continuous-adjoint backward
    (:class:`_OdeintAdaptiveAdjointBwd`)."""

    @staticmethod
    def forward(y0, ts, f, forward, rtol, atol, spec, *leaves):
        return _adaptive_forward(y0, ts, f, forward, rtol, atol, spec, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ts, f, _, rtol, atol, spec, *leaves = inputs
        ctx.save_for_backward(output, ts, *leaves)
        ctx.f, ctx.rtol, ctx.atol, ctx.spec = f, rtol, atol, spec

    @staticmethod
    def backward(ctx, g):
        ys, ts, *leaves = ctx.saved_tensors
        grads = _OdeintAdaptiveAdjointBwd.apply(ys, g, ts, ctx.f, ctx.rtol, ctx.atol, ctx.spec, *leaves)
        return (grads[0], None, None, None, None, None, None, *grads[1:])


def odeint_adaptive_adjoint(f: Callable[[Tensor, Tensor, Any], Tensor], y0: Tensor, ts, args: Any = (), *,
                            rtol: float = 1e-6, atol: float = 1e-8,
                            forward: Optional[Callable[[Tensor, Any], Tensor]] = None) -> Tensor:
    """Adaptive (dopri5) forward solve of ``f(t, y, args)`` with the
    continuous adjoint as its backward, itself adaptive between consecutive
    output times. ``forward(y0, args)`` optionally replaces the forward
    integrator (e.g. the per-sample solver) and returns the solution at
    ``ts``. Time-major ``(len(ts), *y0.shape)``."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    leaves, spec = tree_flatten(args)
    return _OdeintAdaptiveAdjoint.apply(y0, ts, f, forward, rtol, atol, spec, *leaves)

"""Sequence-parallel (time-sharded) semilinear solve over the ranks of a
grid's time axis (the JAX package's ``parallel/timepar.py``).

Each RK step of the semilinear solve is an elementwise affine map
``x_{n+1} = A_n x_n + B_n`` (``ode/semilinear.py``). Here the steps are split
into equal chunks over the ranks of the time axis, the blocked prefix scan
of the JAX package in three phases:

1. each rank evaluates the dynamics heads and ``rk_affine_coeffs`` on its own
   chunk of steps (the last chunk padded with identity maps ``A = 1, B = 0``
   where the rank count does not divide the steps), and forms its local
   inclusive prefixes: ``pA``, the running product of ``A``, and ``pB``, the
   recurrence from ``x = 0``, which is kernel K1 (``ops/recurrence.py::
   affine_scan``; K1-bwd runs in its backward);
2. the chunk totals ``(pA[:, -1], pB[:, -1])``, one ``(batch, D)`` pair per
   rank, are all-gathered over the time group, and each rank composes the
   totals of the chunks before its own and applies them to ``x0``;
3. each rank's slice of the trajectory is ``pA * carry + pB``, and the
   slices are all-gathered into the whole trajectory.

Communication: ``2 * n * batch * D`` floats for the totals, independent of
T, and the trajectory itself.

Gradients. In the JAX package the all-gather transposes to a
``psum_scatter`` and GSPMD partitions the rest of the model. Here every time
rank computes the whole (replicated) loss of its batch, so:

- (a) the trajectory's all-gather has a backward that returns this rank's
  slice of the cotangent, with no sum (every rank holds the same cotangent);
- (b) the solve's shared inputs (the dynamics parameters, ``z`` and ``x0``)
  enter through an identity whose backward sums their gradients over the
  time group: each rank's local solve sees only its chunk;
- the totals' all-gather sums its cotangent over the group and returns this
  rank's slice (every later rank's carry depends on them).

Without (b) a rank's dynamics gradient would cover one chunk; summing every
gradient instead would count the encoder and decoder terms once per rank.
Only ``all_reduce`` and ``all_gather`` are used, which gloo and NCCL both
take for CUDA tensors. Rank 0, whose carry is x0, keeps the totals in its
graph at weight 0, so every rank runs the same collectives in its backward.

The batch is not an argument of the layout: each rank's ``z`` and ``x0`` are
its own slice already (``parallel/mesh.py``), so the JAX package's
``batch_axis`` has no counterpart.

The ``semilinear_timepar`` backend of ``nn/ode_model.py::solve_ode`` reads
the grid from the ambient context (:func:`time_sharding`,
:func:`set_time_sharding`), as the JAX package's model code does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from structured_latent_odes_tpu_torch.ode.semilinear import rk_affine_coeffs, stage_time_grid
from structured_latent_odes_tpu_torch.ode.tableaus import get_tableau
from structured_latent_odes_tpu_torch.ops.recurrence import affine_scan
from structured_latent_odes_tpu_torch.parallel.mesh import Grid, all_reduce_tree
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


def _all_gather(x: Tensor, group, n: int):
    """``x`` of each rank of ``group``; every buffer contiguous (NCCL takes
    no other), on ``x``'s card."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


class _GatherSlices(torch.autograd.Function):
    """Each rank's ``(B, chunk, D)`` slice gathered along axis 1; the
    backward returns this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(local, group, n: int, i: int):
        return torch.cat(_all_gather(local, group, n), dim=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.chunk, ctx.i = inputs[0].shape[1], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.i * ctx.chunk:(ctx.i + 1) * ctx.chunk], None, None, None


class _GatherSummed(torch.autograd.Function):
    """Each rank's tensor stacked on a new axis 0 over the group; the
    backward sums the cotangent over the group and returns this rank's
    row."""

    @staticmethod
    def forward(x, group, n: int, i: int):
        return torch.stack(_all_gather(x, group, n))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.i = inputs[1], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_tree(g.contiguous(), ctx.group)[ctx.i], None, None, None


class _SharedInputs(torch.autograd.Function):
    """The identity on a solve's shared inputs; the backward sums their
    gradients over the group, in one collective."""

    @staticmethod
    def forward(group, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_tree(list(grads), ctx.group))


def _shared(group, *trees):
    """Each tree's tensors through :class:`_SharedInputs`, trees rebuilt."""
    leaves = [tree_leaves(t) for t in trees]
    out = iter(_SharedInputs.apply(group, *(x for ls in leaves for x in ls)))
    return [tree_unflatten(t, [next(out) for _ in ls]) if isinstance(t, (dict, list, tuple)) else next(out)
            for t, ls in zip(trees, leaves)]


def _blocked_scan_local(A: Tensor, B: Tensor, x0: Tensor, group, n: int, i: int) -> Tensor:
    """Phases 1 (the prefixes) to 3 for this rank's chunk ``A, B (batch,
    chunk, D)`` and the shared ``x0 (batch, D)``: the whole trajectory
    after x0, ``(batch, n * chunk, D)``."""
    pA = torch.cumprod(A, dim=1)
    pB = affine_scan(A, B, torch.zeros_like(x0))[:, 1:]
    totals = _GatherSummed.apply(torch.stack([pA[:, -1], pB[:, -1]]), group, n, i)  # (n, 2, batch, D)
    carry = x0
    for j in range(i):
        carry = totals[j, 0] * carry + totals[j, 1]
    if i == 0:  # no chunk before it: the totals enter at weight 0, so rank 0 runs their backward too
        carry = carry + 0.0 * totals[0, 0]
    return _GatherSlices.apply(pA * carry[:, None] + pB, group, n, i)


def _identity_pad(A: Tensor, B: Tensor, pad: int) -> Tuple[Tensor, Tensor]:
    """Right-pad the step axis (1) with identity affine maps."""
    if not pad:
        return A, B
    shape = (A.shape[0], pad, A.shape[2])
    return torch.cat([A, A.new_ones(shape)], dim=1), torch.cat([B, B.new_zeros(shape)], dim=1)


def solve_affine_recurrence_timepar(A: Tensor, B: Tensor, x0: Tensor, *, mesh: Grid,
                                    time_axis: str = "model") -> Tensor:
    """Time-sharded solve of ``x_{n+1} = A_n x_n + B_n`` over the ranks of
    ``mesh``'s ``time_axis``. A, B ``(batch, T-1, D)`` and x0 ``(batch, D)``
    the same on every rank of the axis. Returns ``(batch, T, D)`` including
    x0, equal to the single-device recurrence to float32 roundoff; the
    gradients of A, B and x0 are whole on every rank."""
    group, n, i = mesh.group(time_axis), mesh.size(time_axis), mesh.index(time_axis)
    t = A.shape[1]
    A_s, B_s, x0_s = _shared(group, A, B, x0)
    A_s, B_s = _identity_pad(A_s, B_s, (-t) % n)
    chunk = A_s.shape[1] // n
    lo = i * chunk
    xs = _blocked_scan_local(A_s[:, lo:lo + chunk].contiguous(), B_s[:, lo:lo + chunk].contiguous(), x0_s,
                             group, n, i)
    return torch.cat([x0[:, None], xs[:, :t]], dim=1)


def solve_semilinear_timepar(prod_degr_fn: Callable, params, z: Tensor, x0: Tensor, ts, *,
                             method: str = "midpoint", mesh: Grid, time_axis: str = "model") -> Tensor:
    """The fully sequence-parallel semilinear solve: the dynamics heads, the
    RK coefficients and the prefix scan all run on this rank's chunk of
    steps; only the chunk totals and the trajectory's slices cross ranks.

    ``prod_degr_fn(params, stage_ts, z) -> (a, d)``, each ``(batch, n_steps,
    S, D)`` for stage times ``(n_steps, S)``
    (``nn/ode_model.py::dynamics_prod_degr``). Returns ``(batch, T, D)``
    including x0."""
    group, n, i = mesh.group(time_axis), mesh.size(time_axis), mesh.index(time_axis)
    tableau = get_tableau(method)
    ts = torch.as_tensor(ts, dtype=x0.dtype, device=x0.device)
    t_steps = ts.shape[0] - 1
    pad = (-t_steps) % n
    stage_ts = stage_time_grid(ts, tableau)  # (T-1, S)
    h = ts[1:] - ts[:-1]
    if pad:
        stage_ts = torch.cat([stage_ts, stage_ts[-1:].expand(pad, -1)], dim=0)
        h = torch.cat([h, h.new_ones(pad)], dim=0)
    chunk = (t_steps + pad) // n
    lo = i * chunk
    params_s, z_s, x0_s = _shared(group, params, z, x0)
    a, d = prod_degr_fn(params_s, stage_ts[lo:lo + chunk], z_s)  # (batch, chunk, S, D)
    A, B = rk_affine_coeffs(a, d, h[lo:lo + chunk], tableau)
    if t_steps - lo < chunk:  # this chunk holds padding steps: identity maps there
        valid = (torch.arange(chunk, device=x0.device) < t_steps - lo)[None, :, None]
        A = torch.where(valid, A, torch.ones_like(A))
        B = torch.where(valid, B, torch.zeros_like(B))
    xs = _blocked_scan_local(A.contiguous(), B.contiguous(), x0_s, group, n, i)
    return torch.cat([x0[:, None], xs[:, :t_steps]], dim=1)


class TimeShardingContext(NamedTuple):
    mesh: Grid
    time_axis: str


# A plain module global, as in the JAX package: a training run installs it
# for its whole length (train/backend.py), and the model's solve reads it.
_ctx: Optional[TimeShardingContext] = None


def set_time_sharding(mesh: Grid, time_axis: str = "model") -> Optional[TimeShardingContext]:
    """Install the ambient grid for the rest of the process (the unscoped
    form a training run uses). Returns the previous context."""
    global _ctx
    prev = _ctx
    _ctx = TimeShardingContext(mesh, time_axis)
    return prev


def clear_time_sharding() -> Optional[TimeShardingContext]:
    """Remove the ambient grid. Returns the previous context."""
    global _ctx
    prev = _ctx
    _ctx = None
    return prev


def current_time_sharding() -> Optional[TimeShardingContext]:
    """The ambient context, or None."""
    return _ctx


@contextlib.contextmanager
def time_sharding(mesh: Grid, time_axis: str = "model"):
    """The ambient grid for the ``semilinear_timepar`` backend within a
    block: model code has no argument slot for a grid, so the backend reads
    it from here."""
    global _ctx
    prev = set_time_sharding(mesh, time_axis)
    try:
        yield
    finally:
        _ctx = prev


def get_time_sharding() -> TimeShardingContext:
    ctx = _ctx
    if ctx is None:
        raise RuntimeError(
            "backend='semilinear_timepar' requires an ambient grid: wrap the call in "
            "parallel.timepar.time_sharding(grid, ...) (--time-parallel installs one)"
        )
    return ctx

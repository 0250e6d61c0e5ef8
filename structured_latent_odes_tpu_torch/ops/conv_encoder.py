"""The conv encoder's front end as one differentiable op: ``conv1d`` (VALID)
``-> + bias -> avg_pool1d`` (stride 1) ``->`` filter-major flatten, forward
and weight gradient in two hand-written kernels (``csrc/conv_encoder.cu``).

It replaces no TPU kernel: the JAX package leaves the conv and the pool to
XLA (``structured_latent_odes_tpu/nn/layers.py::conv_encoder_apply``,
``lax.conv_general_dilated`` and the pool). On the card the port ran them on
cuDNN, and under ``torch.func.vmap`` over an ensemble's members (each with
its own batch) cuDNN ran a grouped convolution whose deterministic weight
gradient took milliseconds a dual step. The kernels take the members on
``blockIdx.y``: :func:`conv_pool_fwd_members` and
:func:`conv_pool_wgrad_members` launch once for S members, each argument
with a leading member axis (an argument all members share, such as the val
ELBO's observations, is an expand: member stride 0, no copy a member); the
single-model wrappers launch the same kernels with S = 1, and a member's
outputs are bit-equal to a single-member launch on its slices. The weight
gradient sums in a fixed order (per-block partial sums, then a second
kernel that adds them in block order; no atomics), so launches are
bit-identical.

:func:`conv_pool` is the model's entry. A tensor on the CPU takes the plain
version (:func:`conv_pool_fwd_plain`, ``F.conv1d`` and ``F.avg_pool1d``, with
autograd's gradients); a CUDA tensor goes through a ``torch.autograd.Function``
that runs the forward kernel and, backward, the weight-gradient kernel.
Under ``torch.func.vmap`` both reach the member-batched launch. The
observations never need a gradient in the model; where one is asked for,
the op computes it by its plain version (:func:`conv_pool_dx_plain`). Each
``_plain`` function is its kernel's plain PyTorch version, used for a
tensor on the CPU and held against the kernels on the card. For a CUDA
tensor the wrappers launch the kernel or raise. The kernels adapt to the
shapes they are given (trajectories, channels, steps, filters, filter and
pool widths, members); a shape whose block would need more than
:data:`SMEM_LIMIT` bytes of shared memory raises a ``ValueError`` that names
the limit before any build.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.ops import _build
from structured_latent_odes_tpu_torch.ops.recurrence import _to_front

Tensor = torch.Tensor

# a block's shared memory: the trajectory's rows, the weights, the conv
# outputs (and, backward, the output gradient and the block's sums), at most
# 227 KB (232,448 bytes) on an H100
SMEM_LIMIT = 232448
# trajectories of one member a weight-gradient block sums: the grid, and so
# the order of the sums, depends on the batch alone
WGRAD_TRAJ_PER_BLOCK = 4

# (x, x_ms, w, w_ms, b, b_ms, out, S, B, K, T, F, W, P, stream)
_FWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])
# (x, x_ms, g, g_ms, partial, grads, S, B, K, T, F, W, P, per_block, stream)
_WGRAD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])


def conv_pool_fwd_plain(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """Plain version of the forward kernel: x ``(B, K, T)``, w ``(F, K, W)``,
    b ``(F,)`` -> ``(B, F * n_pool)``, filter-major."""
    y = F.avg_pool1d(F.conv1d(x, w, b), kernel_size=pool, stride=1)
    return y.reshape(y.shape[0], -1)


def _pool_bwd_plain(g: Tensor, n_conv: int, pool: int) -> Tensor:
    """The pool's backward: ``(B, F * n_pool)`` -> ``(B, F, n_conv)``, conv
    output t taking ``g[p] / pool`` of each window p over it, p ascending (as
    the kernel sums them)."""
    n_pool = n_conv - pool + 1
    gp = g.reshape(g.shape[0], -1, n_pool) / pool
    gc = None
    for i in reversed(range(pool)):  # window p = t - i
        term = F.pad(gp, (i, pool - 1 - i))
        gc = term if gc is None else gc + term
    return gc


def conv_pool_wgrad_plain(x: Tensor, g: Tensor, filter_size: int, pool: int):
    """Plain version of the weight-gradient kernel: x ``(B, K, T)`` and the
    flat output's gradient g ``(B, F * n_pool)`` -> (dw ``(F, K, W)``, db
    ``(F,)``)."""
    gc = _pool_bwd_plain(g, x.shape[-1] - filter_size + 1, pool)
    dw = torch.einsum("bft,bktj->fkj", gc, x.unfold(2, filter_size, 1))
    return dw, gc.sum((0, 2))


def conv_pool_dx_plain(g: Tensor, w: Tensor, n_time: int, pool: int) -> Tensor:
    """The observations' gradient ``(B, K, T)`` from g ``(B, F * n_pool)``
    and w ``(F, K, W)``: the transposed conv of the pool's backward, in plain
    PyTorch (the model never asks for it)."""
    W = w.shape[-1]
    gc = _pool_bwd_plain(g, n_time - W + 1, pool)
    dx = None
    for j in range(W):
        term = F.pad(torch.einsum("bft,fk->bkt", gc, w[:, :, j]), (j, W - 1 - j))
        dx = term if dx is None else dx + term
    return dx


def conv_pool_fwd_members_plain(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """Plain version of the member-batched forward: :func:`conv_pool_fwd_plain`
    for each member, every argument with a leading member axis."""
    return torch.stack([conv_pool_fwd_plain(x[s], w[s], b[s], pool) for s in range(x.shape[0])])


def conv_pool_wgrad_members_plain(x: Tensor, g: Tensor, filter_size: int, pool: int):
    """Plain version of the member-batched weight gradient:
    :func:`conv_pool_wgrad_plain` for each member."""
    per = [conv_pool_wgrad_plain(x[s], g[s], filter_size, pool) for s in range(x.shape[0])]
    return tuple(torch.stack(outs) for outs in zip(*per))


def smem_bytes(K: int, T: int, Fn: int, W: int, pool: int, backward: bool) -> int:
    """A forward (weight-gradient if ``backward``) block's shared memory in
    bytes: ``fwd_smem_floats`` and ``wgrad_smem_floats`` of
    csrc/conv_encoder.cu, which refuse a launch past the limit too."""
    n_conv = T - W + 1
    n_pool = n_conv - pool + 1
    if backward:
        return 4 * (K * T + Fn * n_pool + Fn * n_conv + Fn * K * W + Fn)
    return 4 * (K * T + Fn * K * W + Fn + Fn * n_conv)


def check_fits(name: str, K: int, T: int, Fn: int, W: int, pool: int) -> None:
    """Refuse, before any build, a shape with no pooled output or whose
    blocks would pass a block's shared memory."""
    if T - W + 1 - pool + 1 < 1:
        raise ValueError(f"{name}: {T} steps leave no output of a filter of {W} and a pool of {pool}")
    for backward, kernel in ((False, "the forward"), (True, "the weight gradient")):
        need = smem_bytes(K, T, Fn, W, pool, backward)
        if need > SMEM_LIMIT:
            raise ValueError(
                f"{name}: (K, T, F, W, pool) = ({K}, {T}, {Fn}, {W}, {pool}): a block of {kernel} needs {need} "
                f"bytes of shared memory, past the card's limit of {SMEM_LIMIT} bytes (227 KB)")


def _member_major(t: Tensor):
    """``t`` with a leading member axis as the kernels take it: (tensor,
    member stride in floats), each member's slice contiguous. An expand (a
    value all members share) keeps stride 0 and is not copied."""
    if t[0].is_contiguous():
        return t, t.stride(0)
    t = t.contiguous()
    return t, t[0].numel()


def _count(wrapper, shape) -> None:
    """One launch of ``wrapper``'s kernel, and its (K, T, F, W, pool) shape."""
    wrapper.launches += 1
    wrapper.variants[shape] += 1


def _fwd_launch(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """The forward kernel over the S members of arrays with a leading member
    axis (a single model is a member of one)."""
    _build.check_cuda("conv_pool_fwd", x, w, b)
    S, B, K, T = x.shape
    Fn, _, W = w.shape[1:]
    check_fits("conv_pool_fwd", K, T, Fn, W, pool)
    out = torch.empty((S, B, Fn * (T - W + 2 - pool)), dtype=torch.float32, device=x.device)
    (x, x_ms), (w, w_ms), (b, b_ms) = (_member_major(t) for t in (x, w, b))
    fn = _build.function("conv_encoder", "conv_pool_fwd", _FWD_ARGTYPES)
    _build.launch("conv_pool_fwd", fn, x, x_ms, w, w_ms, b, b_ms, out, S, B, K, T, Fn, W, pool)
    return out


def _wgrad_launch(x: Tensor, g: Tensor, filter_size: int, pool: int):
    """The weight-gradient kernels over the S members of arrays with a
    leading member axis: dw ``(S, F, K, W)`` and db ``(S, F)``."""
    _build.check_cuda("conv_pool_wgrad", x, g)
    S, B, K, T = x.shape
    Fn = g.shape[-1] // (T - filter_size + 2 - pool)
    check_fits("conv_pool_wgrad", K, T, Fn, filter_size, pool)
    n_blocks = -(-B // WGRAD_TRAJ_PER_BLOCK)
    P = Fn * K * filter_size + Fn
    partial = torch.empty((S, n_blocks, P), dtype=torch.float32, device=x.device)
    grads = (torch.empty if B else torch.zeros)((S, P), dtype=torch.float32, device=x.device)
    (x, x_ms), (g, g_ms) = _member_major(x), _member_major(g)
    fn = _build.function("conv_encoder", "conv_pool_wgrad", _WGRAD_ARGTYPES)
    _build.launch("conv_pool_wgrad", fn, x, x_ms, g, g_ms, partial, grads, S, B, K, T, Fn, filter_size, pool,
                  WGRAD_TRAJ_PER_BLOCK)
    dw, db = torch.split(grads, [P - Fn, Fn], dim=-1)
    return dw.view(S, Fn, K, filter_size), db


def _check_shapes(name: str, x: Tensor, w: Tensor, b: Tensor, members: bool) -> None:
    lead = tuple(x.shape[:1]) if members else ()
    n = len(lead)
    if (x.ndim != n + 3 or w.ndim != n + 3 or tuple(w.shape[:n]) != lead or x.shape[-2] != w.shape[-2]
            or tuple(b.shape) != lead + (w.shape[-3],)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}; expected "
                         f"x {'(S, ' if members else '('}B, K, T), w (..., F, K, W), b (..., F)")


def _check_grad_shapes(name: str, x: Tensor, g: Tensor, filter_size: int, pool: int, members: bool) -> None:
    n_pool = x.shape[-1] - filter_size + 2 - pool
    ndim = 4 if members else 3
    if (x.ndim != ndim or g.ndim != ndim - 1 or g.shape[:-1] != x.shape[:-2] or n_pool < 1
            or g.shape[-1] % n_pool):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, g {tuple(g.shape)} at filter {filter_size}, "
                         f"pool {pool}; expected g (..., B, F * {n_pool})")


def conv_pool_fwd(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """The forward kernel's wrapper: the arguments and result of
    :func:`conv_pool_fwd_plain`. On the card it launches the member-batched
    kernel for one member."""
    _check_shapes("conv_pool_fwd", x, w, b, members=False)
    if x.device.type == "cpu":
        return conv_pool_fwd_plain(x, w, b, pool)
    out = _fwd_launch(x[None], w[None], b[None], pool)[0]
    _count(conv_pool_fwd, (x.shape[1], x.shape[2], w.shape[0], w.shape[2], pool))
    return out


conv_pool_fwd.launches = 0
conv_pool_fwd.variants = collections.Counter()


def conv_pool_fwd_members(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """The member-batched forward's wrapper: the arguments and result of
    :func:`conv_pool_fwd_members_plain`, S members in one launch."""
    _check_shapes("conv_pool_fwd_members", x, w, b, members=True)
    if x.device.type == "cpu":
        return conv_pool_fwd_members_plain(x, w, b, pool)
    out = _fwd_launch(x, w, b, pool)
    _count(conv_pool_fwd_members, (x.shape[2], x.shape[3], w.shape[1], w.shape[3], pool))
    return out


conv_pool_fwd_members.launches = 0
conv_pool_fwd_members.variants = collections.Counter()


def conv_pool_wgrad(x: Tensor, g: Tensor, filter_size: int, pool: int):
    """The weight-gradient kernel's wrapper: the arguments and results of
    :func:`conv_pool_wgrad_plain`. On the card it launches the
    member-batched kernels for one member."""
    _check_grad_shapes("conv_pool_wgrad", x, g, filter_size, pool, members=False)
    if x.device.type == "cpu":
        return conv_pool_wgrad_plain(x, g, filter_size, pool)
    outs = tuple(t[0] for t in _wgrad_launch(x[None], g[None], filter_size, pool))
    _count(conv_pool_wgrad, (x.shape[1], x.shape[2], outs[1].shape[-1], filter_size, pool))
    return outs


conv_pool_wgrad.launches = 0
conv_pool_wgrad.variants = collections.Counter()


def conv_pool_wgrad_members(x: Tensor, g: Tensor, filter_size: int, pool: int):
    """The member-batched weight gradient's wrapper: the arguments and
    results of :func:`conv_pool_wgrad_members_plain`, S members in one
    launch."""
    _check_grad_shapes("conv_pool_wgrad_members", x, g, filter_size, pool, members=True)
    if x.device.type == "cpu":
        return conv_pool_wgrad_members_plain(x, g, filter_size, pool)
    outs = _wgrad_launch(x, g, filter_size, pool)
    _count(conv_pool_wgrad_members, (x.shape[2], x.shape[3], outs[1].shape[-1], filter_size, pool))
    return outs


conv_pool_wgrad_members.launches = 0
conv_pool_wgrad_members.variants = collections.Counter()


class _ConvPoolWgrad(torch.autograd.Function):
    """The weight-gradient kernel as a function that ``torch.func.vmap`` can
    batch (the backward of :class:`_ConvPool` runs under the ensemble's
    vmap)."""

    @staticmethod
    def forward(x, g, filter_size, pool):
        return conv_pool_wgrad(x, g, filter_size, pool)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the conv encoder's weight gradient has no derivative")

    @staticmethod
    def vmap(info, in_dims, x, g, filter_size, pool):
        x, g = (_to_front(t, d, info.batch_size) for t, d in zip((x, g), in_dims[:2]))
        return conv_pool_wgrad_members(x, g, filter_size, pool), (0, 0)


class _ConvPool(torch.autograd.Function):
    """The forward kernel forward, the weight-gradient kernel backward (the
    observations' gradient, where asked for, by its plain version). Under
    ``torch.func.vmap`` (the ensemble's member axis) both run member-batched:
    one launch for all members."""

    @staticmethod
    def forward(x, w, b, pool):
        return conv_pool_fwd(x, w, b, pool)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, pool = inputs
        ctx.save_for_backward(x, w)
        ctx.pool = pool

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dw, db = _ConvPoolWgrad.apply(x, g, w.shape[-1], ctx.pool)
        dx = conv_pool_dx_plain(g, w, x.shape[-1], ctx.pool) if ctx.needs_input_grad[0] else None
        return dx, dw, db, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, pool):
        x, w, b = (_to_front(t, d, info.batch_size) for t, d in zip((x, w, b), in_dims[:3]))
        return conv_pool_fwd_members(x, w, b, pool), 0


def conv_pool(x: Tensor, w: Tensor, b: Tensor, pool: int) -> Tensor:
    """The encoder's front end, differentiable in x, w and b: x ``(B, K, T)``,
    w ``(F, K, W)``, b ``(F,)`` -> ``(B, F * n_pool)``. On the CPU the plain
    version; on the card the kernels."""
    if x.device.type == "cpu":
        return conv_pool_fwd_plain(x, w, b, pool)
    return _ConvPool.apply(x, w, b, pool)

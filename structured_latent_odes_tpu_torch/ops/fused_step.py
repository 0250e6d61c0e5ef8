"""Kernels K2 and K3: the whole semilinear RK solve of the decoder ODE in one
launch, and its reverse sweep.

K2 replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/fused_step.py
::_fwd_kernel`` (launched by ``_fwd_call``; entry point
``fused_semilinear_solve``); K3 replaces ``_bwd_kernel`` (launched by
``_bwd_call``, with ``_rk_runs_bwd`` and the partial sums of ``_fused_bwd``).
Under the JAX package's vmap over an ensemble's members both Pallas kernels
gain a grid dimension over the members; here the same kernels take the
members on ``blockIdx.y`` (the ``_members`` wrappers). The CUDA sources are ``csrc/fused_semilinear_fwd.cu`` and
``csrc/fused_semilinear_bwd.cu``. The dynamics heads never read the state, so
each step's affine map ``x_{t+1} = A_t x_t + B_t`` is independent of the
others: a block owns one trajectory at a time, one thread per step evaluates
the step's stages and ``(A_t, B_t)`` in parallel, and then ``D`` threads run
the short serial recurrence (K3: the adjoint, then the VJP of every step in
parallel and a fixed-order reduction of the weight gradients). Neither writes
the ``(B, T-1, S, H)`` stage activations that the unfused path materializes:
K2 reads ``u`` once and writes the trajectory once; K3 recomputes the stages
from ``u`` and the saved trajectory. Both are bound by operations:
``B * (T-1) * S * (4*D*H + 2*H)`` flops forward, about three times that
backward. Trajectories are trajectory-major ``(B, T, D)`` throughout.

The latent projection ``u = z @ W[:, 1:].T + b`` and ``x0`` stay in PyTorch,
as in the JAX package, and take their gradients from autograd.

:func:`fused_semilinear_solve` is differentiable: a ``torch.autograd.Function``
runs K2 forward (saving u, the weights and K2's output) and K3 backward. The
kernels take the weights and the time grid as they are and compute the stage
times from the grid, rounded as the plain versions round them: a wrapper
call makes no tables on the card, only its outputs (and K3's per-block
partial sums, which a second kernel of the same launch adds up in a fixed
order). :func:`fused_semilinear_fwd` and :func:`fused_semilinear_bwd` are the
kernels' wrappers for one model, :func:`fused_semilinear_fwd_members` and
:func:`fused_semilinear_bwd_members` for S members in one launch (every
argument but the time grid with a leading member axis; the single-member
wrappers launch the same kernels with S = 1, and a member's outputs are
bit-equal to a single-member launch on its slices); the ``_plain`` functions
are their plain PyTorch versions, used for a tensor on the CPU and held
against the kernels on the card. For a CUDA tensor the wrappers launch the
kernel or raise. Under ``torch.func.vmap`` :func:`fused_semilinear_solve`
reaches the member-batched wrappers.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.ode.semilinear import rk_affine_coeffs, stage_time_grid
from structured_latent_odes_tpu_torch.ode.tableaus import ButcherTableau, get_tableau
from structured_latent_odes_tpu_torch.ops import _build
from structured_latent_odes_tpu_torch.ops.recurrence import _to_front

Tensor = torch.Tensor

# the kernels' Method enum, in order
METHODS = ("euler", "midpoint", "heun", "rk4")

# (method, u, x0, ts, wt, wt_stride, wt_mstride, wa, ba, wd, bd, out, S, B, T, stream)
_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# (method, u, xs, g, ts, wt, wt_stride, wt_mstride, wa, ba, wd, bd, du, dx0, partial, grads, S, B, T,
#  n_blocks, stream)
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _stages(u, wt, wa, ba, wd, bd, taus):
    """The dynamics net at each stage time: lists of pre-activations, hidden
    activations, productions and degradations, each ``(B, ·)``."""
    pres = [u + tau * wt for tau in taus]
    hid = [torch.relu(p) for p in pres]
    return pres, hid, [torch.sigmoid(h @ wa.T + ba) for h in hid], [torch.sigmoid(h @ wd.T + bd) for h in hid]


def fused_semilinear_fwd_plain(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """Plain version of K2, one step at a time as the kernel walks time.

    u ``(B, H)``, wt ``(H,)``, wa/wd ``(D, H)``, ba/bd ``(D,)``, x0 ``(B, D)``,
    ts ``(T,)``. Returns the trajectory ``(B, T, D)``, x0 in row 0.
    """
    tableau = get_tableau(method)
    sts, hs = stage_time_grid(ts, tableau), ts[1:] - ts[:-1]
    x = x0
    xs = [x0]
    for t in range(sts.shape[0]):
        _, _, a_st, d_st = _stages(u, wt, wa, ba, wd, bd, sts[t])
        A, Bc = rk_affine_coeffs(torch.stack(a_st, -2), torch.stack(d_st, -2), hs[t], tableau)
        x = A * x + Bc
        xs.append(x)
    return torch.stack(xs, 1)


def _rk_run(x0c: float, a_st, d_st, hstep, tableau: ButcherTableau):
    """One RK run of the step from the constant ``x0c``: (result, stage
    states)."""
    ks, ys = [], []
    for i, row in enumerate(tableau.a):
        y = torch.full_like(a_st[0], x0c)
        for aij, kj in zip(row, ks):
            if aij != 0.0:
                y = y + (hstep * aij) * kj
        ys.append(y)
        ks.append(a_st[i] - d_st[i] * y)
    out = torch.full_like(a_st[0], x0c)
    for bi, ki in zip(tableau.b, ks):
        if bi != 0.0:
            out = out + (hstep * bi) * ki
    return out, ys


def _rk_runs_bwd(d_st, ys_pair, hstep, tableau: ButcherTableau, dA, dB):
    """VJP of the two RK runs (B = run(0), A = run(1) - B) onto the stages'
    (a, d): d run(1) = dA, d run(0) = dB - dA, reverse-accumulated over the
    stages of each run (the JAX package's ``_rk_runs_bwd``)."""
    S = len(tableau.b)
    da = [torch.zeros_like(dA) for _ in range(S)]
    dd = [torch.zeros_like(dA) for _ in range(S)]
    for dout, ys in ((dA, ys_pair[1]), (dB - dA, ys_pair[0])):
        dks = [dout * (hstep * bi) if bi != 0.0 else torch.zeros_like(dout) for bi in tableau.b]
        for i in reversed(range(S)):
            dk = dks[i]
            da[i] = da[i] + dk
            dd[i] = dd[i] - ys[i] * dk
            dy = -d_st[i] * dk
            for j, aij in enumerate(tableau.a[i]):
                if aij != 0.0:
                    dks[j] = dks[j] + (hstep * aij) * dy
    return da, dd


def fused_semilinear_bwd_plain(u, wt, wa, ba, wd, bd, xs, g, ts, method: str):
    """Plain version of K3: the reverse sweep, one step at a time as the
    kernel walks time, written out (not derived by autograd).

    The arguments of :func:`fused_semilinear_fwd_plain` without x0, plus the
    forward trajectory xs and its cotangent g, both ``(B, T, D)``.
    Returns (du ``(B, H)``, dwt ``(H,)``, dwa ``(D, H)``, dba ``(D,)``, dwd
    ``(D, H)``, dbd ``(D,)``, dx0 ``(B, D)``).
    """
    tableau = get_tableau(method)
    sts, hs = stage_time_grid(ts, tableau), ts[1:] - ts[:-1]
    xs_b, g_b = xs.transpose(0, 1), g.transpose(0, 1)  # (T, B, D)
    lam = g_b[-1]
    du = torch.zeros_like(u)
    dwt, dwa, dba = torch.zeros_like(wt), torch.zeros_like(wa), torch.zeros_like(ba)
    dwd, dbd = torch.zeros_like(wd), torch.zeros_like(bd)
    for t in range(sts.shape[0] - 1, -1, -1):
        hstep = hs[t]
        pres, hid, a_st, d_st = _stages(u, wt, wa, ba, wd, bd, sts[t])
        B0, ys0 = _rk_run(0.0, a_st, d_st, hstep, tableau)
        B1, ys1 = _rk_run(1.0, a_st, d_st, hstep, tableau)
        dA = lam * xs_b[t]
        da, dd = _rk_runs_bwd(d_st, (ys0, ys1), hstep, tableau, dA, lam)
        for i in range(len(tableau.c)):
            sa = a_st[i] * (1.0 - a_st[i]) * da[i]  # sigmoid'
            sd = d_st[i] * (1.0 - d_st[i]) * dd[i]
            dwa = dwa + sa.T @ hid[i]
            dwd = dwd + sd.T @ hid[i]
            dba = dba + sa.sum(0)
            dbd = dbd + sd.sum(0)
            dpre = torch.where(pres[i] > 0.0, sa @ wa + sd @ wd, 0.0)
            du = du + dpre
            dwt = dwt + sts[t, i] * dpre.sum(0)
        lam = (B1 - B0) * lam + g_b[t]
    return du, dwt, dwa, dba, dwd, dbd, lam


def fused_semilinear_fwd_members_plain(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """Plain version of the member-batched K2: :func:`fused_semilinear_fwd_plain`
    for each member. Every argument but ts has a leading member axis ``(S,
    ...)``; returns ``(S, B, T, D)``."""
    return torch.stack([
        fused_semilinear_fwd_plain(u[s], wt[s], wa[s], ba[s], wd[s], bd[s], x0[s], ts, method)
        for s in range(u.shape[0])
    ])


def fused_semilinear_bwd_members_plain(u, wt, wa, ba, wd, bd, xs, g, ts, method: str):
    """Plain version of the member-batched K3: :func:`fused_semilinear_bwd_plain`
    for each member, each of the seven results with a leading member axis."""
    per = [fused_semilinear_bwd_plain(u[s], wt[s], wa[s], ba[s], wd[s], bd[s], xs[s], g[s], ts, method)
           for s in range(u.shape[0])]
    return tuple(torch.stack(outs) for outs in zip(*per))


def _check_shapes(args, expected):
    if tuple(tuple(a.shape) for a in args) != expected:
        raise ValueError(f"shapes {[tuple(a.shape) for a in args]}, expected {list(expected)}")


def _method_index(name: str, method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"{name} supports {METHODS}, not {method!r}")
    return METHODS.index(method)


def _kernel_args(name: str, args, S: int):
    """The kernels' library defines and weight arguments: w_t (a column of
    the hidden layer's weight, passed with its stride and, for S members
    ``(S, H)``, its member stride), W_a, b_a, W_d, b_d. The kernels take the
    time grid itself and compute the stage times from it."""
    _build.check_cuda(name, *args)
    u, wt, wa, ba, wd, bd = args[:6]
    defines = (("SLODE_H", u.shape[-1]), ("SLODE_D", wa.shape[-2]))
    strides = (wt.stride(1), wt.stride(0)) if S else (wt.stride(0), 0)
    return defines, (wt, *strides, wa.contiguous(), ba.contiguous(), wd.contiguous(), bd.contiguous())


def _members_shapes(name: str, u, ts, wa, backward: bool):
    """The member-batched wrappers' expected shapes, from u ``(S, B, H)``,
    W_a ``(S, D, H)`` and ts ``(T,)``."""
    if u.ndim != 3 or wa.ndim != 3:
        raise ValueError(f"{name}: shapes: u {tuple(u.shape)}, W_a {tuple(wa.shape)} lack the member axis")
    S, B, H = u.shape
    D = wa.shape[1]
    T = ts.shape[0]
    state = ((S, B, T, D), (S, B, T, D)) if backward else ((S, B, D),)
    return ((S, B, H), (S, H), (S, D, H), (S, D), (S, D, H), (S, D)) + state + ((T,),)


# S = 0 below: one model, the arrays without a member axis (a launch of one
# member); S > 0: S members, each array but ts with a leading member axis


def _fwd_launch(m: int, S: int, args) -> Tensor:
    """K2 over ``args``; returns the trajectories ``([S,] B, T, D)``."""
    u, wt, wa, ba, wd, bd, x0, ts = args
    B, T, D = u.shape[-2], ts.shape[0], wa.shape[-2]
    defines, weights = _kernel_args("fused_semilinear_fwd", args, S)
    out = torch.empty((S,) * bool(S) + (B, T, D), dtype=torch.float32, device=u.device)
    fn = _build.function("fused_semilinear_fwd", "fused_semilinear_fwd", _FWD_ARGTYPES, defines)
    _build.launch("fused_semilinear_fwd", fn, m, u.contiguous(), x0.contiguous(), ts.contiguous(),
                  *weights, out, max(S, 1), B, T)
    return out


def fused_semilinear_fwd(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """K2's wrapper: the arguments and result of
    :func:`fused_semilinear_fwd_plain`. On the card it launches the
    member-batched kernel for one member."""
    m = _method_index("fused_semilinear_fwd", method)
    args = (u, wt, wa, ba, wd, bd, x0, ts)
    B, H = u.shape
    D = x0.shape[1]
    T = ts.shape[0]
    _check_shapes(args, ((B, H), (H,), (D, H), (D,), (D, H), (D,), (B, D), (T,)))
    if u.device.type == "cpu":
        return fused_semilinear_fwd_plain(*args, method)
    out = _fwd_launch(m, 0, args)
    fused_semilinear_fwd.launches += 1
    return out


fused_semilinear_fwd.launches = 0


def fused_semilinear_fwd_members(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """The member-batched K2's wrapper: the arguments and result of
    :func:`fused_semilinear_fwd_members_plain`, S members in one launch."""
    m = _method_index("fused_semilinear_fwd_members", method)
    args = (u, wt, wa, ba, wd, bd, x0, ts)
    _check_shapes(args, _members_shapes("fused_semilinear_fwd_members", u, ts, wa, backward=False))
    if u.device.type == "cpu":
        return fused_semilinear_fwd_members_plain(*args, method)
    out = _fwd_launch(m, u.shape[0], args)
    fused_semilinear_fwd_members.launches += 1
    return out


fused_semilinear_fwd_members.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_blocks(defines, m: int, B: int, T: int, device_index: int) -> int:
    """K3's grid over one member's trajectories, and so the rows of a member's
    partial-sum buffer, for one shape on one card: asked of the library once
    per shape."""
    fn = _build.function("fused_semilinear_bwd", "fused_semilinear_bwd_blocks", [ctypes.c_int] * 3, defines)
    with torch.cuda.device(device_index):
        n = fn(m, B, T)
    if n <= 0:
        raise RuntimeError(f"fused_semilinear_bwd_blocks failed with CUDA error {-n}")
    return n


def _bwd_launch(m: int, S: int, args):
    """K3 over ``args``: the seven gradients, each with the member axis when
    S > 0."""
    u, wt, wa, ba, wd, bd, xs, g, ts = args
    B, H = u.shape[-2:]
    T, D = ts.shape[0], wa.shape[-2]
    lead = (S,) * bool(S)
    defines, weights = _kernel_args("fused_semilinear_bwd", args, S)
    n_blocks = _bwd_blocks(defines, m, B, T, u.device.index) if B else 0
    fn = _build.function("fused_semilinear_bwd", "fused_semilinear_bwd", _BWD_ARGTYPES, defines)
    P = H + 2 * D * H + 2 * D
    du = torch.empty(lead + (B, H), dtype=torch.float32, device=u.device)
    dx0 = torch.empty(lead + (B, D), dtype=torch.float32, device=u.device)
    partial = torch.empty(lead + (n_blocks, P), dtype=torch.float32, device=u.device)
    grads = (torch.empty if B else torch.zeros)(lead + (P,), dtype=torch.float32, device=u.device)
    _build.launch("fused_semilinear_bwd", fn, m, u.contiguous(), xs.contiguous(), g.contiguous(),
                  ts.contiguous(), *weights, du, dx0, partial, grads, max(S, 1), B, T, n_blocks)
    dwt, dwa, dba, dwd, dbd = torch.split(grads, [H, D * H, D, D * H, D], dim=-1)
    return du, dwt, dwa.view(lead + (D, H)), dba, dwd.view(lead + (D, H)), dbd, dx0


def fused_semilinear_bwd(u, wt, wa, ba, wd, bd, xs, g, ts, method: str):
    """K3's wrapper: the arguments and results of
    :func:`fused_semilinear_bwd_plain`. On the card it launches the
    member-batched kernel for one member."""
    m = _method_index("fused_semilinear_bwd", method)
    args = (u, wt, wa, ba, wd, bd, xs, g, ts)
    B, H = u.shape
    D = wa.shape[0]
    T = ts.shape[0]
    _check_shapes(args, ((B, H), (H,), (D, H), (D,), (D, H), (D,), (B, T, D), (B, T, D), (T,)))
    if u.device.type == "cpu":
        return fused_semilinear_bwd_plain(*args, method)
    outs = _bwd_launch(m, 0, args)
    fused_semilinear_bwd.launches += 1
    return outs


fused_semilinear_bwd.launches = 0


def fused_semilinear_bwd_members(u, wt, wa, ba, wd, bd, xs, g, ts, method: str):
    """The member-batched K3's wrapper: the arguments and results of
    :func:`fused_semilinear_bwd_members_plain`, S members in one launch."""
    m = _method_index("fused_semilinear_bwd_members", method)
    args = (u, wt, wa, ba, wd, bd, xs, g, ts)
    _check_shapes(args, _members_shapes("fused_semilinear_bwd_members", u, ts, wa, backward=True))
    if u.device.type == "cpu":
        return fused_semilinear_bwd_members_plain(*args, method)
    outs = _bwd_launch(m, u.shape[0], args)
    fused_semilinear_bwd_members.launches += 1
    return outs


fused_semilinear_bwd_members.launches = 0


def _vmap_members(info, in_dims, args):
    """The member-batched wrappers' arguments from a vmap rule's: every
    tensor but the (shared) time grid with its member axis first."""
    if in_dims[len(args) - 1] is not None:
        raise ValueError("the fused solve takes one time grid for all members")
    return tuple(_to_front(t, d, info.batch_size) for t, d in zip(args[:-1], in_dims)) + (args[-1],)


class _FusedSemilinearBwd(torch.autograd.Function):
    """K3 as a function that ``torch.func.vmap`` can batch (the backward of
    :class:`_FusedSemilinear` runs under the ensemble's vmap)."""

    @staticmethod
    def forward(u, wt, wa, ba, wd, bd, xs, g, ts, method):
        return fused_semilinear_bwd(u, wt, wa, ba, wd, bd, xs, g, ts, method)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("K3 has no derivative")

    @staticmethod
    def vmap(info, in_dims, u, wt, wa, ba, wd, bd, xs, g, ts, method):
        args = _vmap_members(info, in_dims[:9], (u, wt, wa, ba, wd, bd, xs, g, ts))
        return fused_semilinear_bwd_members(*args, method), (0,) * 7


class _FusedSemilinear(torch.autograd.Function):
    """K2 forward, K3 backward (the JAX package's ``_fused_fwd``/``_fused_bwd``).
    The time grid gets no gradient. Under ``torch.func.vmap`` (the ensemble's
    member axis) both run member-batched: one launch for all members."""

    @staticmethod
    def forward(u, wt, wa, ba, wd, bd, x0, ts, method):
        return fused_semilinear_fwd(u, wt, wa, ba, wd, bd, x0, ts, method)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, wt, wa, ba, wd, bd, _, ts, method = inputs
        ctx.save_for_backward(u, wt, wa, ba, wd, bd, output, ts)
        ctx.method = method

    @staticmethod
    def backward(ctx, g):
        u, wt, wa, ba, wd, bd, xs, ts = ctx.saved_tensors
        grads = _FusedSemilinearBwd.apply(u, wt, wa, ba, wd, bd, xs, g, ts, ctx.method)
        return (*grads, None, None)

    @staticmethod
    def vmap(info, in_dims, u, wt, wa, ba, wd, bd, x0, ts, method):
        args = _vmap_members(info, in_dims[:8], (u, wt, wa, ba, wd, bd, x0, ts))
        return fused_semilinear_fwd_members(*args, method), 0


def fused_semilinear_solve(params, z: Tensor, x0: Tensor, ts, method: str = "midpoint") -> Tensor:
    """Fused whole-solve entry: the OdeModel params (port layout,
    nn/ode_model.py), z ``(B, L)``, x0 ``(B, D)``, ts ``(T,)`` -> ``(B, T, D)``;
    differentiable in the params, z and x0."""
    W, b = params["dyn_hidden"]["W"], params["dyn_hidden"]["b"]  # (H, L+1): column 0 is time
    u = F.linear(z, W[:, 1:], b)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=z.device)
    return _FusedSemilinear.apply(
        u, W[:, 0], params["prod"]["W"], params["prod"]["b"],
        params["degr"]["W"], params["degr"]["b"], x0, ts, method,
    )

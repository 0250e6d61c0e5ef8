"""Kernels K1 and K1-bwd: the affine scan ``x_t = A_t * x_{t-1} + B_t`` and
its reverse (adjoint) sweep.

K1 replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/recurrence.py
::_scan_kernel`` (launched by ``_affine_scan_raw``; entry points
``affine_scan_pallas_tm`` and ``affine_scan_pallas``); K1-bwd replaces the
same kernel as the JAX package's custom VJP ``_bwd`` runs it on time-reversed
coefficients. Both are in ``csrc/affine_scan.cu``: one thread per lane, the
time loop inside the thread, time-major ``(T, M)`` so a warp's loads and
stores coalesce. Both are bound by bytes, each array read or written once.

:func:`affine_scan_tm` and :func:`affine_scan` are differentiable: a
``torch.autograd.Function`` runs K1 forward (saving A and the trajectory) and
K1-bwd backward. :func:`affine_scan_fwd` and :func:`affine_scan_bwd` are the
kernels' wrappers; :func:`affine_scan_plain` and :func:`affine_scan_bwd_plain`
their plain PyTorch versions, used for a tensor on the CPU and held against
the kernels on the card. For a CUDA tensor the wrappers launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from structured_latent_odes_tpu_torch.ops import _build

Tensor = torch.Tensor

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def affine_scan_plain(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Sequential scan over time axis 0: A, B ``(T, ...)``, x0 ``(...)`` ->
    ``(T+1, ...)`` including x0. The product and the sum round separately."""
    xs = [x0]
    x = x0
    for t in range(A.shape[0]):
        x = A[t] * x + B[t]
        xs.append(x)
    return torch.stack(xs, 0)


def affine_scan_bwd_plain(A: Tensor, xs: Tensor, g: Tensor):
    """The reverse sweep of :func:`affine_scan_plain`: A ``(T, ...)``, the
    trajectory xs and its cotangent g ``(T+1, ...)`` -> (dA, dB, dx0)."""
    lam = g[-1]
    dA, dB = [], []
    for t in range(A.shape[0] - 1, -1, -1):
        dA.append(lam * xs[t])
        dB.append(lam)
        lam = A[t] * lam + g[t]
    return torch.stack(dA[::-1], 0), torch.stack(dB[::-1], 0), lam


def affine_scan_fwd(A_tm: Tensor, B_tm: Tensor, x0: Tensor) -> Tensor:
    """K1's wrapper: A_tm, B_tm ``(T, M)``, x0 ``(M,)`` -> ``(T+1, M)``."""
    T, M = A_tm.shape
    if B_tm.shape != (T, M) or x0.shape != (M,):
        raise ValueError(f"shapes A {tuple(A_tm.shape)}, B {tuple(B_tm.shape)}, x0 {tuple(x0.shape)}")
    if A_tm.device.type == "cpu":
        return affine_scan_plain(A_tm, B_tm, x0)
    _build.check_cuda("affine_scan_fwd", A_tm, B_tm, x0)
    out = torch.empty((T + 1, M), dtype=torch.float32, device=A_tm.device)
    fn = _build.function("affine_scan", "affine_scan_fwd", _FWD_ARGTYPES)
    _build.launch("affine_scan_fwd", fn, A_tm.contiguous(), B_tm.contiguous(), x0.contiguous(), out, T, M)
    affine_scan_fwd.launches += 1
    return out


affine_scan_fwd.launches = 0


def affine_scan_bwd(A_tm: Tensor, xs: Tensor, g: Tensor):
    """K1-bwd's wrapper: A_tm ``(T, M)``, the trajectory xs and its cotangent
    g ``(T+1, M)`` -> (dA ``(T, M)``, dB ``(T, M)``, dx0 ``(M,)``)."""
    T, M = A_tm.shape
    if xs.shape != (T + 1, M) or g.shape != (T + 1, M):
        raise ValueError(f"shapes A {tuple(A_tm.shape)}, xs {tuple(xs.shape)}, g {tuple(g.shape)}")
    if A_tm.device.type == "cpu":
        return affine_scan_bwd_plain(A_tm, xs, g)
    _build.check_cuda("affine_scan_bwd", A_tm, xs, g)
    dA = torch.empty((T, M), dtype=torch.float32, device=A_tm.device)
    dB = torch.empty_like(dA)
    dx0 = torch.empty((M,), dtype=torch.float32, device=A_tm.device)
    fn = _build.function("affine_scan", "affine_scan_bwd", _BWD_ARGTYPES)
    _build.launch("affine_scan_bwd", fn, A_tm.contiguous(), xs.contiguous(), g.contiguous(), dA, dB, dx0, T, M)
    affine_scan_bwd.launches += 1
    return dA, dB, dx0


affine_scan_bwd.launches = 0


class _AffineScan(torch.autograd.Function):
    """K1 forward, K1-bwd backward (the JAX package's ``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, A_tm, B_tm, x0):
        xs = affine_scan_fwd(A_tm, B_tm, x0)
        ctx.save_for_backward(A_tm, xs)
        return xs

    @staticmethod
    def backward(ctx, g):
        A_tm, xs = ctx.saved_tensors
        return affine_scan_bwd(A_tm, xs, g)


def affine_scan_tm(A_tm: Tensor, B_tm: Tensor, x0: Tensor) -> Tensor:
    """Time-major entry: A_tm, B_tm ``(T, M)``, x0 ``(M,)`` -> ``(T+1, M)``;
    differentiable in all three."""
    return _AffineScan.apply(A_tm, B_tm, x0)


def affine_scan(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Batch-major entry, as ``affine_scan_pallas``: A, B ``(Bt, T, D)``, x0
    ``(Bt, D)`` -> ``(Bt, T+1, D)`` including x0; unbatched ``(T, D)`` too."""
    if A.ndim == 2:
        return affine_scan(A[None], B[None], x0[None])[0]
    Bt, T, D = A.shape
    A_tm = A.permute(1, 0, 2).reshape(T, Bt * D)
    B_tm = B.permute(1, 0, 2).reshape(T, Bt * D)
    xs = affine_scan_tm(A_tm, B_tm, x0.reshape(Bt * D))
    return xs.reshape(T + 1, Bt, D).permute(1, 0, 2)

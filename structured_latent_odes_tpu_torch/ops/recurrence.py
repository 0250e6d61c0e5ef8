"""Kernels K1 and K1-bwd: the affine scan ``x_t = A_t * x_{t-1} + B_t`` and
its reverse (adjoint) sweep.

K1 replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/recurrence.py
::_scan_kernel`` (launched by ``_affine_scan_raw``; entry points
``affine_scan_pallas_tm`` and ``affine_scan_pallas``); K1-bwd replaces the
same kernel as the JAX package's custom VJP ``_bwd`` runs it on time-reversed
coefficients. Both are in ``csrc/affine_scan.cu`` and take the batch-major
layout the model holds: coefficients ``(Bt, T, D)``, trajectories
``(Bt, T+1, D)``. A block owns four whole trajectories, whose runs in every
array are contiguous: one thread copies each input run into shared memory
with one bulk copy of the Tensor Memory Accelerator, a thread per component
runs the chain from there, and all threads store the output runs with
16-byte stores. At the training shape a launch is bound by latency, at large
batch by bytes (each array read or written once). A block's shared memory
caps the steps: at D = 5, T up to 966 forward and 579 backward (CVS and proc
have 85 steps, challenge 141). The wrappers ask the library for the cap
(``affine_scan_max_steps``) and raise above it.

:func:`affine_scan` (batch-major, the model's entry) and
:func:`affine_scan_tm` (time-major) are differentiable: a
``torch.autograd.Function`` runs K1 forward (saving A and the trajectory) and
K1-bwd backward, and hands both the tensors it holds, with no copy; where no
gradient is asked for, :func:`affine_scan` calls K1's wrapper directly.
:func:`affine_scan_fwd` and :func:`affine_scan_bwd` are the kernels'
wrappers; :func:`affine_scan_batched_plain` and
:func:`affine_scan_bwd_batched_plain` their plain PyTorch versions, used for
a tensor on the CPU and held against the kernels on the card;
:func:`affine_scan_plain` computes the forward time-major, ``(T, ...)``, as a
batch of one. A wrapper takes contiguous float32
tensors on one device and raises on anything else; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from structured_latent_odes_tpu_torch.ops import _build

Tensor = torch.Tensor

# (A, B, x0, out, Bt, T, D, stream) and (A, xs, g, dA, dB, dx0, Bt, T, D, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def affine_scan_batched_plain(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Plain version of K1, the scan over time axis 1: A, B ``(Bt, T, ...)``,
    x0 ``(Bt, ...)`` -> ``(Bt, T+1, ...)`` including x0. The product and the
    sum round separately."""
    xs = [x0]
    x = x0
    for t in range(A.shape[1]):
        x = A[:, t] * x + B[:, t]
        xs.append(x)
    return torch.stack(xs, 1)


def affine_scan_bwd_batched_plain(A: Tensor, xs: Tensor, g: Tensor):
    """Plain version of K1-bwd, the reverse sweep of
    :func:`affine_scan_batched_plain`: A ``(Bt, T, ...)``, the trajectory xs
    and its cotangent g ``(Bt, T+1, ...)`` -> (dA, dB ``(Bt, T, ...)``, dx0
    ``(Bt, ...)``)."""
    lam = g[:, -1]
    dA, dB = [], []
    for t in range(A.shape[1] - 1, -1, -1):
        dA.append(lam * xs[:, t])
        dB.append(lam)
        lam = A[:, t] * lam + g[:, t]
    return torch.stack(dA[::-1], 1), torch.stack(dB[::-1], 1), lam


def affine_scan_plain(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """The scan over time axis 0: A, B ``(T, ...)``, x0 ``(...)`` ->
    ``(T+1, ...)`` including x0; :func:`affine_scan_batched_plain` on a batch
    of one."""
    return affine_scan_batched_plain(A[None], B[None], x0[None])[0]


def _check(name: str, tensors, shapes) -> None:
    """Shapes as given; float32, contiguous and on one device: a wrapper
    neither copies nor converts."""
    if any(t.shape != shape for t, shape in zip(tensors, shapes)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}, expected {list(shapes)}")
    device = tensors[0].device
    if any(t.device != device or t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous float32 tensors on one device")


@functools.lru_cache(maxsize=None)
def _max_steps(D: int, backward: bool) -> int:
    """The most steps a launch takes at width D (csrc/affine_scan.cu
    ``affine_scan_max_steps``: a tile's runs in one block's shared memory); -1
    for a width the kernels do not take."""
    fn = _build.function("affine_scan", "affine_scan_max_steps", [ctypes.c_int, ctypes.c_int])
    return fn(D, int(backward))


def _cuda_only(name: str, device: torch.device, T: int, D: int, backward: bool) -> None:
    """What only the kernel limits: the device, D and the steps a block's
    shared memory holds."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if D == 0:
        return
    steps = _max_steps(D, backward)
    if steps < 0:
        raise ValueError(f"{name} runs a thread per component: D = {D} is wider than the kernel takes")
    if T > steps:
        raise ValueError(f"{name}: a tile of trajectories of {T} steps needs more shared memory than a "
                         f"block has (at most {steps} steps at D = {D})")


def _coeff_shape(name: str, A: Tensor):
    if A.ndim != 3:
        raise ValueError(f"{name}: shapes: A {tuple(A.shape)} is not (Bt, T, D)")
    return A.shape


def affine_scan_fwd(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """K1's wrapper: A, B ``(Bt, T, D)``, x0 ``(Bt, D)`` -> ``(Bt, T+1, D)``,
    x0 in step 0."""
    Bt, T, D = _coeff_shape("affine_scan_fwd", A)
    _check("affine_scan_fwd", (A, B, x0), ((Bt, T, D), (Bt, T, D), (Bt, D)))
    if A.device.type == "cpu":
        return affine_scan_batched_plain(A, B, x0)
    _cuda_only("affine_scan_fwd", A.device, T, D, backward=False)
    out = A.new_empty((Bt, T + 1, D))
    if Bt and D:
        fn = _build.function("affine_scan", "affine_scan_fwd", _FWD_ARGTYPES)
        _build.launch("affine_scan_fwd", fn, A, B, x0, out, Bt, T, D)
        affine_scan_fwd.launches += 1
    return out


affine_scan_fwd.launches = 0


def affine_scan_bwd(A: Tensor, xs: Tensor, g: Tensor):
    """K1-bwd's wrapper: A ``(Bt, T, D)``, the trajectory xs and its
    cotangent g ``(Bt, T+1, D)`` -> (dA ``(Bt, T, D)``, dB ``(Bt, T, D)``,
    dx0 ``(Bt, D)``)."""
    Bt, T, D = _coeff_shape("affine_scan_bwd", A)
    _check("affine_scan_bwd", (A, xs, g), ((Bt, T, D), (Bt, T + 1, D), (Bt, T + 1, D)))
    if A.device.type == "cpu":
        return affine_scan_bwd_batched_plain(A, xs, g)
    _cuda_only("affine_scan_bwd", A.device, T, D, backward=True)
    dA = torch.empty_like(A)
    dB = torch.empty_like(A)
    dx0 = A.new_empty((Bt, D))
    if Bt and D:
        fn = _build.function("affine_scan", "affine_scan_bwd", _BWD_ARGTYPES)
        _build.launch("affine_scan_bwd", fn, A, xs, g, dA, dB, dx0, Bt, T, D)
        affine_scan_bwd.launches += 1
    return dA, dB, dx0


affine_scan_bwd.launches = 0


class _AffineScan(torch.autograd.Function):
    """K1 forward, K1-bwd backward (the JAX package's ``_fwd``/``_bwd``), on
    batch-major tensors."""

    @staticmethod
    def forward(ctx, A, B, x0):
        xs = affine_scan_fwd(A, B, x0)
        ctx.save_for_backward(A, xs)
        return xs

    @staticmethod
    def backward(ctx, g):
        A, xs = ctx.saved_tensors
        # the model's cotangent is contiguous already (the heads' matmul
        # makes it), and then contiguous() is no copy
        return affine_scan_bwd(A, xs, g.contiguous())


def affine_scan(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Batch-major entry, as ``affine_scan_pallas``: A, B ``(Bt, T, D)``, x0
    ``(Bt, D)`` -> the contiguous trajectory ``(Bt, T+1, D)`` including x0;
    unbatched ``(T, D)`` and ``(D,)`` too. Differentiable in all three; the
    kernels take the tensors as they are."""
    if A.ndim == 2:
        return affine_scan(A[None], B[None], x0[None])[0]
    if torch.is_grad_enabled() and (A.requires_grad or B.requires_grad or x0.requires_grad):
        return _AffineScan.apply(A, B, x0)
    return affine_scan_fwd(A, B, x0)


def affine_scan_tm(A_tm: Tensor, B_tm: Tensor, x0: Tensor) -> Tensor:
    """Time-major entry: A_tm, B_tm ``(T, M)``, x0 ``(M,)`` -> ``(T+1, M)``;
    differentiable in all three. Each of the M lanes is a trajectory of one
    component, so the kernels get the transposes ``(M, T, 1)``."""
    if A_tm.ndim != 2 or B_tm.shape != A_tm.shape or x0.shape != A_tm.shape[1:]:
        raise ValueError(f"shapes A {tuple(A_tm.shape)}, B {tuple(B_tm.shape)}, x0 {tuple(x0.shape)}")
    xs = affine_scan(A_tm.t().contiguous()[..., None], B_tm.t().contiguous()[..., None], x0[:, None])
    return xs[..., 0].t()

"""Kernel K1: the forward affine scan ``x_t = A_t * x_{t-1} + B_t``.

Replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/recurrence.py
::_scan_kernel`` (launched by ``_affine_scan_raw``; entry points
``affine_scan_pallas_tm`` and ``affine_scan_pallas``). The CUDA source is
``csrc/affine_scan.cu``: one thread per lane, the time loop inside the thread,
time-major ``(T, M)`` so a warp's loads and stores coalesce. It is bound by
bytes: ``4 * (2*T*M + M + (T+1)*M)`` read and written once.

:func:`affine_scan_plain` is the kernel's plain PyTorch version, used for a
tensor on the CPU and held against the kernel on the card. For a CUDA tensor
the wrappers launch the kernel or raise.

Forward only: the wrappers carry no autograd graph and raise if an input
requires grad. The reverse scan (K1-bwd) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from structured_latent_odes_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def check_forward_only(name: str, *tensors: torch.Tensor) -> None:
    """The forward kernels have no backward yet: refuse an autograd input
    rather than return a silently wrong (zero) gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel: its backward is ported with the "
            "training slice (ROADMAP B1-bwd, B2-bwd). Call it under "
            "torch.no_grad() or on tensors that do not require grad."
        )


def affine_scan_plain(A: torch.Tensor, B: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Sequential scan over time axis 0: A, B ``(T, ...)``, x0 ``(...)`` ->
    ``(T+1, ...)`` including x0. The product and the sum round separately."""
    xs = [x0]
    x = x0
    for t in range(A.shape[0]):
        x = A[t] * x + B[t]
        xs.append(x)
    return torch.stack(xs, 0)


def affine_scan_tm(A_tm: torch.Tensor, B_tm: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Time-major entry: A_tm, B_tm ``(T, M)``, x0 ``(M,)`` -> ``(T+1, M)``."""
    check_forward_only("affine_scan_fwd", A_tm, B_tm, x0)
    T, M = A_tm.shape
    if B_tm.shape != (T, M) or x0.shape != (M,):
        raise ValueError(f"shapes A {tuple(A_tm.shape)}, B {tuple(B_tm.shape)}, x0 {tuple(x0.shape)}")
    if A_tm.device.type == "cpu":
        return affine_scan_plain(A_tm, B_tm, x0)
    if A_tm.device.type != "cuda":
        raise ValueError(f"affine_scan_fwd runs on cuda or cpu, not {A_tm.device}")
    for t in (A_tm, B_tm, x0):
        if t.device != A_tm.device or t.dtype != torch.float32:
            raise ValueError("affine_scan_fwd takes float32 tensors on one device")
    A_c, B_c, x0_c = A_tm.contiguous(), B_tm.contiguous(), x0.contiguous()
    out = torch.empty((T + 1, M), dtype=torch.float32, device=A_tm.device)
    fn = _build.function("affine_scan", "affine_scan_fwd", _ARGTYPES)
    with torch.cuda.device(A_tm.device):
        err = fn(
            A_c.data_ptr(), B_c.data_ptr(), x0_c.data_ptr(), out.data_ptr(), T, M,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"affine_scan_fwd launch failed with CUDA error {err}")
    affine_scan_tm.launches += 1
    return out


affine_scan_tm.launches = 0


def affine_scan(A: torch.Tensor, B: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Batch-major entry, as ``affine_scan_pallas``: A, B ``(Bt, T, D)``, x0
    ``(Bt, D)`` -> ``(Bt, T+1, D)`` including x0; unbatched ``(T, D)`` too."""
    if A.ndim == 2:
        return affine_scan(A[None], B[None], x0[None])[0]
    Bt, T, D = A.shape
    A_tm = A.permute(1, 0, 2).reshape(T, Bt * D)
    B_tm = B.permute(1, 0, 2).reshape(T, Bt * D)
    xs = affine_scan_tm(A_tm, B_tm, x0.reshape(Bt * D))
    return xs.reshape(T + 1, Bt, D).permute(1, 0, 2)

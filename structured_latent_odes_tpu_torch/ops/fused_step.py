"""Kernel K2: the whole semilinear RK solve of the decoder ODE in one launch.

Replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/fused_step.py
::_fwd_kernel`` (launched by ``_fwd_call``; entry point
``fused_semilinear_solve``). The CUDA source is
``csrc/fused_semilinear_fwd.cu``: one trajectory per thread, its latent
projection row and state in registers, the head weights and time tables in
shared memory, stages unrolled per method at compile time. It never writes the
``(B, T-1, S, H)`` stage activations that the unfused path materializes; it
reads ``u`` once and writes the trajectory once. It is bound by operations:
``B * (T-1) * S * (4*D*H + 2*H)`` flops.

The latent projection ``u = z @ W[:, 1:].T + b`` and ``x0`` stay in PyTorch,
as in the JAX package.

:func:`fused_semilinear_fwd_plain` is the kernel's plain PyTorch version,
used for a tensor on the CPU and held against the kernel on the card. For a
CUDA tensor the wrapper launches the kernel or raises. Forward only: the
backward kernel (K3) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.ode.semilinear import rk_affine_coeffs, stage_time_grid
from structured_latent_odes_tpu_torch.ode.tableaus import get_tableau
from structured_latent_odes_tpu_torch.ops import _build
from structured_latent_odes_tpu_torch.ops.recurrence import check_forward_only

Tensor = torch.Tensor

# the kernel's Method enum, in order
METHODS = ("euler", "midpoint", "heun", "rk4")

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def fused_semilinear_fwd_plain(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """Plain version of K2, one step at a time as the kernel walks time.

    u ``(B, H)``, wt ``(H,)``, wa/wd ``(D, H)``, ba/bd ``(D,)``, x0 ``(B, D)``,
    ts ``(T,)``. Returns the time-major trajectory ``(T, D, B)``.
    """
    tableau = get_tableau(method)
    sts, hs = stage_time_grid(ts, tableau), ts[1:] - ts[:-1]
    x = x0
    xs = [x0]
    for t in range(sts.shape[0]):
        a_st, d_st = [], []
        for i in range(sts.shape[1]):
            h = torch.relu(u + sts[t, i] * wt)
            a_st.append(torch.sigmoid(h @ wa.T + ba))
            d_st.append(torch.sigmoid(h @ wd.T + bd))
        A, Bc = rk_affine_coeffs(torch.stack(a_st, -2), torch.stack(d_st, -2), hs[t], tableau)
        x = A * x + Bc
        xs.append(x)
    return torch.stack(xs, 0).transpose(1, 2)


def fused_semilinear_fwd(u, wt, wa, ba, wd, bd, x0, ts, method: str) -> Tensor:
    """K2's wrapper: the arguments of :func:`fused_semilinear_fwd_plain`,
    returning the time-major trajectory ``(T, D, B)``."""
    if method not in METHODS:
        raise ValueError(f"fused_semilinear_fwd supports {METHODS}, not {method!r}")
    args = (u, wt, wa, ba, wd, bd, x0, ts)
    check_forward_only("fused_semilinear_fwd", *args)
    B, H = u.shape
    D = x0.shape[1]
    T = ts.shape[0]
    expected = ((B, H), (H,), (D, H), (D,), (D, H), (D,), (B, D), (T,))
    if tuple(tuple(a.shape) for a in args) != expected:
        raise ValueError(f"shapes {[tuple(a.shape) for a in args]}, expected {list(expected)}")
    if u.device.type == "cpu":
        return fused_semilinear_fwd_plain(*args, method)
    if u.device.type != "cuda":
        raise ValueError(f"fused_semilinear_fwd runs on cuda or cpu, not {u.device}")
    if any(a.device != u.device or a.dtype != torch.float32 for a in args):
        raise ValueError("fused_semilinear_fwd takes float32 tensors on one device")
    sts = stage_time_grid(ts, get_tableau(method)).contiguous()
    hs = ts[1:] - ts[:-1]
    w = torch.cat([wt, wa.reshape(-1), ba, wd.reshape(-1), bd]).contiguous()
    u_t = u.t().contiguous()
    x0_t = x0.t().contiguous()
    out = torch.empty((T, D, B), dtype=torch.float32, device=u.device)
    fn = _build.function(
        "fused_semilinear_fwd", "fused_semilinear_fwd", _ARGTYPES,
        defines=(("SLODE_H", H), ("SLODE_D", D)),
    )
    with torch.cuda.device(u.device):
        err = fn(
            METHODS.index(method), u_t.data_ptr(), x0_t.data_ptr(), w.data_ptr(),
            sts.data_ptr(), hs.data_ptr(), out.data_ptr(), B, T,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_semilinear_fwd launch failed with CUDA error {err}")
    fused_semilinear_fwd.launches += 1
    return out


fused_semilinear_fwd.launches = 0


def fused_semilinear_solve(params, z: Tensor, x0: Tensor, ts, method: str = "midpoint") -> Tensor:
    """Fused whole-solve entry: the OdeModel params (port layout,
    nn/ode_model.py), z ``(B, L)``, x0 ``(B, D)``, ts ``(T,)`` -> ``(B, T, D)``."""
    W, b = params["dyn_hidden"]["W"], params["dyn_hidden"]["b"]  # (H, L+1): column 0 is time
    u = F.linear(z, W[:, 1:], b)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=z.device)
    xs = fused_semilinear_fwd(
        u, W[:, 0], params["prod"]["W"], params["prod"]["b"],
        params["degr"]["W"], params["degr"]["b"], x0, ts, method,
    )
    return xs.permute(2, 0, 1)

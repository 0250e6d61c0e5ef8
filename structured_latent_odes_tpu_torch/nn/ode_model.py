"""The neural ODE decoder core (the JAX package's ``nn/ode_model.py``).

- ``latent_to_ode``: Linear(L, H) -> ReLU -> Linear(H, D) -> Sigmoid maps z
  to the initial state x0.
- dynamics: a shared hidden layer on ``[t, z]`` (time first) feeding two
  sigmoid heads, production ``a`` and degradation ``d``, with
  ``dx/dt = a(t, z) - d(t, z) * x``.

Port layout: ``dyn_hidden.W`` is ``(H, L+1)`` and its column 0 is the time
weight (row 0 of the JAX package's ``(L+1, H)`` kernel).

``solve_ode`` runs every backend of the JAX package, forward and
backward:

- 'semilinear' and 'semilinear_pallas' run kernels K1 and K1-bwd (PyTorch
  has no associative scan, and both compute the same recurrence);
- 'semilinear_seq' the plain loop under autograd;
- 'semilinear_fused' kernels K2 and K3 (the whole solve);
- 'semilinear_auto' one of the two kernel paths, chosen from the shapes, the
  solver and the device before any launch (:func:`auto_picks_fused`): on the
  card K2/K3 wherever they take the solver and the widths (the H100 showed
  no crossover), else K1/K1-bwd; on the CPU the K1 path's plain version, as
  the JAX package off a TPU takes its associative scan;
- 'generic' (fixed-step RK on the full right-hand side ``a - d * x``, under
  autograd), 'adjoint' (the same forward, the continuous adjoint backward),
  'adaptive' (dopri5 with one step schedule for the batch) and
  'adaptive_per_sample' (dopri5 with one schedule per trajectory), both
  adaptive ones with the adaptive continuous adjoint backward
  (``ode/solvers.py``, ``ode/adjoint.py``; plain PyTorch, as in the JAX
  package no Pallas kernel backs them).

Outside the kernels (the latent projection, ``initialize_state``, the stage
heads of the scan backends, the RK coefficients) gradients come from torch
autograd, as the JAX package leaves them to XLA.

'semilinear_timepar' splits the solve's horizon over the ranks of a grid's
time axis (``parallel/timepar.py``: the heads and the RK coefficients on each
rank's chunk, its local prefix on K1, K1-bwd in the backward), reading the
grid from the ambient context that ``--time-parallel`` installs; without one
it raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.nn.init import torch_linear_default, xavier_uniform
from structured_latent_odes_tpu_torch.nn.layers import linear_apply
from structured_latent_odes_tpu_torch.ode.adjoint import odeint_adaptive_adjoint, odeint_adjoint
from structured_latent_odes_tpu_torch.ode.semilinear import solve_semilinear
from structured_latent_odes_tpu_torch.ode.solvers import odeint, odeint_adaptive_per_sample
from structured_latent_odes_tpu_torch.ops.fused_step import fused_semilinear_solve, kernels_take

Tensor = torch.Tensor

_SCAN_BACKENDS = {
    "semilinear": "kernel",
    "semilinear_pallas": "kernel",
    "semilinear_seq": "seq",
    "semilinear_auto": "kernel",  # where auto_picks_fused is false
}

# the backends whose step schedules follow the data (dopri5 with step control)
ADAPTIVE_BACKENDS = ("adaptive", "adaptive_per_sample")


def solve_is_per_member(spec: OdeModelSpec) -> bool:
    """Whether an ensemble's members go through this spec's solve one at a
    time rather than under one ``torch.func.vmap``: the adaptive backends,
    whose loops read each member's own condition on the host (and a float32
    dopri5 solve at rtol 1e-6 turns the roundoff by which batched and single
    products differ into up to 1e-4 of its scale, where its step control
    meets the relu's kinks), and 'semilinear_timepar', whose collectives take
    one member's tensors."""
    return spec.backend in ADAPTIVE_BACKENDS or spec.backend == "semilinear_timepar"


# the backends whose solve a CUDA graph cannot capture, and why
NOT_CAPTURABLE = {
    **{b: "its trips read the host and replay graphs of their own" for b in ADAPTIVE_BACKENDS},
    "semilinear_timepar": "its collectives span the time ranks",
}


def solve_is_capturable(spec: OdeModelSpec) -> bool:
    """Whether a CUDA graph can capture this spec's solve, forward and
    backward (``utils/graphs.py``): every fixed-step backend, whose
    operations and shapes do not depend on the data; not the adaptive ones,
    whose loops read their condition on the host, nor 'semilinear_timepar'
    (:data:`NOT_CAPTURABLE`)."""
    return spec.backend not in NOT_CAPTURABLE


@dataclasses.dataclass(frozen=True)
class OdeModelSpec:
    latent_dim: int
    ode_state_dim: int
    ode_hidden_dim: int
    solver: str = "midpoint"
    # 'semilinear' (K1, default), 'semilinear_pallas' (K1), 'semilinear_seq'
    # (plain loop), 'semilinear_fused' (K2: whole solve in one kernel),
    # 'semilinear_auto' (K1 or K2 by shape, solver and device),
    # 'semilinear_timepar' (K1 over a grid's time ranks), 'generic',
    # 'adjoint', 'adaptive', 'adaptive_per_sample' (module docstring)
    backend: str = "semilinear"
    # the adaptive backends' tolerances
    rtol: float = 1e-6
    atol: float = 1e-8


def ode_model_init(gen: torch.Generator, spec: OdeModelSpec):
    L, D, H = spec.latent_dim, spec.ode_state_dim, spec.ode_hidden_dim
    l1_W, l1_b = torch_linear_default(gen, L, H)
    l2_W, l2_b = torch_linear_default(gen, H, D)
    return {
        "latent_to_ode": [{"W": l1_W, "b": l1_b}, {"W": l2_W, "b": l2_b}],
        "dyn_hidden": {"W": xavier_uniform(gen, L + 1, H), "b": torch_linear_default(gen, L + 1, H)[1]},
        "prod": {"W": xavier_uniform(gen, H, D, gain=0.5), "b": torch_linear_default(gen, H, D)[1]},
        "degr": {"W": xavier_uniform(gen, H, D), "b": torch_linear_default(gen, H, D)[1]},
    }


def initialize_state(params, z: Tensor) -> Tensor:
    """latent -> x0 via Linear/ReLU/Linear/Sigmoid."""
    h = torch.relu(linear_apply(params["latent_to_ode"][0], z))
    return torch.sigmoid(linear_apply(params["latent_to_ode"][1], h))


def dynamics_prod_degr(params, t: Tensor, z: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, d) at times t of any shape S for latents z (B, L): each
    ``(B, *S, D)``."""
    W, b = params["dyn_hidden"]["W"], params["dyn_hidden"]["b"]
    z_proj = F.linear(z, W[:, 1:], b)  # (B, H)
    t_term = t[..., None] * W[:, 0]  # (*S, H)
    h = torch.relu(z_proj.reshape(z.shape[0], *([1] * t.ndim), -1) + t_term[None])
    a = torch.sigmoid(h @ params["prod"]["W"].T + params["prod"]["b"])
    d = torch.sigmoid(h @ params["degr"]["W"].T + params["degr"]["b"])
    return a, d


def dynamics_rhs(params, t: Tensor, x: Tensor, z: Tensor) -> Tensor:
    """The full right-hand side ``dx/dt = a(t, z) - d(t, z) * x`` at a scalar
    time t, for the generic, adjoint and adaptive solvers."""
    a, d = dynamics_prod_degr(params, t, z)
    return a - d * x


def dynamics_rhs_per_sample_time(params, t: Tensor, x: Tensor, z: Tensor) -> Tensor:
    """The right-hand side at per-sample times ``t (B, 1)`` aligned to
    ``z (B, L)``: the signature the per-sample adaptive solver drives (each
    trajectory at its own clock)."""
    W, b = params["dyn_hidden"]["W"], params["dyn_hidden"]["b"]
    h = torch.relu(F.linear(z, W[:, 1:], b) + t * W[:, 0])  # (B, H)
    a = torch.sigmoid(h @ params["prod"]["W"].T + params["prod"]["b"])
    d = torch.sigmoid(h @ params["degr"]["W"].T + params["degr"]["b"])
    return a - d * x


# 'semilinear_auto' on the H100: scripts/auto_crossover.py ran the K1/K1-bwd
# path and the fused K2/K3 path end to end (served requests, and stacked dual
# steps at S = 1, 5 and 10 members) at B = 7 .. 16,411, midpoint, rk4 and
# dopri5, (H, D) = (25, 5) and (25, 8). The fused path was ahead, or level
# within the quartile spread with fewer device operations, at all 168 points
# (PERF.md section 6, "semilinear_auto's crossover"; an NVIDIA H100 80GB HBM3
# at 700.00 W): there is no crossover width, so the choice reads no batch
# size. No TPU threshold carries over.
def auto_picks_fused(spec: OdeModelSpec, z: Tensor) -> bool:
    """'semilinear_auto''s choice, from the shapes, the solver and the device
    alone, before any launch: the fused K2/K3 path on a CUDA tensor where the
    kernels take the solver and the widths, else the K1 path (on the CPU,
    its plain version)."""
    return (
        z.device.type == "cuda"
        and z.ndim == 2
        and kernels_take(spec.solver, spec.ode_hidden_dim, spec.ode_state_dim)
    )


def solve_ode(spec: OdeModelSpec, params, z: Tensor, ts) -> Tensor:
    """Integrate from x0(z) over ts. Returns (B, T, D)."""
    x0 = initialize_state(params, z)
    if spec.backend == "semilinear_timepar":
        from structured_latent_odes_tpu_torch.parallel.timepar import get_time_sharding, solve_semilinear_timepar

        ctx = get_time_sharding()
        return solve_semilinear_timepar(dynamics_prod_degr, params, z, x0, ts, method=spec.solver, mesh=ctx.mesh,
                                        time_axis=ctx.time_axis)
    if spec.backend == "semilinear_fused" or (spec.backend == "semilinear_auto" and auto_picks_fused(spec, z)):
        return fused_semilinear_solve(params, z, x0, ts, method=spec.solver)
    if spec.backend in _SCAN_BACKENDS:
        return solve_semilinear(
            lambda stage_ts: dynamics_prod_degr(params, stage_ts, z),
            x0, ts, method=spec.solver, backend=_SCAN_BACKENDS[spec.backend],
        )
    if spec.backend == "generic":
        return odeint(lambda t, x: dynamics_rhs(params, t, x, z), x0, ts, method=spec.solver).movedim(0, 1)
    # params and z go in as the solve's args, so the adjoint's backward
    # reaches them (a closure would hide them from it)
    if spec.backend == "adjoint":
        return odeint_adjoint(_rhs_of_args, x0, ts, (params, z), method=spec.solver).movedim(0, 1)
    if spec.backend in ADAPTIVE_BACKENDS:
        forward = None
        if spec.backend == "adaptive_per_sample":
            def forward(x0_, args):
                return odeint_adaptive_per_sample(
                    lambda t, x: dynamics_rhs_per_sample_time(args[0], t, x, args[1]), x0_, ts,
                    rtol=spec.rtol, atol=spec.atol)
        sol = odeint_adaptive_adjoint(_rhs_of_args, x0, ts, (params, z), rtol=spec.rtol, atol=spec.atol,
                                      forward=forward)
        return sol.movedim(0, 1)  # time-major -> (B, T, D)
    raise ValueError(f"unknown ode backend {spec.backend!r}")


def _rhs_of_args(t: Tensor, x: Tensor, args) -> Tensor:
    """``dynamics_rhs`` with (params, z) as the solver's args."""
    return dynamics_rhs(args[0], t, x, args[1])

"""The neural ODE decoder core (the JAX package's ``nn/ode_model.py``).

- ``latent_to_ode``: Linear(L, H) -> ReLU -> Linear(H, D) -> Sigmoid maps z
  to the initial state x0.
- dynamics: a shared hidden layer on ``[t, z]`` (time first) feeding two
  sigmoid heads, production ``a`` and degradation ``d``, with
  ``dx/dt = a(t, z) - d(t, z) * x``.

Port layout: ``dyn_hidden.W`` is ``(H, L+1)`` and its column 0 is the time
weight (row 0 of the JAX package's ``(L+1, H)`` kernel).

``solve_ode`` runs the four semilinear backends, forward and backward:
'semilinear' and 'semilinear_pallas' run kernels K1 and K1-bwd (PyTorch has
no associative scan, and both compute the same recurrence),
'semilinear_seq' the plain loop under autograd, 'semilinear_fused' kernels
K2 and K3. Outside the kernels (the latent projection, ``initialize_state``,
the stage heads of the scan backends, the RK coefficients) gradients come
from torch autograd, as the JAX package leaves them to XLA. The other
backends raise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.nn.init import torch_linear_default, xavier_uniform
from structured_latent_odes_tpu_torch.nn.layers import linear_apply
from structured_latent_odes_tpu_torch.ode.semilinear import solve_semilinear
from structured_latent_odes_tpu_torch.ops.fused_step import fused_semilinear_solve

Tensor = torch.Tensor

_SCAN_BACKENDS = {
    "semilinear": "kernel",
    "semilinear_pallas": "kernel",
    "semilinear_seq": "seq",
}

_NOT_PORTED = {
    "generic": "ROADMAP A14",
    "adjoint": "ROADMAP A14",
    "adaptive": "ROADMAP A14",
    "adaptive_per_sample": "ROADMAP A14",
    "semilinear_timepar": "ROADMAP A17",
    "semilinear_auto": (
        "ROADMAP A19, an H100 measurement of its crossover thresholds (the JAX "
        "package's _PALLAS_MIN_LANES and _FUSED_MIN_LANES were measured on a TPU)"
    ),
}


@dataclasses.dataclass(frozen=True)
class OdeModelSpec:
    latent_dim: int
    ode_state_dim: int
    ode_hidden_dim: int
    solver: str = "midpoint"
    # 'semilinear' (K1, default), 'semilinear_pallas' (K1), 'semilinear_seq'
    # (plain loop), 'semilinear_fused' (K2: whole solve in one kernel)
    backend: str = "semilinear"


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


def solve_ode(spec: OdeModelSpec, params, z: Tensor, ts) -> Tensor:
    """Integrate from x0(z) over ts. Returns (B, T, D)."""
    if spec.backend in _NOT_PORTED:
        raise NotImplementedError(
            f"ode backend {spec.backend!r} is not ported yet: it waits for "
            f"{_NOT_PORTED[spec.backend]}"
        )
    x0 = initialize_state(params, z)
    if spec.backend == "semilinear_fused":
        return fused_semilinear_solve(params, z, x0, ts, method=spec.solver)
    if spec.backend in _SCAN_BACKENDS:
        return solve_semilinear(
            lambda stage_ts: dynamics_prod_degr(params, stage_ts, z),
            x0, ts, method=spec.solver, backend=_SCAN_BACKENDS[spec.backend],
        )
    raise ValueError(f"unknown ode backend {spec.backend!r}")

"""Decoder heads over the ODE solution (the JAX package's ``nn/decoders.py``).

Each decoder integrates the neural ODE once and maps the state trajectory to
observation space with bias-free linear heads; the observation scale is a
learnable ``(obs_dim, T)`` ``constant_std`` through softplus + 1e-6. Outputs
use the ``(B, K, T)`` layout (channels before time).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.nn.init import torch_linear_default
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec, ode_model_init, solve_ode

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    kind: str  # 'quantile' | 'gaussian' | 'variance_gaussian'
    ode: OdeModelSpec
    obs_dim: int
    n_time: int
    constant_std: float = 1e-2


def decoder_init(gen: torch.Generator, spec: DecoderSpec):
    D, K = spec.ode.ode_state_dim, spec.obs_dim

    def head():
        return {"W": torch_linear_default(gen, D, K)[0]}  # bias-free, (K, D)

    params: Dict = {"ode": ode_model_init(gen, spec.ode)}
    if spec.kind == "quantile":
        for name in ("q50", "q75", "q25"):
            params[name] = head()
    elif spec.kind == "gaussian":
        params["mean"] = head()
    elif spec.kind == "variance_gaussian":
        params["std_ode"] = ode_model_init(gen, spec.ode)
        params["mean"] = head()
        params["std"] = head()
    else:
        raise ValueError(spec.kind)
    params["constant_std"] = torch.full((K, spec.n_time), spec.constant_std)
    return params


def _head(sol: Tensor, head) -> Tensor:
    """(B, T, D) -> (B, K, T)."""
    return F.linear(sol, head["W"]).transpose(-1, -2)


def _constant_std(params, shape) -> Tensor:
    return (F.softplus(params["constant_std"]) + 1e-6).expand(shape)


def decoder_apply(spec: DecoderSpec, params, z: Tensor, ts):
    """Returns, per kind:

    - quantile: ``(solution, mu_75, mu_50, mu_25, std)``
    - gaussian: ``(solution, mean, std)``
    - variance_gaussian: ``(solution, mean, std)`` with std from a second ODE
    """
    sol = solve_ode(spec.ode, params["ode"], z, ts)  # (B, T, D)
    if spec.kind == "quantile":
        mu_50 = _head(sol, params["q50"])
        mu_75 = _head(sol, params["q75"])
        mu_25 = _head(sol, params["q25"])
        return sol, mu_75, mu_50, mu_25, _constant_std(params, mu_50.shape)
    mean = _head(sol, params["mean"])
    if spec.kind == "gaussian":
        return sol, mean, _constant_std(params, mean.shape)
    # variance_gaussian: the second ODE's trajectory maps to the (raw) std
    sol_std = solve_ode(spec.ode, params["std_ode"], z, ts)
    return sol, mean, _head(sol_std, params["std"])

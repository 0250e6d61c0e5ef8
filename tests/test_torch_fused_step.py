"""K2 (ops/fused_step.py) in the PyTorch port: its plain version, which the
wrapper takes for CPU tensors, against the JAX package's fused whole-solve
Pallas kernel (interpret mode off-TPU), for every method it supports, on a
uniform and on a non-uniform time grid.

Tolerance 1e-5, as the JAX package's own fused-vs-sequential test: the
stage heads' sums and the sigmoids round differently in the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.nn.ode_model import OdeModelSpec, initialize_state, ode_model_init
from structured_latent_odes_tpu.ops.fused_step import fused_semilinear_solve
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.ops import fused_step as port

L, D, H = 15, 5, 25
B, T = 13, 21
TOL = 1e-5

GRIDS = {
    "uniform": np.arange(0.0, float(T), dtype=np.float32),
    # non-uniform observation times, as tests/test_semilinear.py's grid
    "nonuniform": np.cumsum(np.abs(np.random.RandomState(0).randn(T)) * 0.2 + 0.05).astype(np.float32),
}


def _setup():
    spec = OdeModelSpec(latent_dim=L, ode_state_dim=D, ode_hidden_dim=H)
    params = ode_model_init(jax.random.key(0), spec)
    z = np.random.RandomState(1).randn(B, L).astype(np.float32)
    x0 = np.asarray(initialize_state(params, jnp.asarray(z)))
    return params, z, x0


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_fused_plain_matches_jax_kernel(method, grid):
    params, z, x0 = _setup()
    ts = GRIDS[grid]
    ref = np.asarray(fused_semilinear_solve(params, jnp.asarray(z), jnp.asarray(x0), ts, method=method))
    p_port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = port.fused_semilinear_solve(p_port, torch.from_numpy(z), torch.from_numpy(x0), ts, method).numpy()
    assert out.shape == ref.shape == (B, T, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_fused_rejects_unsupported_method_and_autograd():
    params, z, x0 = _setup()
    p_port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    z_t, x0_t = torch.from_numpy(z), torch.from_numpy(x0)
    with pytest.raises(ValueError, match="supports"):
        port.fused_semilinear_solve(p_port, z_t, x0_t, GRIDS["uniform"], "dopri5")
    with pytest.raises(RuntimeError, match="training slice"):
        port.fused_semilinear_solve(p_port, z_t.requires_grad_(), x0_t, GRIDS["uniform"], "midpoint")


def test_fused_plain_layout_is_time_major():
    """The wrapper returns (T, D, B), the kernel's coalesced layout."""
    params, z, x0 = _setup()
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    W = p["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(torch.from_numpy(z), W[:, 1:], p["dyn_hidden"]["b"])
    out = port.fused_semilinear_fwd(
        u, W[:, 0], p["prod"]["W"], p["prod"]["b"], p["degr"]["W"], p["degr"]["b"],
        torch.from_numpy(x0), torch.from_numpy(GRIDS["uniform"]), "midpoint",
    )
    assert out.shape == (T, D, B)
    np.testing.assert_array_equal(out[0].numpy(), x0.T)

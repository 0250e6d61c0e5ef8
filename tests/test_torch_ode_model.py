"""The PyTorch port's ODE solve (ode/semilinear.py, nn/ode_model.py) against
the JAX package: stage grids and affine coefficients per method, and
``solve_ode`` for each of the four served backends against JAX's
``semilinear_seq`` at CVS widths (on the CPU the kernel backends take the
kernels' plain versions). Tolerance 1e-5 abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.nn import ode_model as jax_ode
from structured_latent_odes_tpu.ode import rk_affine_coeffs, stage_time_grid
from structured_latent_odes_tpu.ode.tableaus import get_tableau
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.nn import ode_model as port_ode
from structured_latent_odes_tpu_torch.ode import semilinear as port_sl
from structured_latent_odes_tpu_torch.ode.tableaus import get_tableau as port_tableau

L, D, H = 15, 5, 25
TOL = 1e-5


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4", "dopri5"])
def test_stage_grid_and_affine_coeffs_match_jax(method):
    ts = np.cumsum(np.random.RandomState(0).uniform(0.05, 0.3, 12)).astype(np.float32)
    S = len(get_tableau(method).c)
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (3, 11, S, 4)).astype(np.float32)
    d = rng.uniform(0, 1, (3, 11, S, 4)).astype(np.float32)
    h = np.diff(ts)
    grid_ref = np.asarray(stage_time_grid(jnp.asarray(ts), get_tableau(method)))
    grid = port_sl.stage_time_grid(torch.from_numpy(ts), port_tableau(method)).numpy()
    np.testing.assert_allclose(grid, grid_ref, rtol=0, atol=1e-6)
    A_ref, B_ref = rk_affine_coeffs(a, d, h, get_tableau(method))
    A, B = port_sl.rk_affine_coeffs(*map(torch.from_numpy, (a, d, h)), port_tableau(method))
    np.testing.assert_allclose(A.numpy(), A_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), B_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "backend", ["semilinear", "semilinear_seq", "semilinear_pallas", "semilinear_fused"]
)
@pytest.mark.parametrize("method", ["midpoint", "rk4"])
def test_solve_ode_matches_jax_seq(backend, method):
    spec = jax_ode.OdeModelSpec(L, D, H, solver=method, backend="semilinear_seq")
    params = jax_ode.ode_model_init(jax.random.key(0), spec)
    z = np.random.RandomState(2).randn(9, L).astype(np.float32)
    ts = np.arange(0.0, 17.0, dtype=np.float32)
    ref = np.asarray(jax_ode.solve_ode(spec, params, jnp.asarray(z), ts))
    port_spec = port_ode.OdeModelSpec(L, D, H, solver=method, backend=backend)
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = port_ode.solve_ode(port_spec, p, torch.from_numpy(z), ts).numpy()
    assert out.shape == ref.shape == (9, 17, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_dynamics_and_initial_state_match_jax():
    spec = jax_ode.OdeModelSpec(L, D, H)
    params = jax_ode.ode_model_init(jax.random.key(3), spec)
    z = np.random.RandomState(4).randn(6, L).astype(np.float32)
    t = np.linspace(0.0, 5.0, 8, dtype=np.float32).reshape(4, 2)
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    a_ref, d_ref = jax_ode.dynamics_prod_degr(params, jnp.asarray(t), jnp.asarray(z))
    a, d = port_ode.dynamics_prod_degr(p, torch.from_numpy(t), torch.from_numpy(z))
    assert a.shape == (6, 4, 2, D)
    np.testing.assert_allclose(a.numpy(), a_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=1e-6)
    x0_ref = jax_ode.initialize_state(params, jnp.asarray(z))
    np.testing.assert_allclose(port_ode.initialize_state(p, torch.from_numpy(z)).numpy(), x0_ref, atol=1e-6)


@pytest.mark.parametrize(
    "backend,item",
    [
        ("generic", "A14"),
        ("adjoint", "A14"),
        ("adaptive", "A14"),
        ("adaptive_per_sample", "A14"),
        ("semilinear_timepar", "A17"),
        ("semilinear_auto", "H100 measurement"),
    ],
)
def test_unported_backends_name_their_roadmap_item(backend, item):
    spec = port_ode.OdeModelSpec(L, D, H, backend=backend)
    p = port_ode.ode_model_init(torch.Generator().manual_seed(0), spec)
    with pytest.raises(NotImplementedError, match=item):
        port_ode.solve_ode(spec, p, torch.zeros(2, L), np.arange(3, dtype=np.float32))

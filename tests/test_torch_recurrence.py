"""K1 (ops/recurrence.py) in the PyTorch port: its plain version, which the
wrappers take for CPU tensors, against the JAX package's Pallas affine scan
(interpret mode off-TPU) and its associative scan.

Tolerance 1e-6 abs: the plain version and the Pallas kernel run the same
sequential recurrence in float32; the associative scan reorders the products,
which at these magnitudes (|x| < 1) moves the result by a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.ode import solve_affine_recurrence
from structured_latent_odes_tpu.ops.recurrence import affine_scan_pallas, affine_scan_pallas_tm
from structured_latent_odes_tpu_torch.ops import recurrence as port

TOL = 1e-6


def _coeffs(shape, seed):
    rng = np.random.RandomState(seed)
    A = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    B = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    x0 = rng.uniform(-1.0, 1.0, shape[:-2] + shape[-1:]).astype(np.float32)
    return A, B, x0


@pytest.mark.parametrize("Bt,T,D", [(37, 11, 3), (100, 85, 5)])  # M = 111, 500
def test_affine_scan_batched_matches_jax(Bt, T, D):
    A, B, x0 = _coeffs((Bt, T, D), Bt)
    out = port.affine_scan(*map(torch.from_numpy, (A, B, x0))).numpy()
    ref = np.asarray(affine_scan_pallas(jnp.asarray(A), jnp.asarray(B), jnp.asarray(x0)))
    assoc = np.asarray(solve_affine_recurrence(A, B, x0, time_axis=1))
    assert out.shape == ref.shape == (Bt, T + 1, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(out, assoc, rtol=0, atol=TOL)


def test_affine_scan_unbatched_matches_jax():
    A, B, x0 = _coeffs((30, 4), 7)
    out = port.affine_scan(*map(torch.from_numpy, (A, B, x0))).numpy()
    ref = np.asarray(affine_scan_pallas(jnp.asarray(A), jnp.asarray(B), jnp.asarray(x0)))
    assert out.shape == (31, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_affine_scan_time_major_matches_jax():
    """The time-major entry at an M past one 1024-lane Pallas tile and not a
    multiple of it."""
    A, B, _ = _coeffs((9, 1500), 3)
    x0 = np.random.RandomState(4).uniform(-1, 1, 1500).astype(np.float32)
    out = port.affine_scan_tm(*map(torch.from_numpy, (A, B, x0))).numpy()
    ref = np.asarray(affine_scan_pallas_tm(jnp.asarray(A), jnp.asarray(B), jnp.asarray(x0)))
    assert out.shape == (10, 1500)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_affine_scan_refuses_autograd():
    A, B, x0 = map(torch.from_numpy, _coeffs((2, 5, 3), 0))
    with pytest.raises(RuntimeError, match="training slice"):
        port.affine_scan(A.requires_grad_(), B, x0)
    with torch.no_grad():
        assert port.affine_scan(A, B, x0).shape == (2, 6, 3)


def test_affine_scan_checks_shapes():
    A, B, x0 = map(torch.from_numpy, _coeffs((5, 8), 0)[:2] + (np.zeros(7, np.float32),))
    with pytest.raises(ValueError, match="shapes"):
        port.affine_scan_tm(A, B, x0)

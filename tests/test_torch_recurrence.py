"""K1 and K1-bwd (ops/recurrence.py) in the PyTorch port: their plain
versions, which the wrappers take for CPU tensors, against the JAX package's
Pallas affine scan (interpret mode off-TPU), its custom VJP and its
associative scan.

Tolerance 1e-6 abs: the plain versions and the Pallas kernel run the same
sequential recurrences in float32; the associative scan reorders the
products, which at these magnitudes (|x| < 1) moves the result by a few ulp.
"""

import jax
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


def _jax_scan_grads(A, B, x0, w):
    """jax.grad of sum(w * affine_scan_pallas(A, B, x0)) into A, B and x0
    (as tests/test_pallas_ops.py::test_pallas_scan_gradients)."""
    def loss(A, B, x0):
        return jnp.sum(jnp.asarray(w) * affine_scan_pallas(A, B, x0))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (A, B, x0)))]


@pytest.mark.parametrize("Bt,T,D", [(4, 9, 2), (37, 11, 3)])  # M = 8, 111
def test_affine_scan_gradients_match_jax(Bt, T, D):
    """torch.autograd through affine_scan (K1 forward, K1-bwd backward; the
    plain versions on the CPU) against jax.grad through the Pallas scan.
    Tolerance 1e-6 abs, as the forward: the same sequential recurrence, at
    cotangents and adjoints of magnitude < 10."""
    A, B, x0 = _coeffs((Bt, T, D), 10 + Bt)
    w = np.random.RandomState(Bt).uniform(-1, 1, (Bt, T + 1, D)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (A, B, x0)]
    out = port.affine_scan(*leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for name, g, ref in zip("A B x0".split(), grads, _jax_scan_grads(A, B, x0, w)):
        assert g.shape == ref.shape
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=TOL, err_msg=name)


def test_affine_scan_bwd_plain_matches_jax():
    """K1-bwd's plain version on the time-major slab: the trajectory's
    cotangent g in, (dA, dB, dx0) out, against jax.grad of the time-major
    Pallas scan at M past one Pallas tile."""
    A, B, _ = _coeffs((9, 1500), 5)
    x0 = np.random.RandomState(6).uniform(-1, 1, 1500).astype(np.float32)
    g = np.random.RandomState(7).uniform(-1, 1, (10, 1500)).astype(np.float32)
    xs = port.affine_scan_plain(*map(torch.from_numpy, (A, B, x0)))
    dA, dB, dx0 = port.affine_scan_bwd(torch.from_numpy(A), xs, torch.from_numpy(g))

    def loss(A, B, x0):
        return jnp.sum(jnp.asarray(g) * affine_scan_pallas_tm(A, B, x0))

    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (A, B, x0)))
    for name, out, ref in zip("A B x0".split(), (dA, dB, dx0), refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL, err_msg=name)


def test_affine_scan_checks_shapes():
    A, B, x0 = map(torch.from_numpy, _coeffs((5, 8), 0)[:2] + (np.zeros(7, np.float32),))
    with pytest.raises(ValueError, match="shapes"):
        port.affine_scan_tm(A, B, x0)

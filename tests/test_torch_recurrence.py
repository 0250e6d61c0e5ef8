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
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

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
    """K1-bwd's plain version on the time-major layout (a batch of one):
    the trajectory's cotangent g in, (dA, dB, dx0) out, against jax.grad of
    the time-major Pallas scan at M past one Pallas tile."""
    A, B, _ = _coeffs((9, 1500), 5)
    x0 = np.random.RandomState(6).uniform(-1, 1, 1500).astype(np.float32)
    g = np.random.RandomState(7).uniform(-1, 1, (10, 1500)).astype(np.float32)
    xs = port.affine_scan_plain(*map(torch.from_numpy, (A, B, x0)))
    dA, dB, dx0 = (d[0] for d in port.affine_scan_bwd_batched_plain(torch.from_numpy(A)[None], xs[None],
                                                                    torch.from_numpy(g)[None]))

    def loss(A, B, x0):
        return jnp.sum(jnp.asarray(g) * affine_scan_pallas_tm(A, B, x0))

    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (A, B, x0)))
    for name, out, ref in zip("A B x0".split(), (dA, dB, dx0), refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL, err_msg=name)


def test_affine_scan_checks_shapes():
    A, B, x0 = map(torch.from_numpy, _coeffs((5, 8), 0)[:2] + (np.zeros(7, np.float32),))
    with pytest.raises(ValueError, match="shapes"):
        port.affine_scan_tm(A, B, x0)


# The batch-major kernels' plain versions (the wrappers' CPU path) at ragged
# shapes: one to seven trajectories, one step to the CVS grid's 85, one to
# eight components (CVS 5, proc 8).
RAGGED = [(Bt, T, D) for Bt in (1, 3, 7) for T in (1, 2, 85) for D in (1, 5, 8)]


@pytest.mark.parametrize("Bt,T,D", RAGGED)
def test_batched_plain_matches_jax(Bt, T, D):
    """K1's wrapper on the CPU (affine_scan_batched_plain) against
    affine_scan_pallas (interpret mode), and K1-bwd's (the batched reverse
    sweep) against its jax.vjp at the same cotangent."""
    A, B, x0 = _coeffs((Bt, T, D), 100 * Bt + 10 * T + D)
    g = np.random.RandomState(T).uniform(-1, 1, (Bt, T + 1, D)).astype(np.float32)
    ref, vjp = jax.vjp(affine_scan_pallas, *map(jnp.asarray, (A, B, x0)))
    xs = port.affine_scan_fwd(*map(torch.from_numpy, (A, B, x0)))
    assert xs.shape == (Bt, T + 1, D)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    grads = port.affine_scan_bwd(torch.from_numpy(A), xs, torch.from_numpy(g))
    for name, out, r in zip(("dA", "dB", "dx0"), grads, vjp(jnp.asarray(g))):
        assert out.shape == r.shape, name
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("Bt,T,D", [(1, 1, 1), (3, 2, 5), (7, 85, 8)])
def test_batched_plain_equals_time_major_plain(Bt, T, D):
    """The plain versions on the batch-major layout and on the time-major one
    (the transposes, as a batch of one) do the same float32 operations on the
    same elements: equal bit for bit."""
    A, B, x0 = map(torch.from_numpy, _coeffs((Bt, T, D), Bt + T))
    g = torch.from_numpy(np.random.RandomState(D).uniform(-1, 1, (Bt, T + 1, D)).astype(np.float32))
    xs = port.affine_scan_batched_plain(A, B, x0)
    assert torch.equal(xs, port.affine_scan_plain(A.transpose(0, 1), B.transpose(0, 1), x0).transpose(0, 1))
    bm = port.affine_scan_bwd_batched_plain(A, xs, g)
    tm = [d[0] for d in port.affine_scan_bwd_batched_plain(A.transpose(0, 1)[None], xs.transpose(0, 1)[None],
                                                           g.transpose(0, 1)[None])]
    for name, a, b in zip(("dA", "dB", "dx0"), bm, tm[:2]):
        assert torch.equal(a, b.transpose(0, 1)), name
    assert torch.equal(bm[2], tm[2])


@pytest.mark.parametrize("Bt,T,D", [(3, 85, 5), (1, 2, 8)])
def test_affine_scan_returns_contiguous(Bt, T, D):
    """affine_scan hands back a contiguous (Bt, T+1, D) trajectory and
    contiguous gradients, the same values as the wrappers compute."""
    A, B, x0 = (torch.from_numpy(a).requires_grad_() for a in _coeffs((Bt, T, D), 5))
    g = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (Bt, T + 1, D)).astype(np.float32))
    xs = port.affine_scan(A, B, x0)
    assert xs.shape == (Bt, T + 1, D) and xs.is_contiguous()
    grads = torch.autograd.grad(xs, (A, B, x0), g)
    assert all(gr.is_contiguous() for gr in grads)
    with torch.no_grad():
        assert torch.equal(xs, port.affine_scan_fwd(A, B, x0))
        for gr, ref in zip(grads, port.affine_scan_bwd(A, xs, g)):
            assert torch.equal(gr, ref)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no leaf needs a gradient"])
def test_affine_scan_without_gradients_calls_k1_directly(mode):
    """Where no gradient is asked for, affine_scan is K1's wrapper alone: the
    same trajectory, no autograd node, contiguous."""
    A, B, x0 = map(torch.from_numpy, _coeffs((3, 7, 5), 11))
    ref = port.affine_scan_fwd(A, B, x0)
    if mode == "no_grad":
        with torch.no_grad():
            xs = port.affine_scan(A, B, x0)
    elif mode == "inference_mode":
        with torch.inference_mode():
            xs = port.affine_scan(A, B, x0)
    else:
        xs = port.affine_scan(A, B, x0)
    assert xs.grad_fn is None and xs.is_contiguous() and torch.equal(xs, ref)


def _bad_inputs():
    """Per case: the arguments of K1's wrapper, then of K1-bwd's."""
    A, B, x0 = map(torch.from_numpy, _coeffs((3, 4, 5), 0))
    xs = port.affine_scan_batched_plain(A, B, x0)
    g = torch.ones_like(xs)
    strided = xs.transpose(0, 1).contiguous().transpose(0, 1)
    return {
        "shape": ((A, B, x0[:2]), (A, xs, g[:, 1:])),
        "other shape": ((A, B[:, 1:], x0), (A, xs[:2], g)),
        "not (Bt, T, D)": ((A[0], B[0], x0[0]), (A[0], xs[0], g[0])),
        "float64": ((A.double(), B.double(), x0.double()), (A.double(), xs.double(), g.double())),
        "not contiguous": ((A.transpose(0, 1).contiguous().transpose(0, 1), B, x0), (A, xs, strided)),
        "device mix": ((A, B.to("meta"), x0), (A, xs, g.to("meta"))),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrappers_reject_wrong_inputs(case):
    """A wrong shape, dtype, layout or device mix raises in both wrappers:
    nothing is copied, converted or sent on to the plain version."""
    fwd_args, bwd_args = _bad_inputs()[case]
    with pytest.raises(ValueError):
        port.affine_scan_fwd(*fwd_args)
    with pytest.raises(ValueError):
        port.affine_scan_bwd(*bwd_args)

"""The PyTorch port's generic ODE solvers (ode/solvers.py) against the JAX
package's (ode/solvers.py), on the CPU, and against float64 oracles.

- ``odeint`` for every method on a non-uniform and on a decreasing grid,
  against JAX's (jitted): 2e-6 abs, float32 roundoff of the same operations
  in another order;
- ``remat=True`` and ``remat='chunked'`` against the plain solve: values bit
  for bit (the same operations), gradients within 1e-5 abs + 1e-5 rel, the
  JAX package's own ``test_chunked_remat_matches_plain`` bound (its
  ``np.allclose(..., atol=1e-5)`` keeps the default rtol 1e-5): the
  recomputed graph accumulates the 23 steps' terms in another order;
- ``odeint_adaptive`` and ``odeint_adaptive_per_sample`` on a smooth forced
  linear system against JAX's (2e-5 abs: equal schedules up to float32
  roundoff near rtol 1e-6, which near float32's eps can flip an accept) and
  against ``scipy.integrate.solve_ivp`` in float64 at rtol 1e-12 (1e-5 abs:
  the solvers' rtol 1e-6 on values of order 1, plus roundoff);
- per-sample rows against the closed form (JAX's own
  ``test_per_sample_adaptive_matches_per_sample_solves``, 5e-5) and against
  their own single-row solves (1e-7: the rows never mix);
- ``solve``'s three modes, and the trip counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from structured_latent_odes_tpu.ode import solvers as jsolvers
from structured_latent_odes_tpu_torch.ode import solvers
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

B, D = 4, 3
RNG = np.random.RandomState(0)
W = (RNG.randn(D, D) * 0.4).astype(np.float32)
BIAS = (RNG.randn(D) * 0.2).astype(np.float32)
Y0 = RNG.uniform(-1, 1, (B, D)).astype(np.float32)
# the forced linear system of the adaptive tests: dy/dt = c sin(w t) - k y
K_RATE = RNG.uniform(0.2, 1.5, (B, D)).astype(np.float32)
FORCE = RNG.uniform(0, 1, (B, D)).astype(np.float32)
FREQ = RNG.uniform(0.5, 2, (B, D)).astype(np.float32)

GRIDS = {
    "nonuniform": np.cumsum(np.abs(RNG.randn(13)) * 0.2 + 0.05).astype(np.float32),
    "decreasing": np.linspace(2.0, 0.0, 11, dtype=np.float32),
}


def _f_jax(t, y):
    return jnp.tanh(y @ jnp.asarray(W).T + jnp.asarray(BIAS)) + 0.1 * jnp.sin(t) - 0.3 * y


def _f_port(t, y):
    return torch.tanh(y @ torch.from_numpy(W).T + torch.from_numpy(BIAS)) + 0.1 * torch.sin(t) - 0.3 * y


def _forced_jax(t, y):
    return jnp.asarray(FORCE) * jnp.sin(jnp.asarray(FREQ) * t) - jnp.asarray(K_RATE) * y


def _forced_port(t, y):
    return torch.from_numpy(FORCE) * torch.sin(torch.from_numpy(FREQ) * t) - torch.from_numpy(K_RATE) * y


def _forced_oracle(ts):
    """solve_ivp of the forced system in float64 at rtol 1e-12."""
    def rhs(t, y):
        return (FORCE * np.sin(FREQ * t) - K_RATE * y.reshape(B, D)).ravel()

    sol = solve_ivp(rhs, (float(ts[0]), float(ts[-1])), Y0.ravel().astype(np.float64),
                    t_eval=ts.astype(np.float64), rtol=1e-12, atol=1e-12)
    return sol.y.T.reshape(len(ts), B, D)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4", "dopri5"])
def test_odeint_matches_jax(method, grid):
    ts = GRIDS[grid]
    ref = np.asarray(jax.jit(lambda y: jsolvers.odeint(_f_jax, y, ts, method=method))(jnp.asarray(Y0)))
    out = solvers.odeint(_f_port, torch.from_numpy(Y0), ts, method=method).numpy()
    assert out.shape == ref.shape == (len(ts), B, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("remat", [True, "chunked"])
def test_odeint_remat_matches_plain(remat):
    ts = np.linspace(0.0, 2.0, 24, dtype=np.float32)  # 23 steps, not a perfect square
    Wt = torch.from_numpy(W).requires_grad_()

    def run(**kw):
        y0 = torch.from_numpy(Y0).requires_grad_()
        ys = solvers.odeint(lambda t, y: torch.tanh(y @ Wt.T) - 0.3 * y, y0, ts, method="rk4", **kw)
        return ys.detach(), torch.autograd.grad((ys ** 2).sum(), (y0, Wt))

    ys, grads = run()
    ys_r, grads_r = run(remat=remat)
    assert torch.equal(ys, ys_r)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # a chunk size of its own
    assert torch.equal(ys, solvers.odeint(lambda t, y: torch.tanh(y @ Wt.T) - 0.3 * y, torch.from_numpy(Y0), ts,
                                          method="rk4", remat="chunked", chunk_size=5).detach())


@pytest.mark.parametrize("per_sample", [False, True], ids=["batchwide", "per_sample"])
def test_odeint_adaptive_matches_jax_and_solve_ivp(per_sample):
    ts = np.linspace(0.0, 4.0, 9, dtype=np.float32)
    jfun = jsolvers.odeint_adaptive_per_sample if per_sample else jsolvers.odeint_adaptive
    pfun = solvers.odeint_adaptive_per_sample if per_sample else solvers.odeint_adaptive
    ref = np.asarray(jax.jit(lambda y: jfun(_forced_jax, y, ts))(jnp.asarray(Y0)))
    before = dict(pfun.trips)
    out = pfun(_forced_port, torch.from_numpy(Y0), ts).numpy()
    assert out.shape == ref.shape == (len(ts), B, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(out, _forced_oracle(ts), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[0], Y0)
    trips = {k: pfun.trips[k] - before.get(k, 0) for k in ("solves", "trips", "accepted")}
    assert trips["solves"] == 1 and 0 < trips["trips"] <= 8 * 4096 and trips["accepted"] > 0


def test_per_sample_adaptive_matches_per_sample_solves():
    """Rows of very different stiffness: each follows its own schedule and
    matches the closed form (JAX's own check, 5e-5) and its own single-row
    solve."""
    rates = torch.tensor([0.1, 1.0, 25.0])[:, None]
    y0 = torch.ones((3, 2))
    ts = torch.linspace(0.0, 1.0, 11)
    ys = solvers.odeint_adaptive_per_sample(lambda t, y: -rates * y, y0, ts, rtol=1e-6, atol=1e-9)
    exact = torch.exp(-rates[None] * ts[:, None, None]) * y0[None]
    torch.testing.assert_close(ys, exact, rtol=0, atol=5e-5)
    for r in range(3):
        one = solvers.odeint_adaptive_per_sample(lambda t, y: -rates[r:r + 1] * y, y0[r:r + 1], ts,
                                                 rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(ys[:, r:r + 1], one, rtol=0, atol=1e-7)
    ref = np.asarray(jax.jit(lambda y: jsolvers.odeint_adaptive_per_sample(
        lambda t, yy: -jnp.asarray(rates.numpy()) * yy, y, jnp.asarray(ts.numpy()), rtol=1e-6, atol=1e-9))(
        jnp.ones((3, 2))))
    np.testing.assert_allclose(ys.numpy(), ref, rtol=0, atol=2e-6)


def test_solve_front_door():
    ts = np.linspace(0.0, 1.0, 6, dtype=np.float32)
    y0 = torch.from_numpy(Y0)
    fixed = solvers.solve(_f_port, y0, ts, "rk4")
    torch.testing.assert_close(fixed, solvers.odeint(_f_port, y0, ts, "rk4"), rtol=0, atol=0)
    torch.testing.assert_close(solvers.solve(_f_port, y0, ts, "rk4", adjoint=True), fixed, rtol=0, atol=0)
    adaptive = solvers.solve(_f_port, y0, ts, adaptive=True)
    torch.testing.assert_close(adaptive, solvers.odeint_adaptive(_f_port, y0, ts), rtol=0, atol=0)
    torch.testing.assert_close(adaptive, fixed, rtol=0, atol=1e-4)  # rk4 at h = 0.2 against dopri5

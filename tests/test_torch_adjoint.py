"""The PyTorch port's continuous adjoints (ode/adjoint.py) against the JAX
package's (ode/adjoint.py), on the CPU.

- ``odeint_adjoint``'s gradients (to y0 and every leaf of ``args``) against
  JAX's ``odeint_adjoint`` at midpoint and rk4: 1e-5 abs + 1e-5 rel (the same
  augmented steps; float32 roundoff in another order);
- the continuous adjoint against discretize-then-optimize (autograd through
  ``odeint``) within the JAX package's own
  ``test_adjoint_gradients_match_discretize`` bounds (rtol 2e-2, atol 1e-2:
  the two differ by O(h^2));
- ``odeint_adaptive_adjoint``'s gradients against JAX's, with the batchwide
  forward and with the per-sample forward override: 2e-5 abs + 2e-5 rel.
  Each interval's augmented system is solved adaptively at rtol 1e-6, near
  float32's eps, so an accept that roundoff flips would move a schedule and
  the gradients by about the tolerance times the adjoint's size (measured:
  at most 3e-6 on gradients of about 1.8);
- over an ensemble's members, the map of ``grad`` that the stacked step
  takes (``train/svi.py::over_members``) equals each member's own gradient:
  ``torch.func.vmap`` for the fixed-step adjoint, 1e-6 rel (batched products
  round otherwise); one member at a time for the adaptive one, bit for bit
  (it takes no vmap, and ``torch.func.vmap`` of it raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.ode import adjoint as jadjoint
from structured_latent_odes_tpu.ode import solvers as jsolvers
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.models import cvs_spec
from structured_latent_odes_tpu_torch.ode import adjoint, solvers
from structured_latent_odes_tpu_torch.train.svi import over_members
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

B, D = 3, 3
RNG = np.random.RandomState(0)
W = (RNG.randn(D, D) * 0.3).astype(np.float32)
BIAS = (RNG.randn(D) * 0.1).astype(np.float32)
Y0 = RNG.uniform(-1, 1, (B, D)).astype(np.float32)
WEIGHT = RNG.uniform(-1, 1, (6, B, D)).astype(np.float32)
TS = np.linspace(0.0, 1.0, 6, dtype=np.float32)


def _f_jax(t, y, args):
    W_, b_ = args
    return jnp.tanh(y @ W_ + b_) + 0.1 * jnp.sin(t) - 0.3 * y


def _f_port(t, y, args):
    W_, b_ = args
    return torch.tanh(y @ W_ + b_) + 0.1 * torch.sin(t) - 0.3 * y


def _jax_grads(solve):
    loss = lambda y0, args: jnp.sum(jnp.asarray(WEIGHT) * solve(y0, args))  # noqa: E731
    gy, (gW, gb) = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(Y0), (jnp.asarray(W), jnp.asarray(BIAS)))
    return [np.asarray(g) for g in (gy, gW, gb)]


def _port_grads(solve, weight=WEIGHT):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in (Y0, W, BIAS)]
    ys = solve(leaves[0], (leaves[1], leaves[2]))
    return [g.numpy() for g in torch.autograd.grad((torch.from_numpy(weight) * ys).sum(), leaves)]


@pytest.mark.parametrize("method", ["midpoint", "rk4"])
def test_odeint_adjoint_gradients_match_jax(method):
    ref = _jax_grads(lambda y0, a: jadjoint.odeint_adjoint(_f_jax, y0, TS, a, method=method))
    got = _port_grads(lambda y0, a: adjoint.odeint_adjoint(_f_port, y0, TS, a, method=method))
    for name, g, r in zip(("y0", "W", "b"), got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
    # the forward is the fixed-step solve itself
    a = (torch.from_numpy(W), torch.from_numpy(BIAS))
    torch.testing.assert_close(adjoint.odeint_adjoint(_f_port, torch.from_numpy(Y0), TS, a, method=method),
                               solvers.odeint(lambda t, y: _f_port(t, y, a), torch.from_numpy(Y0), TS, method),
                               rtol=0, atol=0)


def test_adjoint_gradients_match_discretize():
    ts = np.linspace(0.0, 1.0, 21, dtype=np.float32)

    def discretize(y0, a):
        return solvers.odeint(lambda t, y: _f_port(t, y, a), y0, ts, method="midpoint")

    weight = np.random.RandomState(1).uniform(-1, 1, (21, B, D)).astype(np.float32)
    adj = _port_grads(lambda y0, a: adjoint.odeint_adjoint(_f_port, y0, ts, a, method="midpoint"), weight)
    dis = _port_grads(discretize, weight)
    for name, g, r in zip(("y0", "W", "b"), adj, dis):
        np.testing.assert_allclose(g, r, rtol=2e-2, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("per_sample", [False, True], ids=["batchwide", "per_sample"])
def test_odeint_adaptive_adjoint_gradients_match_jax(per_sample):
    jforward = pforward = None
    if per_sample:
        def jforward(y0, a):
            return jsolvers.odeint_adaptive_per_sample(lambda t, y: _f_jax(t, y, a), y0, jnp.asarray(TS))

        def pforward(y0, a):
            return solvers.odeint_adaptive_per_sample(lambda t, y: _f_port(t, y, a), y0, TS)

    ref = _jax_grads(lambda y0, a: jadjoint.odeint_adaptive_adjoint(_f_jax, y0, TS, a, forward=jforward))
    got = _port_grads(lambda y0, a: adjoint.odeint_adaptive_adjoint(_f_port, y0, TS, a, forward=pforward))
    for name, g, r in zip(("y0", "W", "b"), got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_adjoints_under_vmap_match_each_member(kind):
    """Two members with their own W: the stacked step's map of
    torch.func.grad over the members (over_members of a model on the
    matching backend) against each member's own gradient."""
    if kind == "fixed":
        def solve(y0, a):
            return adjoint.odeint_adjoint(_f_port, y0, TS, a, method="rk4")
    else:
        def solve(y0, a):
            return adjoint.odeint_adaptive_adjoint(_f_port, y0, TS, a)

    def loss(y0, Wm, bm):
        return (torch.from_numpy(WEIGHT) * solve(y0, (Wm, bm))).sum()

    Ws = torch.from_numpy(np.stack([W, W[::-1].copy() * 1.3]))
    y0 = torch.from_numpy(Y0)
    b = torch.from_numpy(BIAS)
    cfg = load_cvs_config()
    cfg.ode_backend = "adjoint" if kind == "fixed" else "adaptive"
    grad, dims = torch.func.grad(loss, argnums=(0, 1, 2)), (None, 0, None)
    grads = over_members(cvs_spec(cfg), grad, dims)(y0, Ws, b)
    if kind == "adaptive":
        with pytest.raises(RuntimeError, match="vmap"):
            torch.func.vmap(grad, in_dims=dims)(y0, Ws, b)
    for m in range(2):
        one = torch.func.grad(loss, argnums=(0, 1, 2))(y0, Ws[m], b)
        for g, r in zip(grads, one):
            if kind == "fixed":
                torch.testing.assert_close(g[m], r, rtol=1e-6, atol=1e-7)
            else:
                assert torch.equal(g[m], r)

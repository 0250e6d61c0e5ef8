"""K2 and K3 (ops/fused_step.py) in the PyTorch port: their plain versions,
which the wrappers take for CPU tensors, against the JAX package's fused
whole-solve Pallas kernels and their custom VJP (interpret mode off-TPU), for
every method they take (dopri5 at a fixed step included), on a uniform and on
a non-uniform time grid, and at widths past one warp's lanes ((H, D) =
(40, 17), which JAX pads to (40, 24)); and the one width limit the kernels
keep, a block's shared memory, refused before any build.

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
from structured_latent_odes_tpu_torch.nn.ode_model import initialize_state as port_initialize_state
from structured_latent_odes_tpu_torch.ops import fused_step as port
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

L, D, H = 15, 5, 25
B, T = 13, 21
TOL = 1e-5
# gradients: max|port - JAX| / max(max|JAX|, 1) per leaf, the JAX package's
# own measure (tests/test_fused_step.py); the weight gradients are sums over
# B*(T-1)*S terms taken in another order (measured: at most 7e-7)
GRAD_TOL = 1e-5

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
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4", "dopri5"])
def test_fused_plain_matches_jax_kernel(method, grid):
    params, z, x0 = _setup()
    ts = GRIDS[grid]
    ref = np.asarray(fused_semilinear_solve(params, jnp.asarray(z), jnp.asarray(x0), ts, method=method))
    p_port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = port.fused_semilinear_solve(p_port, torch.from_numpy(z), torch.from_numpy(x0), ts, method).numpy()
    assert out.shape == ref.shape == (B, T, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_fused_methods_are_every_tableau():
    """The kernels' METHODS (the Method enum of csrc/fused_semilinear.cuh)
    cover every tableau the JAX package's fused solve takes."""
    from structured_latent_odes_tpu.ode.tableaus import TABLEAUS

    assert set(port.METHODS) == set(TABLEAUS)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _jax_grads(params, z, ts, w, method):
    """jax.grad of sum(w * fused_semilinear_solve(params, z, x0(z), ts)) into
    every OdeModel param leaf (port layout) and z."""
    def loss(p, zz):
        x0 = initialize_state(p, zz)
        return jnp.sum(jnp.asarray(w) * fused_semilinear_solve(p, zz, x0, ts, method=method))

    gp, gz = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(z))
    leaves = _leaves(params_from_jax(jax.tree.map(np.asarray, gp), device="cpu"))
    return {name: g.numpy() for name, g in leaves}, np.asarray(gz)


def _port_grads(params, z, ts, w, method, solve):
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    leaves = _leaves(p)
    for _, t in leaves:
        t.requires_grad_()
    z_t = torch.from_numpy(z).requires_grad_()
    sol = solve(p, z_t, port_initialize_state(p, z_t), torch.from_numpy(ts), method)
    grads = torch.autograd.grad((sol * torch.from_numpy(w)).sum(), [t for _, t in leaves] + [z_t])
    return {name: g.numpy() for (name, _), g in zip(leaves, grads[:-1])}, grads[-1].numpy()


def _plain_solve(p, z, x0, ts, method):
    """The forward's plain version under torch autograd: gradients derived by
    autograd, independent of K3's hand-written sweep."""
    W = p["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(z, W[:, 1:], p["dyn_hidden"]["b"])
    return port.fused_semilinear_fwd_plain(u, W[:, 0], p["prod"]["W"], p["prod"]["b"],
                                           p["degr"]["W"], p["degr"]["b"], x0, ts, method)


def _assert_grads_close(got, ref, what):
    (gp, gz), (rp, rz) = got, ref
    assert set(gp) == set(rp)
    for name in rp:
        err = float(np.abs(gp[name] - rp[name]).max()) / max(float(np.abs(rp[name]).max()), 1.0)
        assert err < GRAD_TOL, (what, name, err)
    assert float(np.abs(gz - rz).max()) / max(float(np.abs(rz).max()), 1.0) < GRAD_TOL, (what, "z")


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4", "dopri5"])
def test_fused_gradients_match_jax(method, grid):
    """K3's plain sweep, reached through the autograd.Function of
    fused_semilinear_solve, against jax.grad of the JAX package's fused solve
    (its hand-derived Pallas backward, interpret mode); and the same
    gradients by torch autograd of K2's plain version."""
    params, z, _ = _setup()
    ts = GRIDS[grid]
    w = np.random.RandomState(2).uniform(-1, 1, (B, T, D)).astype(np.float32)
    ref = _jax_grads(params, z, ts, w, method)
    _assert_grads_close(_port_grads(params, z, ts, w, method, port.fused_semilinear_solve), ref, "K3 plain")
    _assert_grads_close(_port_grads(params, z, ts, w, method, _plain_solve), ref, "autograd of K2 plain")


def test_fused_gradients_padding_edges():
    """B not a multiple of 128 (the Pallas lane tile) and T = 2, one step, as
    tests/test_fused_step.py::test_fused_padding_edges."""
    spec = OdeModelSpec(latent_dim=L, ode_state_dim=D, ode_hidden_dim=H)
    params = ode_model_init(jax.random.key(3), spec)
    z = np.random.RandomState(4).randn(130, L).astype(np.float32)
    ts = np.arange(0.0, 2.0, dtype=np.float32)
    w = np.random.RandomState(5).uniform(-1, 1, (130, 2, D)).astype(np.float32)
    ref = _jax_grads(params, z, ts, w, "midpoint")
    _assert_grads_close(_port_grads(params, z, ts, w, "midpoint", port.fused_semilinear_solve), ref, "K3 plain")


@pytest.mark.parametrize("method", ["midpoint", "dopri5"])
def test_fused_wide_widths_match_jax(method):
    """(H, D) = (40, 17): past one warp's lanes in both widths (the kernels'
    lanes stride over hidden units and state components), values and
    gradients against the JAX fused solve, which pads to (40, 24)."""
    L_w, H_w, D_w = 6, 40, 17
    spec = OdeModelSpec(latent_dim=L_w, ode_state_dim=D_w, ode_hidden_dim=H_w)
    params = ode_model_init(jax.random.key(5), spec)
    z = np.random.RandomState(6).randn(7, L_w).astype(np.float32)
    ts = GRIDS["nonuniform"][:9]
    x0 = np.asarray(initialize_state(params, jnp.asarray(z)))
    ref = np.asarray(fused_semilinear_solve(params, jnp.asarray(z), jnp.asarray(x0), ts, method=method))
    p_port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = port.fused_semilinear_solve(p_port, torch.from_numpy(z), torch.from_numpy(x0), ts, method).numpy()
    assert out.shape == ref.shape == (7, 9, D_w)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    w = np.random.RandomState(7).uniform(-1, 1, (7, 9, D_w)).astype(np.float32)
    _assert_grads_close(_port_grads(params, z, ts, w, method, port.fused_semilinear_solve),
                        _jax_grads(params, z, ts, w, method), "K3 plain, wide")


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "dopri5"])
def test_fused_width_limit_is_shared_memory(method):
    """The kernels' one hard limit: a block's shared memory (227 KB on an
    H100). Every method takes (128, 32), in passes shorter than 128 steps
    where needed (the pass lengths of csrc/fused_semilinear.cuh's
    fwd_max_steps / bwd_max_steps); (512, 64) is refused with a ValueError
    that names the limit, before any build."""
    assert port.kernels_take(method, 128, 32) and port.kernels_take(method, 25, 8)
    assert port.kernel_max_steps(25, 8, method, backward=True) == 128  # the repo's widths: one pass of 128
    steps = {"euler": 91, "midpoint": 64, "rk4": 37, "dopri5": 27}[method]
    assert port.kernel_max_steps(128, 32, method, backward=True) == steps
    assert port.kernel_max_steps(128, 32, method, backward=False) == 128
    assert not port.kernels_take(method, 512, 64)
    with pytest.raises(ValueError, match="232448 bytes"):
        port._check_widths("fused_semilinear_fwd", 512, 64, method)
    port._check_widths("fused_semilinear_fwd", 128, 32, method)


def test_fused_plain_layout_is_time_major():
    """The wrapper returns the kernels' layout, trajectory-major (B, T, D) with
    x0 in row 0: each trajectory's T*D values contiguous, time-major within
    it (the name is from an earlier (T, D, B) layout)."""
    params, z, x0 = _setup()
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    W = p["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(torch.from_numpy(z), W[:, 1:], p["dyn_hidden"]["b"])
    out = port.fused_semilinear_fwd(
        u, W[:, 0], p["prod"]["W"], p["prod"]["b"], p["degr"]["W"], p["degr"]["b"],
        torch.from_numpy(x0), torch.from_numpy(GRIDS["uniform"]), "midpoint",
    )
    assert out.shape == (B, T, D) and out.is_contiguous()
    np.testing.assert_array_equal(out[:, 0].numpy(), x0)

"""The PyTorch port's ODE solve (ode/semilinear.py, nn/ode_model.py) against
the JAX package: stage grids and affine coefficients per method,
``solve_ode`` for each of the four semilinear backends against JAX's
``semilinear_seq`` at CVS widths (on the CPU the kernel backends take the
kernels' plain versions; tolerance 1e-5 abs), every other ported backend
(generic, adjoint, adaptive, adaptive_per_sample, semilinear_auto) against
JAX's own, values and gradients (tolerances at ``MENU_TOL``), and
``semilinear_auto``'s choice at given shapes and devices."""

import types

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
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("backend,error,match", [("semilinear_timepar", RuntimeError, "time_sharding")])
def test_unported_backends_name_their_roadmap_item(backend, error, match):
    """Every backend is ported (the last, semilinear_timepar, with ROADMAP
    A17): outside a time grid semilinear_timepar raises, naming the context
    it needs, as the JAX package's does (tests/test_timepar.py); its values
    on a grid are held in tests/test_torch_timepar.py."""
    spec = port_ode.OdeModelSpec(L, D, H, backend=backend)
    p = port_ode.ode_model_init(torch.Generator().manual_seed(0), spec)
    with pytest.raises(error, match=match):
        port_ode.solve_ode(spec, p, torch.zeros(2, L), np.arange(3, dtype=np.float32))


# The backends A14 and A19 ported, against the JAX package's solve_ode (jitted,
# tiny: B = 4, T = 9, L = 6, D = 4, H = 8, rk4 for the fixed-step ones):
# values, and the gradients of a weighted sum to z and to every param leaf.
# generic, adjoint and semilinear_auto (on the CPU the K1 path's plain
# version, as JAX off a TPU takes its associative scan) compute the same
# float32 operations in another order: values 1e-5 abs, gradients 1e-5 of
# each leaf's scale. The adaptive backends (dopri5 at rtol 1e-6) meet the
# relu's kinks, where either package's float32 solve sits up to 1.5e-4 from
# a float64 DOP853 oracle at rtol 1e-12 (measured at three seeds) and the
# two schedules part: values within 5e-4 of JAX's and of the oracle,
# gradients within 1e-3 of each leaf's scale.
MENU_TOL = {"generic": (1e-5, 1e-5), "adjoint": (1e-5, 1e-5), "semilinear_auto": (1e-5, 1e-5),
            "adaptive": (5e-4, 1e-3), "adaptive_per_sample": (5e-4, 1e-3)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _oracle(params, z, ts):
    """The decoder ODE from x0(z), in float64 by scipy's DOP853 at rtol
    1e-12: (B, T, D)."""
    from scipy.integrate import solve_ivp

    P = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    x0 = np.asarray(jax_ode.initialize_state(params, jnp.asarray(z)), np.float64)
    zz = z.astype(np.float64)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731

    def rhs(t, x):
        h = np.maximum(zz @ P["dyn_hidden"]["W"][1:] + P["dyn_hidden"]["b"] + t * P["dyn_hidden"]["W"][0], 0.0)
        a, d = sig(h @ P["prod"]["W"] + P["prod"]["b"]), sig(h @ P["degr"]["W"] + P["degr"]["b"])
        return (a - d * x.reshape(x0.shape)).ravel()

    sol = solve_ivp(rhs, (float(ts[0]), float(ts[-1])), x0.ravel(), t_eval=ts.astype(np.float64), rtol=1e-12,
                    atol=1e-12, method="DOP853")
    return sol.y.T.reshape(len(ts), *x0.shape).transpose(1, 0, 2)


@pytest.mark.parametrize("backend", sorted(MENU_TOL))
def test_solve_ode_menu_matches_jax(backend):
    Lm, Dm, Hm, Bm = 6, 4, 8, 4
    spec = jax_ode.OdeModelSpec(Lm, Dm, Hm, solver="rk4", backend=backend)
    params = jax_ode.ode_model_init(jax.random.key(0), spec)
    z = np.random.RandomState(1).randn(Bm, Lm).astype(np.float32)
    ts = np.linspace(0.0, 4.0, 9, dtype=np.float32)
    w = np.random.RandomState(5).uniform(-1, 1, (Bm, 9, Dm)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, zz: jax_ode.solve_ode(spec, p, zz, ts))(params, jnp.asarray(z)))
    gp, gz = jax.jit(jax.grad(lambda p, zz: jnp.sum(jnp.asarray(w) * jax_ode.solve_ode(spec, p, zz, ts)),
                              argnums=(0, 1)))(params, jnp.asarray(z))
    port_spec = port_ode.OdeModelSpec(Lm, Dm, Hm, solver="rk4", backend=backend)
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    leaves = _leaves(p)
    for t in leaves:
        t.requires_grad_()
    z_t = torch.from_numpy(z).requires_grad_()
    out = port_ode.solve_ode(port_spec, p, z_t, ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves + [z_t])
    vtol, gtol = MENU_TOL[backend]
    assert out.shape == ref.shape == (Bm, 9, Dm)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=vtol)
    if backend.startswith("adaptive"):
        np.testing.assert_allclose(out.detach().numpy(), _oracle(params, z, ts), rtol=0, atol=vtol)
    refs = _leaves(params_from_jax(jax.tree.map(np.asarray, gp), device="cpu")) + [torch.from_numpy(np.asarray(gz))]
    assert len(refs) == len(grads)
    for g, r in zip(grads, refs):
        assert float((g - r).abs().max()) <= gtol * max(float(r.abs().max()), 1.0)


def _z_on(device: str, B: int):
    """A stand-in for z on ``device``: the choice reads only z's device and
    shape (no card is needed to ask it about one)."""
    return types.SimpleNamespace(device=torch.device(device), ndim=2, shape=(B, L))


@pytest.mark.parametrize("case", [
    # (device, solver, (H, D), B) -> fused?
    ("cpu", "midpoint", (25, 5), 16411, False),  # the CPU: the K1 path's plain version
    ("cpu", "dopri5", (25, 8), 7, False),
    ("cuda", "midpoint", (25, 5), 100, True),  # CVS's request: the H100 showed no crossover
    ("cuda", "midpoint", (25, 5), 7, True),  # challenge's val fold
    ("cuda", "rk4", (25, 8), 36, True),  # proc's training batch
    ("cuda", "dopri5", (25, 5), 128, True),  # CVS's training batch at dopri5
    ("cuda", "midpoint", (128, 32), 128, True),  # wide, within the kernels' shared memory
    ("cuda", "midpoint", (512, 64), 128, False),  # past it: K2/K3 refuse the width
], ids=["cpu", "cpu-dopri5", "cvs-request", "challenge-val", "proc-S5", "cvs-sweep-S10", "wide", "too-wide"])
def test_auto_choice(case):
    device, solver, (Hc, Dc), B, fused = case
    spec = port_ode.OdeModelSpec(L, Dc, Hc, solver=solver, backend="semilinear_auto")
    assert port_ode.auto_picks_fused(spec, _z_on(device, B)) is fused


def test_zoo_passes_ode_tolerances():
    """zoo.py puts the config's ODE tolerances (--ode-rtol/--ode-atol) into
    the spec, with the JAX package's defaults, as its zoo.py does."""
    from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_config
    from structured_latent_odes_tpu.models import cvs_spec as jax_spec
    from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
    from structured_latent_odes_tpu_torch.models import cvs_spec

    for backend, rtol in (("semilinear_auto", None), ("adaptive", 1e-4)):
        cfgs = [jax_config(), load_cvs_config()]
        for c in cfgs:
            c.ode_backend = backend
            if rtol:
                c.ode_rtol = c.ode_atol = rtol
        ref, got = jax_spec(cfgs[0]).decoder.ode, cvs_spec(cfgs[1]).decoder.ode
        assert (got.rtol, got.atol) == (ref.rtol, ref.atol) == ((rtol, rtol) if rtol else (1e-6, 1e-8))

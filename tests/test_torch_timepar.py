"""The port's time parallelism (parallel/timepar.py, the semilinear_timepar
backend of nn/ode_model.py) on the CPU: ranks spawned from the test over
gloo, one group of four shared by the module's cases.

Held against the JAX package: the time-sharded recurrence at world 4 with
T - 1 = 21 steps (padding: 4 does not divide it) and 32; the fully
sequence-parallel solve at world 2 and 4, values and gradients to the ODE
params and z; the model backend under the ambient grid; a 2 x 2 data x time
dual step against JAX's single-device step at equal draws; and, in a
subprocess with four virtual JAX devices, the JAX package's own sharded
recurrence and solve (its blocked scan) against the port at world 4.

Tolerances: the JAX package's own for its time-parallel solve
(tests/test_timepar.py): values atol 1e-5, gradients rtol 1e-3 and atol
1e-4; the 2 x 2 step's losses rtol 1e-5 and params rtol 1e-3, atol 1e-4.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.nn import ode_model as jax_ode
from structured_latent_odes_tpu.ode.semilinear import solve_affine_recurrence
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.models import cvs_spec
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec, ode_model_init, solve_ode
from structured_latent_odes_tpu_torch.parallel import launch, timepar
from structured_latent_odes_tpu_torch.parallel.mesh import Grid
import _torch_rank_tasks as tasks
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_parallel import _split, _step_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, H = 15, 5, 25


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, threads=1, timeout_s=60) as p:
        yield p


def _recurrence_inputs(t_steps, B=6, Dim=3):
    rng = np.random.RandomState(0)
    return (rng.uniform(0.9, 1.1, (B, t_steps, Dim)).astype(np.float32),
            rng.randn(B, t_steps, Dim).astype(np.float32), rng.randn(B, Dim).astype(np.float32))


@pytest.mark.parametrize("t_steps", [21, 32], ids=["ragged", "divisible"])
def test_affine_recurrence_timepar_matches_jax(pool, t_steps):
    """At world 4 (21 steps: three padding steps on the last rank), the
    trajectory and the gradients of sum(xs**2) to A, B and x0 on every
    rank."""
    inputs = _recurrence_inputs(t_steps)

    def loss(a, b, x):
        return jnp.sum(solve_affine_recurrence(a, b, x, time_axis=1) ** 2)

    ref = jax.jit(solve_affine_recurrence, static_argnames="time_axis")(*map(jnp.asarray, inputs), time_axis=1)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, inputs))
    for out in pool.run(tasks.tp_recurrence, dict(n_model=4, inputs=inputs)):
        np.testing.assert_allclose(out["xs"], np.asarray(ref), atol=1e-5)
        for g, r in zip(out["grads"], grads):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-3, atol=1e-4)


def _ode_case(T, method="midpoint"):
    spec = jax_ode.OdeModelSpec(latent_dim=L, ode_state_dim=D, ode_hidden_dim=H, solver=method)
    params = jax_ode.ode_model_init(jax.random.key(0), spec)
    z = np.asarray(jax.random.normal(jax.random.key(1), (8, L)))
    ts = np.arange(0.0, float(T), dtype=np.float32)

    def loss(p, zz):
        sol = jax_ode.solve_ode(spec, p, zz, jnp.asarray(ts))
        return jnp.sum(sol ** 2), sol

    (_, sol), (g, dz) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(z))
    return jax.tree.map(np.asarray, params), z, ts, np.asarray(sol), jax.tree.map(np.asarray, g), np.asarray(dz)


def _assert_solve(out, sol, g, dz):
    np.testing.assert_allclose(out["sol"], sol, atol=1e-5)
    for a, b in zip(jax.tree.leaves(out["grads"]), jax.tree.leaves(g)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["dz"], dz, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("world,method", [(2, "midpoint"), (4, "midpoint"), (4, "rk4")])
def test_semilinear_timepar_matches_jax(pool, world, method):
    """solve_semilinear_timepar over 22 steps (ragged over 4 ranks): the
    heads, the RK coefficients and the local prefix (K1's plain version on
    the CPU) on each rank's chunk; values and gradients against JAX's
    single-device solve."""
    params, z, ts, sol, g, dz = _ode_case(23, method)
    outs = pool.run(tasks.tp_solve, dict(n_model=world, ranks=list(range(world)), params=params, z=z, ts=ts,
                                         direct=True, method=method))
    assert all(o is None for o in outs[world:])
    for out in outs[:world]:
        _assert_solve(out, sol, g, dz)


def test_model_backend_semilinear_timepar_matches_jax(pool):
    """solve_ode on the semilinear_timepar backend reads the grid from the
    ambient time_sharding context."""
    params, z, ts, sol, g, dz = _ode_case(17)
    for out in pool.run(tasks.tp_solve, dict(n_model=4, params=params, z=z, ts=ts, direct=False,
                                             widths=(L, D, H))):
        _assert_solve(out, sol, g, dz)


def test_data_time_grid_dual_step_matches_jax(pool):
    """A 2 x 2 (data x time) grid: the spec's backend is semilinear_timepar
    (models/zoo.py maps --time-parallel to it), each data rank holds half of
    each batch, its two time ranks share each solve's horizon. Two dual
    steps against JAX's single-device step at equal draws."""
    jc, pc = jax_cvs_config(), load_cvs_config()
    pc.time_parallel = 2
    T = 16
    jspec, pspec = jax_cvs_spec(jc, n_time=T), cvs_spec(pc, n_time=T)
    assert pspec.decoder.ode.backend == "semilinear_timepar"
    params = jax_init(jax.random.key(0), jspec)
    stack = stacked_minibatches(_split(13, 1), 8, shuffle=False)
    batches = [{k: v[i] for k, v in stack.items()} for i in range(2)]
    ts = np.arange(float(T), dtype=np.float32)
    optim = jsvi.make_dual_optimizer(jspec, params, 1e-3)
    jstep = jax.jit(jsvi.make_dual_step(jspec, jnp.asarray(ts), optim))
    jstate = jsvi.SVIState(params, optim.init(params), jax.random.key(5))
    noises, jmets = [], []
    for batch in batches:
        noises.append(_step_noise(jspec, jstate.key, batch, 1))
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jmets.append(m)
    outs = pool.run(tasks.dp_steps, dict(n_data=2, n_model=2, ranks=[0, 1, 2, 3], spec=pspec, ts=ts, lr=1e-3,
                                         params=jax.tree.map(np.asarray, params), batches=batches, noises=noises))
    for out in outs:
        for i, jm in enumerate(jmets):
            for k in ("loss_main", "loss_aux", "l1"):
                np.testing.assert_allclose(out["metrics"][i][k], float(jm[k]), rtol=1e-5, err_msg=f"{k} step {i}")
        for a, b in zip(jax.tree.leaves(out["params"]), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4)
    # the two time ranks of a data row hold one batch slice; the rows differ
    assert outs[0]["rows"] == outs[1]["rows"] and outs[2]["rows"] == outs[3]["rows"]
    assert outs[0]["rows"] != outs[2]["rows"]


_JAX_SHARDED = textwrap.dedent(
    """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from structured_latent_odes_tpu.nn import ode_model
    from structured_latent_odes_tpu.parallel.mesh import make_mesh
    from structured_latent_odes_tpu.parallel.timepar import (
        solve_affine_recurrence_timepar, solve_semilinear_timepar)
    assert len(jax.devices()) == 4, jax.devices()
    d = np.load(sys.argv[1])
    mesh = make_mesh(n_data=1, n_model=4)
    out = {}
    out["xs"] = solve_affine_recurrence_timepar(jnp.asarray(d["A"]), jnp.asarray(d["B"]), jnp.asarray(d["x0"]),
                                                mesh=mesh, time_axis="model", batch_axis=None)
    spec = ode_model.OdeModelSpec(latent_dim=15, ode_state_dim=5, ode_hidden_dim=25)
    params = ode_model.ode_model_init(jax.random.key(0), spec)
    z, ts = jnp.asarray(d["z"]), jnp.asarray(d["ts"])

    def loss(p):
        x0 = ode_model.initialize_state(p, z)
        sol = solve_semilinear_timepar(ode_model.dynamics_prod_degr, p, z, x0, ts, mesh=mesh,
                                       time_axis="model", batch_axis=None)
        return jnp.sum(sol ** 2), sol

    (_, out["sol"]), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    leaves = jax.tree.leaves(grads)
    out.update({f"g{i}": g for i, g in enumerate(leaves)})
    out.update({f"p{i}": p for i, p in enumerate(jax.tree.leaves(params))})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print(json.dumps({"n_grads": len(leaves)}))
    """
)


def test_port_matches_the_jax_sharded_run(pool, tmp_path):
    """The JAX package's own blocked scan on four virtual devices (a
    subprocess: in-process JAX has one device) against the port at world 4:
    the sharded recurrence over 21 steps and the sharded solve's values and
    parameter gradients over 22."""
    A, B, x0 = _recurrence_inputs(21)
    z = np.random.RandomState(3).randn(8, L).astype(np.float32)
    ts = np.arange(0.0, 23.0, dtype=np.float32)
    np.savez(tmp_path / "in.npz", A=A, B=B, x0=x0, z=z, ts=ts)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "SLODE_TEST_REEXEC": "1", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _JAX_SHARDED, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = json.loads(proc.stdout.strip().splitlines()[-1])["n_grads"]
    ref = np.load(tmp_path / "out.npz")
    like = jax.tree.map(np.asarray, jax_ode.ode_model_init(jax.random.key(0), jax_ode.OdeModelSpec(L, D, H)))
    params = jax.tree.unflatten(jax.tree.structure(like), [ref[f"p{i}"] for i in range(n)])
    for out in pool.run(tasks.tp_recurrence, dict(n_model=4, inputs=(A, B, x0))):
        np.testing.assert_allclose(out["xs"], ref["xs"], atol=1e-5)
    for out in pool.run(tasks.tp_solve, dict(n_model=4, params=params, z=z, ts=ts, direct=True)):
        np.testing.assert_allclose(out["sol"], ref["sol"], atol=1e-5)
        for i, g in enumerate(jax.tree.leaves(out["grads"])):
            np.testing.assert_allclose(g, ref[f"g{i}"], rtol=1e-3, atol=1e-4)


def test_time_sharding_context():
    """The ambient grid: the scoped form restores what it found, the
    unscoped form returns the previous context, and without one the backend
    raises naming the context."""
    grid = Grid(("data", "model"), (1, 1), (0,), (0, 0), {})
    assert timepar.current_time_sharding() is None
    with timepar.time_sharding(grid):
        assert timepar.get_time_sharding() == (grid, "model")
        prev = timepar.set_time_sharding(grid, time_axis="data")
        assert prev == (grid, "model") and timepar.current_time_sharding().time_axis == "data"
    assert timepar.current_time_sharding() is None
    assert timepar.clear_time_sharding() is None
    spec = OdeModelSpec(L, D, H, backend="semilinear_timepar")
    p = ode_model_init(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="time_sharding"):
        solve_ode(spec, p, torch.zeros(2, L), np.arange(3, dtype=np.float32))

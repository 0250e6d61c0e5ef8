"""What the ranks of the parallel tests run (tests/test_torch_parallel.py,
test_torch_timepar.py, test_torch_ensemble_sharded.py,
test_torch_graph_ranks.py): module-level functions of one argument, which
``parallel.launch.RankPool`` sends to every rank by name. This module
imports torch and the port only, so that a spawned rank never imports JAX;
the tests hold what the ranks return against the JAX package in the
parent.

A task whose grid covers only some of the ranks (``c["ranks"]``) returns None
on the others; every rank still calls the grid's constructor, which creates
process groups collectively."""

import contextlib

import numpy as np
import torch

from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.parallel import mesh as mesh_module
from structured_latent_odes_tpu_torch.parallel import timepar
from structured_latent_odes_tpu_torch.parallel.mesh import data_reduce, make_mesh, shard_batch, shard_stacked
from structured_latent_odes_tpu_torch.parallel.train import make_dp_eval_step, make_dp_train_step
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.train.svi import epoch_dispatch, make_eval_epoch, make_train_step
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _rows(grid, noise):
    """This rank's rows of one step's ``noise=`` draws ({"main": [...],
    "aux": [...]}, one dict of (B, d) tensors per particle)."""
    n, i = grid.size("data"), grid.index("data")

    def cut(t):
        return t[i * t.shape[0] // n:(i + 1) * t.shape[0] // n]

    return {loss: [{k: cut(v) for k, v in p.items()} for p in parts] for loss, parts in noise.items()}


@contextlib.contextmanager
def summed_trees():
    """Records every tree the data group's sum returns
    (``parallel/mesh.py::all_reduce_tree``, which ``data_reduce`` calls):
    in a dual step, the main loss's gradients and then ``[aux gradients,
    metric sums]``, as the updates take them."""
    seen, real = [], mesh_module.all_reduce_tree

    def spy(tree, group):
        seen.append(real(tree, group))
        return seen[-1]

    mesh_module.all_reduce_tree = spy
    try:
        yield seen
    finally:
        mesh_module.all_reduce_tree = real


def world() -> int:
    return torch.distributed.get_world_size()


def hang():
    """Rank 0 waits in a collective that no other rank joins."""
    if torch.distributed.get_rank() == 0:
        torch.distributed.all_reduce(torch.zeros(1))
    return torch.distributed.get_rank()


def dp_steps(c):
    """Dual steps on a ``(c["n_data"], c["n_model"])`` grid over
    ``c["ranks"]``: each rank steps on its rows of each batch with its rows
    of the step's draws. Returns the per-step metrics and the final params in
    the JAX layout, the first step's summed main and aux gradients as its
    updates took them (JAX layout), and the rows the rank held."""
    grid = make_mesh(c["n_data"], c.get("n_model", 1), ranks=c["ranks"])
    if grid is None:
        return None
    spec, ts = c["spec"], torch.as_tensor(c["ts"])
    params = params_from_jax(c["params"], "cpu")
    init_state, step, _ = make_dp_train_step(spec, ts, c["lr"], params, grid,
                                             num_particles=c.get("num_particles", 1))
    state = init_state(params, 0)
    mets, rows = [], []
    with timepar.time_sharding(grid), summed_trees() as seen:
        for batch, noise in zip(c["batches"], c["noises"]):
            b = device_batch(shard_batch(grid, batch), "cpu")
            state, m = step(state, b, noise=_rows(grid, noise))
            mets.append({k: float(v) for k, v in m.items()})
            rows.append(b["sample_id"].tolist())
    return {"metrics": mets, "params": params_to_jax(state.params), "rows": rows,
            "grads": [params_to_jax(seen[0]), params_to_jax(seen[1][0])]}


def dp_eval(c):
    """The eval epoch with the data group's sum over this rank's slices of
    the stacked split, and make_dp_eval_step on one batch; each the whole
    batches'."""
    grid = make_mesh(c["n_data"], 1, ranks=c["ranks"])
    if grid is None:
        return None
    spec, ts = c["spec"], torch.as_tensor(c["ts"])
    params = params_from_jax(c["params"], "cpu")
    stack = device_batch(shard_stacked(grid, c["stack"]), "cpu")
    stats = make_eval_epoch(spec, ts, reduce=data_reduce(grid))(params, c["seed"], stack, c["is_post"])
    batch = {k: v[0] for k, v in stack.items()}
    losses = make_dp_eval_step(spec, ts, grid)(params, c["seed"], batch)
    return {"stats": {k: (float(v) if k != "labels" else {n: float(x) for n, x in v.items()})
                      for k, v in stats.items()},
            "losses": [float(x) for x in losses]}


def dp_graph_epochs(c):
    """Two data-parallel training epochs over the world's data group, then
    the eval epoch (posterior and prior) at their params, for each dispatch
    of ``c["dispatches"]`` ('eager', and 'plain': the graph path's buffers
    with the graph's plain version): per dispatch the params, the Adam
    moments, the per-step metrics and the eval statistics; with the
    dispatch that ``svi.epoch_dispatch`` names for this group's reduce on a
    CUDA device, and the reduce's marks."""
    grid = make_mesh(world(), 1)
    spec, ts = c["spec"], torch.as_tensor(c["ts"])
    params = params_from_jax(c["params"], "cpu")
    reduce = data_reduce(grid)
    stack = device_batch(shard_stacked(grid, c["stack"]), "cpu")
    val = device_batch(shard_stacked(grid, c["val"]), "cpu")
    out = {"dispatch": epoch_dispatch(spec, "cuda", reduce), "backend": reduce.backend,
           "capturable": reduce.capturable}
    for dispatch in c["dispatches"]:
        init_state, _, train_epoch = make_train_step(spec, ts, c["lr"], params, reduce=reduce, dispatch=dispatch)
        eval_epoch = make_eval_epoch(spec, ts, reduce=reduce, dispatch=dispatch)
        state, mets = init_state(params, 3), []
        for _ in range(2):
            state, m = train_epoch(state, stack)
            mets.append({k: v.clone() for k, v in m.items()})
        stats = [eval_epoch(state.params, 7, val, is_post) for is_post in (True, False)]
        out[dispatch] = {"params": [t.clone() for t in tree_leaves(state.params)],
                         "moments": [t.clone() for t in tree_leaves([state.opt.mu, state.opt.nu])],
                         "metrics": mets, "stats": stats, "step": state.step,
                         "dispatches": (train_epoch.dispatch, eval_epoch.dispatch)}
    return out


def _time_grid(c):
    return make_mesh(1, c["n_model"], ranks=c.get("ranks"))


def tp_recurrence(c):
    """solve_affine_recurrence_timepar over ``c["n_model"]`` time ranks:
    the trajectory and the gradients of ``sum(xs**2)`` to A, B and x0."""
    grid = _time_grid(c)
    if grid is None:
        return None
    A, B, x0 = (torch.as_tensor(a).requires_grad_() for a in c["inputs"])
    xs = timepar.solve_affine_recurrence_timepar(A, B, x0, mesh=grid)
    grads = torch.autograd.grad((xs ** 2).sum(), (A, B, x0))
    return {"xs": xs.detach().numpy(), "grads": [g.numpy() for g in grads]}


def tp_solve(c):
    """solve_semilinear_timepar (``c["direct"]``) or solve_ode on the
    semilinear_timepar backend under the ambient grid, over
    ``c["n_model"]`` time ranks: the trajectory, and the gradients of
    ``sum(sol**2)`` to the ODE params (JAX layout) and to z."""
    from structured_latent_odes_tpu_torch.nn.ode_model import (
        OdeModelSpec,
        dynamics_prod_degr,
        initialize_state,
        solve_ode,
    )

    grid = _time_grid(c)
    if grid is None:
        return None
    params = params_from_jax(c["params"], "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    params = tree_unflatten(params, leaves)
    z = torch.as_tensor(c["z"]).requires_grad_()
    ts = torch.as_tensor(c["ts"])
    if c["direct"]:
        sol = timepar.solve_semilinear_timepar(dynamics_prod_degr, params, z, initialize_state(params, z), ts,
                                               method=c.get("method", "midpoint"), mesh=grid)
    else:
        L, D, H = c["widths"]
        spec = OdeModelSpec(L, D, H, solver=c.get("method", "midpoint"), backend="semilinear_timepar")
        with timepar.time_sharding(grid):
            sol = solve_ode(spec, params, z, ts)
    grads = torch.autograd.grad((sol ** 2).sum(), leaves + [z])
    return {"sol": sol.detach().numpy(), "grads": params_to_jax(tree_unflatten(params, grads[:-1])),
            "dz": grads[-1].numpy()}


def sweep_ensemble(c):
    """sweep.train_ensemble of the members ``c["seeds"]`` (prepared in every
    rank, from ``c["config"]``) over ``c["ens"]`` x ``c["data"]`` ranks:
    rank 0's stacked result, None elsewhere."""
    from structured_latent_odes_tpu_torch import sweep

    members = [sweep.prepare_member(c["dataset"], c["config"], s, "cpu") for s in c["seeds"]]
    return sweep.train_ensemble(members, ensemble_parallel=c["ens"], ensemble_data_parallel=c["data"],
                                device="cpu", dispatch=c.get("dispatch"))


def member_slices(c):
    """This rank's part of the runner's inputs on the ``(ens, data)`` grid,
    as numpy: the perms, the mask, and the members' seeds."""
    from structured_latent_odes_tpu_torch.train.ensemble import member_mesh, shard_runner_inputs
    from structured_latent_odes_tpu_torch.train.svi import AdamSlots, SVIState

    mesh = member_mesh(c["ens"], n_data=c["data"])
    S = c["perms"].shape[0]
    zeros = {"w": torch.zeros(S, 2)}
    states = SVIState(zeros, AdamSlots(zeros, zeros, {"w": 0}), list(range(S)), 0)
    out = shard_runner_inputs(mesh, states=states, eval_seeds=list(range(100, 100 + S)), train_splits=None,
                              val_stacks=None, perms=c["perms"], mask=c["mask"], aux_mult=np.ones((S, 1)),
                              shared_data=True)
    return {"seeds": out[0].seed, "eval_seeds": out[1], "perms": out[4], "mask": out[5],
            "coords": (mesh.index("ens"), mesh.index("data"))}


def tree_sum(c):
    """``mesh.all_reduce_tree`` over the world of this rank's tree
    (``c["tree"]`` times ``rank + 1``)."""
    k = torch.distributed.get_rank() + 1
    tree = {name: [leaf * k for leaf in leaves] for name, leaves in c["tree"].items()}
    return mesh_module.all_reduce_tree(tree, None)

"""What tests/test_torch_layouts_proc.py and test_torch_layouts_challenge.py
share: the port's rank layouts at the proc and challenge workloads, each
held against the port's one-device run of the same workload (which
tests/test_torch_train_workloads.py and test_torch_slode_workloads.py hold
against JAX), or against the JAX package where the CVS tests do.

Everything here runs at one intra-op thread, the parent and the ranks it
spawns alike (:func:`one_thread_for_module`): with four ranks on a few cores
more threads only wait at barriers, and since C5 a seed's weights do not
depend on the count.

Bounds, the CVS layouts' own (tests/test_torch_parallel.py,
test_torch_timepar.py, test_torch_ensemble_sharded.py): the CLIs' params
within rtol 1e-4, atol 1e-5 with data ranks alone and rtol 1e-3, atol 1e-4
where time ranks take part, and the written artifacts elementwise within the
same; the best epoch equal and its criterion (a sum over the data ranks in
another order) within rtol 1e-5; the final test ELBO, L1 and continuous label
metrics within the case's params rtol, the label accuracies equal. The eval
epoch's sums within rtol 1e-5. The time-parallel recurrence's values within
atol 1e-5 of JAX's single-device recurrence and its gradients within rtol
1e-3, atol 1e-4; the solve's values within atol 1e-5 and rtol 1e-5
(TP_VALUE_RTOL) and its gradients within 1e-5 of each leaf's largest value,
at least 1 (SOLVE_GRAD_TOL).
A sweep sharded over members alone bit for bit the unsharded sweep in member
groups of a rank's size; with data ranks too, params within rtol 2e-4, atol
1e-6, the criterion within rtol 2e-4, and Adam's moments within the params'
rtol of each leaf's largest value (at least 1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.nn import ode_model as jax_ode
from structured_latent_odes_tpu.ode.semilinear import solve_affine_recurrence
from structured_latent_odes_tpu_torch import sweep, training_challenge, training_proc
from structured_latent_odes_tpu_torch.data import proc as proc_data
from structured_latent_odes_tpu_torch.data.configs import LOADERS
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import challenge_spec, init_params, proc_spec
from structured_latent_odes_tpu_torch.parallel import launch
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
import _torch_rank_tasks as tasks

# the workloads at the repo's configs: the driver, the spec, the training
# batch (challenge's 100 clamped to its 28 train subjects), the label
# accuracies and continuous label metrics of the final test, and the label
# artifacts
WORKLOADS = {
    "proc": dict(driver=training_proc, spec=proc_spec, batch=36, accuracies=("aR", "aS"),
                 continuous=("C12", "C6"), label_files=("treatments.npy", "devices.npy")),
    "challenge": dict(driver=training_challenge, spec=challenge_spec, batch=32,
                      accuracies=("shedding", "symptoms"), continuous=(),
                      label_files=("shedding.npy", "symptoms.npy")),
}
ARGS = ["--num-epochs", "1", "--num-samples", "2", "--no-plot", "--no-eval-train", "--device", "cpu"]
DP_BOUND, TP_BOUND = (1e-4, 1e-5), (1e-3, 1e-4)
# (flags, the one-device run's backend, (rtol, atol)); the time layouts run
# semilinear_timepar (models/zoo.py maps --time-parallel to it), held
# against semilinear
CLI_CASES = [
    (["--data-parallel", "4"], "semilinear_fused", DP_BOUND),
    (["--data-parallel", "4"], "semilinear", DP_BOUND),
    (["--time-parallel", "4"], "semilinear", TP_BOUND),
    (["--data-parallel", "2", "--time-parallel", "2"], "semilinear", TP_BOUND),
]
CLI_IDS = ["data4-fused", "data4-semilinear", "time4", "data2-time2"]
CRIT_RTOL = 1e-5
EVAL_RTOL = 1e-5
# the time-parallel solve's values: tests/test_timepar.py's atol and the
# relative part that chip_smoke.py's phases 10 and 11 hold them to on the
# card (TP_VALUE_RTOL). At challenge's 141 unit steps random weights drive
# |x| to 136, where even the port's one-device solve sits 7.6e-5 (1.0e-6
# relative, about 8 ulps) from JAX's: float32 summation order, whatever the
# layout. proc's values stay below 8.
TP_VALUE_ATOL, TP_VALUE_RTOL = 1e-5, 1e-5
# the solve's gradients (of sum(sol**2)), within this much of each leaf's
# largest value (at least 1), the port's bound for gradients that sum many
# terms (the data-parallel step's, K3's weight gradients'): at these
# horizons the leaves reach 1e8 (challenge) and 9e4 (proc) and some elements
# cancel to tens, so tests/test_timepar.py's elementwise rtol 1e-3, atol
# 1e-4 fails by 3-4x between the port's one-rank solve and JAX's, whatever
# the layout; against each leaf's largest they sit 1.5e-6 apart.
SOLVE_GRAD_TOL = 1e-5
SWEEP_SEEDS = "12..15"
ENS_DATA_BOUND = (2e-4, 1e-6, 2e-4)  # params rtol, atol; criterion rtol


@pytest.fixture(scope="module")
def one_thread_for_module():
    """One intra-op thread for the module's shared fixtures (set up before
    the autouse per-test one) and for the ranks the CLIs spawn at the
    parent's count; the caller's count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rank_pool():
    """Four gloo ranks at one thread each, every collective time-limited."""
    return launch.RankPool(4, threads=1, timeout_s=120)


def load_workload(wl: str):
    """The workload's config, its train and val folds (model layout) and
    its time grid, as its training driver builds them."""
    config = LOADERS[wl]()
    config.data_seed = None
    if wl == "proc":
        splits, times = proc_data.build_splits(config)
    else:
        splits, times = training_challenge.build_splits(config)
    return config, splits, np.asarray(times, dtype=np.float32)


def run_cli(wl: str, root, flags):
    return WORKLOADS[wl]["driver"].main(["--results-root", str(root)] + ARGS + list(flags))


def one_device_runs(wl: str, tmp_path_factory):
    """The one-device CLI run of ``wl`` per backend, each run once, when a
    case first asks for it."""
    runs = {}

    def get(backend: str):
        if backend not in runs:
            runs[backend] = run_cli(wl, tmp_path_factory.mktemp(f"{wl}-{backend}"), ["--ode-backend", backend])
        return runs[backend]

    return get


class Margins:
    """The worst error over its tolerance of each quantity a check holds:
    ``hold`` fails past 1. ``worst`` is what scripts/layout_margins.py
    prints."""

    def __init__(self):
        self.worst = {}

    def _record(self, name: str, ratio: float) -> None:
        self.worst[name] = max(self.worst.get(name, 0.0), ratio)
        assert ratio <= 1.0, (name, ratio)

    def hold(self, name: str, got, ref, rtol: float = 0.0, atol: float = 0.0) -> None:
        """Elementwise ``|got - ref| <= atol + rtol*|ref|`` (0 and 0: equal)."""
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        diff, tol = np.abs(got - ref), atol + rtol * np.abs(ref)
        with np.errstate(divide="ignore", invalid="ignore"):  # a difference over a zero tolerance: inf
            self._record(name, float(np.max(np.where(diff == 0, 0.0, diff / tol), initial=0.0)))

    def hold_leaf(self, name: str, got, ref, tol: float) -> None:
        """``max|got - ref| <= tol * max(max|ref|, 1)``: against the leaf's
        largest value."""
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        self._record(name, float(np.abs(got - ref).max()) / (tol * max(float(np.abs(ref).max()), 1.0)))


def assert_cli_matches(wl: str, out, ref, bound) -> dict:
    """A CLI run on ranks (rank 0's result) against the one-device run."""
    rtol, atol = bound
    w, m = WORKLOADS[wl], Margins()
    for a, b in zip(tree_leaves(out["state"].params) + tree_leaves(out["best"]["params"]),
                    tree_leaves(ref["state"].params) + tree_leaves(ref["best"]["params"])):
        m.hold("params", a.numpy(), b.numpy(), rtol, atol)
    assert out["best"]["epoch"] == ref["best"]["epoch"]
    m.hold("criterion", out["best"]["criterion"], ref["best"]["criterion"], CRIT_RTOL)
    for name in ("mu_25_post.npy", "mu_50_post.npy", "mu_75_post.npy") + w["label_files"]:
        m.hold("artifacts", np.load(os.path.join(out["out_dir"], name)), np.load(os.path.join(ref["out_dir"], name)),
               rtol, atol)
    for tag in ("test_post", "test_prior"):
        got, want = out[tag], ref[tag]
        m.hold("test elbo", got.elbo, want.elbo, rtol)
        m.hold("test l1", got.l1, want.l1, rtol)
        for name in w["continuous"]:
            m.hold("test continuous labels", got.label_metrics[name], want.label_metrics[name], rtol)
        for name in w["accuracies"]:
            assert got.label_metrics[name] == want.label_metrics[name], (tag, name)
    return m.worst


def assert_eval_matches(pool, wl: str, data, is_post: bool) -> dict:
    """The eval epoch at world 4 over the val fold stacked at the training
    batch (each batch's sums over the data ranks, its ratios from the sums)
    against the one-device eval epoch, and make_dp_eval_step's losses of
    the first batch against the one-device losses."""
    config, splits, times = data
    spec = WORKLOADS[wl]["spec"](config, n_time=len(times))
    params = init_params(spec, 0, device="cpu")
    stack = stacked_minibatches(splits["val"], WORKLOADS[wl]["batch"], shuffle=False)
    outs = pool.run(tasks.dp_eval, dict(n_data=4, ranks=[0, 1, 2, 3], spec=spec, ts=times,
                                        params=params_to_jax(params), stack=stack, seed=9, is_post=is_post))
    ts = torch.as_tensor(times)
    one = svi.make_eval_epoch(spec, ts)(params, 9, device_batch(stack, "cpu"), is_post)
    losses = svi.make_eval_fns(spec, ts)[0](params, 9, device_batch({k: v[0] for k, v in stack.items()}, "cpu"))
    assert sorted(one["labels"]) == sorted(label.name for label in spec.labels)
    m = Margins()
    for out in outs:
        for k in ("elbo_main", "elbo_aux", "l1", "n"):
            m.hold(k, out["stats"][k], float(one[k]), EVAL_RTOL)
        assert sorted(out["stats"]["labels"]) == sorted(one["labels"])
        for name, v in one["labels"].items():
            m.hold(f"label {name}", out["stats"]["labels"][name], float(v), EVAL_RTOL)
        m.hold("dp eval step losses", out["losses"], [float(x) for x in losses], EVAL_RTOL)
    return m.worst


def padding_rows_by_rank(wl: str, data):
    """Per batch of the stacked val fold, the real rows each of four data
    ranks holds."""
    stack = stacked_minibatches(data[1]["val"], WORKLOADS[wl]["batch"], shuffle=False)
    return [[int(m.sum()) for m in np.split(mask, 4)] for mask in stack["mask"]]


def recurrence_inputs(B: int, steps: int, D: int):
    """A_t a per-step decay in [0.9, 1], as the ODE's degradation makes the
    model's: tests/test_timepar.py's [0.9, 1.1] grows over 141 steps to
    |x| = 60, where float32's ulp is 3.8e-6 and any other summation order
    (the chunked prefix's) sits 5 ulps off, past an atol of 1e-5 that then
    measures roundoff, not the layout. Here |x| stays below 15."""
    rng = np.random.RandomState(0)
    return (rng.uniform(0.9, 1.0, (B, steps, D)).astype(np.float32),
            rng.randn(B, steps, D).astype(np.float32), rng.randn(B, D).astype(np.float32))


def assert_recurrence_timepar_matches_jax(pool, wl: str, data, world: int) -> None:
    """solve_affine_recurrence_timepar over ``world`` time ranks at the
    workload's horizon and ODE state width against JAX's single-device
    recurrence: the trajectory and the gradients of sum(xs**2) to A, B and
    x0 on every rank."""
    config, _, times = data
    inputs = recurrence_inputs(WORKLOADS[wl]["batch"], len(times) - 1, config.ode_state_dim)

    def loss(a, b, x):
        return jnp.sum(solve_affine_recurrence(a, b, x, time_axis=1) ** 2)

    ref = jax.jit(solve_affine_recurrence, static_argnames="time_axis")(*map(jnp.asarray, inputs), time_axis=1)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, inputs))
    outs = pool.run(tasks.tp_recurrence, dict(n_model=world, ranks=list(range(world)), inputs=inputs))
    assert all(o is None for o in outs[world:])
    m = Margins()
    for out in outs[:world]:
        m.hold("values", out["xs"], ref, atol=TP_VALUE_ATOL)
        for g, r in zip(out["grads"], grads):
            m.hold("gradients", g, r, *TP_BOUND)
    return m.worst


def assert_semilinear_timepar_matches_jax(pool, wl: str, data, world: int) -> None:
    """solve_semilinear_timepar over ``world`` time ranks at the workload's
    widths (latent, ODE state, hidden), time grid and training batch: values
    and the gradients of sum(sol**2) to the ODE params and z (SOLVE_GRAD_TOL)
    against JAX's single-device solve."""
    config, _, times = data
    spec = WORKLOADS[wl]["spec"](config, n_time=len(times)).decoder.ode
    jspec = jax_ode.OdeModelSpec(latent_dim=spec.latent_dim, ode_state_dim=spec.ode_state_dim,
                                 ode_hidden_dim=spec.ode_hidden_dim, solver=spec.solver)
    params = jax_ode.ode_model_init(jax.random.key(0), jspec)
    z = np.asarray(jax.random.normal(jax.random.key(1), (WORKLOADS[wl]["batch"], spec.latent_dim)))

    def loss(p, zz):
        sol = jax_ode.solve_ode(jspec, p, zz, jnp.asarray(times))
        return jnp.sum(sol ** 2), sol

    (_, sol), (g, dz) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(z))
    outs = pool.run(tasks.tp_solve, dict(n_model=world, ranks=list(range(world)), z=z, ts=times, direct=True,
                                         params=jax.tree.map(np.asarray, params), method=spec.solver))
    assert all(o is None for o in outs[world:])
    m = Margins()
    for out in outs[:world]:
        m.hold("values", out["sol"], sol, TP_VALUE_RTOL, TP_VALUE_ATOL)
        for a, b in zip(jax.tree.leaves(out["grads"]) + [out["dz"]], jax.tree.leaves(g) + [dz]):
            m.hold_leaf("gradients", a, b, SOLVE_GRAD_TOL)
    return m.worst


def run_sweep(wl: str, root, flags):
    """sweep.run over SWEEP_SEEDS on semilinear_fused, one epoch beyond
    epoch 0 (its ranks spawned by the sweep where the flags ask for them):
    rank 0's run."""
    return sweep.run(sweep.parse_args([wl, "--device", "cpu", "--seeds", SWEEP_SEEDS, "--num-epochs", "1",
                                       "--ode-backend", "semilinear_fused", "--num-samples", "2",
                                       "--results-root", str(root)] + list(flags)))


def _result_leaves(r):
    return tree_leaves([r.best_params, r.state.params]), tree_leaves([r.state.opt.mu, r.state.opt.nu])


def assert_sweep_bit_equal(got, ref) -> dict:
    """A member-sharded sweep's stacked result bit for bit the grouped one:
    params, best params, Adam's moments, criterion, best epochs, history."""
    m = Margins()
    for a, b in zip(sum(_result_leaves(got.result), []), sum(_result_leaves(ref.result), [])):
        m.hold("params and moments", a.numpy(), b.numpy())
    m.hold("criterion", got.result.best_crit, ref.result.best_crit)
    np.testing.assert_array_equal(got.result.best_epoch, ref.result.best_epoch)
    for k in ref.result.history:
        m.hold("history", got.result.history[k], ref.result.history[k])
    assert [x["seed"] for x in got.summary["members"]] == sweep.parse_seeds(SWEEP_SEEDS)
    return m.worst


def assert_sweep_close(got, ref, bound=ENS_DATA_BOUND) -> dict:
    """A sweep sharded over members and minibatches against the grouped one:
    best epochs equal, the criterion and the history within the criterion's
    rtol, params within rtol and atol, Adam's moments within the params'
    rtol of each leaf's largest value (at least 1)."""
    rtol, atol, crit_rtol = bound
    g, r, m = got.result, ref.result, Margins()
    np.testing.assert_array_equal(g.best_epoch, r.best_epoch)
    m.hold("criterion", g.best_crit, r.best_crit, crit_rtol)
    for k in r.history:
        m.hold("history", g.history[k], r.history[k], crit_rtol)
    (gp, gm), (rp, rm) = _result_leaves(g), _result_leaves(r)
    for a, b in zip(gp, rp):
        m.hold("params", a.numpy(), b.numpy(), rtol, atol)
    for a, b in zip(gm, rm):
        m.hold_leaf("moments", a.numpy(), b.numpy(), rtol)
    assert [x["seed"] for x in got.summary["members"]] == sweep.parse_seeds(SWEEP_SEEDS)
    return m.worst

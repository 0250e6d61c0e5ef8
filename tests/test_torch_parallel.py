"""The port's data parallelism (parallel/mesh.py, parallel/train.py,
parallel/launch.py, train/backend.py) on the CPU: ranks spawned from the
test over gloo, one group of four shared by the module's cases.

The data-parallel dual step at world 2 and 4 (and two particles at world 2)
against the JAX package's ``make_dp_train_step`` on a one-device mesh and its
``make_train_step``, with the JAX draws handed to the port through
``noise=`` (each rank takes its rows); the data-parallel eval epoch and eval
step against one device; the drivers with ``--data-parallel 2`` (spawned and
under torchrun) against their one-device runs; the slicing helpers; the
guards; and a collective that no peer joins failing its call.

Tolerances: the JAX package's own for its data-parallel step
(tests/test_parallel.py): loss rtol 1e-5, params rtol 1e-4 and atol 1e-5;
the L1 metric, a ratio of sums, rtol 1e-5. The summed gradients of the
first step, as its two updates took them (Adam's update hardly changes
when every gradient is scaled alike, so the params alone would not show a
mean taken for a sum), within 1e-5 of each leaf's largest, at least 1
(tests/test_torch_slode_train.py's gradient bound). The eval statistics are sums in
another order: rtol 1e-5. The ranks' params after a step are bit for bit
equal: each applies the same summed update.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import elbo_aux as jax_elbo_aux
from structured_latent_odes_tpu.models import elbo_main as jax_elbo_main
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.parallel.mesh import make_mesh as jax_make_mesh
from structured_latent_odes_tpu.parallel.mesh import shard_batch as jax_shard_batch
from structured_latent_odes_tpu.parallel.train import make_dp_train_step as jax_make_dp_train_step
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models import cvs_spec
from structured_latent_odes_tpu_torch.parallel import launch
from structured_latent_odes_tpu_torch.parallel.mesh import (Grid, all_reduce_tree, pad_batch_to_multiple, shard_batch,
                                                            shard_stacked)
from structured_latent_odes_tpu_torch.train import backend, svi
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.utils.config import Config
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
import _torch_rank_tasks as tasks
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

T = 16
LR = 1e-3
GRAD_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, threads=1, timeout_s=60) as p:
        yield p


def _split(n, seed):
    r = np.random.RandomState(seed)
    return {
        "observations": r.rand(n, 3, T).astype(np.float32),
        "iext": (r.rand(n, 1) > 0.5).astype(np.float32),
        "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32),
    }


def _eps(key, sids, dim):
    zeros = jnp.zeros((sids.shape[0], dim))
    return torch.tensor(np.asarray(jax_sample(key, sids, zeros, jnp.ones_like(zeros))))


def _step_noise(spec, key, batch, particles):
    """The draws of one JAX dual step from ``state.key`` (the key splits of
    ``train/svi.py::make_dual_step``), per particle, per site."""
    _, k1, k2 = jax.random.split(key, 3)
    sids = jnp.asarray(batch["sample_id"])

    def sites(k, blocks):
        out = {}
        for block in blocks:
            k, sub = jax.random.split(k)
            out[block.name] = _eps(sub, sids, block.dim)
        return out

    def per_particle(k):
        return list(jax.random.split(k, particles)) if particles > 1 else [k]

    return {"main": [sites(k, spec.blocks) for k in per_particle(k1)],
            "aux": [sites(k, spec.labeled_blocks) for k in per_particle(k2)]}


def _specs():
    jc, pc = jax_cvs_config(), load_cvs_config()
    return jax_cvs_spec(jc, n_time=T), cvs_spec(pc, n_time=T)


def _jax_first_grads(jspec, params, optim, key, batch, ts, particles):
    """The first JAX dual step's gradients as its updates take them: the
    main loss's at the params, the aux loss's after the main update (the
    losses of ``train/svi.py::make_dual_step``)."""
    _, k1, k2 = jax.random.split(key, 3)

    def mean_over(k, fn):
        if particles == 1:
            return fn(k)
        return jax.tree.map(jnp.mean, jax.vmap(fn)(jax.random.split(k, particles)))

    main = jax.jit(jax.grad(lambda p: mean_over(k1, lambda k: jax_elbo_main(jspec, p, k, batch, ts))[0]))(params)
    params, _ = optim.update_main(main, optim.init(params), params, 1.0)
    return [main, jax.jit(jax.grad(lambda p: mean_over(k2, lambda k: jax_elbo_aux(jspec, p, k, batch))))(params)]


@functools.lru_cache(maxsize=None)
def _jax_steps(particles):
    """Two JAX dual steps from one key on two batches (the second padded and
    masked), by ``make_train_step``'s step and by ``make_dp_train_step`` on a
    one-device mesh: the batches, each step's draws, both runs' metrics and
    final params, and the first step's gradients."""
    jspec, _ = _specs()
    params = jax_init(jax.random.key(0), jspec)
    stack = stacked_minibatches(_split(13, 1), 8, shuffle=False)
    batches = [{k: v[i] for k, v in stack.items()} for i in range(2)]
    ts = jnp.arange(float(T))
    optim = jsvi.make_dual_optimizer(jspec, params, LR)
    jstep = jax.jit(jsvi.make_dual_step(jspec, ts, optim, particles))
    jstate = jsvi.SVIState(params, optim.init(params), jax.random.key(5))
    grads = _jax_first_grads(jspec, params, optim, jstate.key, {k: jnp.asarray(v) for k, v in batches[0].items()},
                             ts, particles)
    mesh = jax_make_mesh(n_data=1, devices=jax.devices()[:1])
    init_dp, dp_step, _ = jax_make_dp_train_step(jspec, ts, LR, params, mesh, num_particles=particles)
    dstate = init_dp(params, jax.random.key(5))
    noises, jmets, dmets = [], [], []
    for batch in batches:
        noises.append(_step_noise(jspec, jstate.key, batch, particles))
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jmets.append(m)
        dstate, m = dp_step(dstate, jax_shard_batch(mesh, batch))
        dmets.append(m)
    return params, batches, noises, jmets, dmets, jstate.params, dstate.params, grads


def _one_device_first_grads(pspec, params, batch, noise, particles):
    """The port's one-device first dual step's gradients as its updates take
    them, through a ``reduce`` that records and returns what it is given."""
    seen = []
    init_state, step, _ = svi.make_train_step(pspec, torch.arange(float(T)), LR, params, num_particles=particles,
                                              reduce=lambda tree: seen.append(tree) or tree)
    step(init_state(params, 0), device_batch(batch, "cpu"), noise=noise)
    return [params_to_jax(seen[0]), params_to_jax(seen[1][0])]


def _assert_grads_close(got, ref, what):
    for i, (g, r) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(ref))):
        r = np.asarray(r)
        err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1.0)
        assert err < GRAD_TOL, (what, i, r.shape, err)


@pytest.mark.parametrize("world,particles", [(2, 1), (4, 1), (2, 2)], ids=["world2", "world4", "world2-particles2"])
def test_dp_steps_match_jax(pool, world, particles):
    """Two dual steps (the second batch padded and masked: at world 4 one
    rank holds padding rows only) against JAX's one-device-mesh DP step and
    its single-device step; the first step's summed gradients against the
    JAX step's and the port's one-device step's."""
    _, pspec = _specs()
    params, batches, noises, jmets, dmets, jparams, dparams, jgrads = _jax_steps(particles)
    ts = np.arange(float(T), dtype=np.float32)
    outs = pool.run(tasks.dp_steps, dict(n_data=world, ranks=list(range(world)), spec=pspec, ts=ts, lr=LR,
                                         params=jax.tree.map(np.asarray, params), batches=batches, noises=noises,
                                         num_particles=particles))
    assert all(o is None for o in outs[world:])  # the ranks outside the grid
    outs = outs[:world]
    one = _one_device_first_grads(pspec, params_from_jax(params, "cpu"), batches[0], noises[0], particles)
    for r, out in enumerate(outs):
        assert out["rows"] == [batch["sample_id"][r * 8 // world:(r + 1) * 8 // world].tolist() for batch in batches]
        for i, (jm, dm) in enumerate(zip(jmets, dmets)):
            for k in ("loss_main", "loss_aux", "l1"):
                np.testing.assert_allclose(out["metrics"][i][k], float(jm[k]), rtol=1e-5, err_msg=f"{k} step {i}")
                np.testing.assert_allclose(out["metrics"][i][k], float(dm[k]), rtol=1e-5, err_msg=f"{k} step {i}")
        for ref in (jparams, dparams):
            for a, b in zip(jax.tree.leaves(out["params"]), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for name, got, jg, og in zip(("main", "aux"), out["grads"], jgrads, one):
            _assert_grads_close(got, jg, f"rank {r} {name} vs JAX")
            _assert_grads_close(got, og, f"rank {r} {name} vs one device")
    for out in outs[1:]:  # every rank applied the same update
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(out["params"]),
                                                        jax.tree.leaves(outs[0]["params"])))


@pytest.mark.parametrize("is_post", [True, False], ids=["posterior", "prior"])
def test_dp_eval_matches_one_device(pool, is_post):
    """The eval epoch with the data group's sum (the ``reduce`` that
    train/backend.py's make_training_backend returns) at world 4 over the slices of a stacked split (the last
    batch mostly padding) is the one-device eval epoch: each batch's ratios
    are taken from the summed numerators and counts; and
    make_dp_eval_step's losses are the whole batch's."""
    jspec, pspec = _specs()
    params = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jspec))
    stack = stacked_minibatches(_split(10, 5), 8, shuffle=False)
    ts = np.arange(float(T), dtype=np.float32)
    outs = pool.run(tasks.dp_eval, dict(n_data=4, ranks=[0, 1, 2, 3], spec=pspec, ts=ts, params=params,
                                        stack=stack, seed=9, is_post=is_post))
    p = params_from_jax(params, "cpu")
    one = svi.make_eval_epoch(pspec, torch.as_tensor(ts))(p, 9, device_batch(stack, "cpu"), is_post)
    losses = svi.make_eval_fns(pspec, torch.as_tensor(ts))[0](p, 9, device_batch({k: v[0] for k, v in stack.items()},
                                                                                  "cpu"))
    for out in outs:
        for k in ("elbo_main", "elbo_aux", "l1", "n"):
            np.testing.assert_allclose(out["stats"][k], float(one[k]), rtol=1e-5, err_msg=k)
        for name, v in one["labels"].items():
            np.testing.assert_allclose(out["stats"]["labels"][name], float(v), rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(out["losses"], [float(x) for x in losses], rtol=1e-5)


def test_tree_sum_over_four_ranks_is_exact(pool):
    """mesh.all_reduce_tree at world 4 sums a float32 tree (the training
    paths' trees) in one buffer, exactly where the terms are dyadic."""
    tree = {"w": [torch.arange(6, dtype=torch.float32).reshape(2, 3) / 8, torch.tensor(0.375)],
            "b": [torch.full((3,), 0.25)]}
    factor = sum(range(1, 5))  # ranks 0..3 hold the tree times 1..4
    for out in pool.run(tasks.tree_sum, {"tree": tree}):
        for got, leaf in zip(tree_leaves(out), tree_leaves(tree)):
            assert got.dtype == leaf.dtype and torch.equal(got, leaf * factor), (got, leaf)


def test_tree_sum_refuses_mixed_dtypes():
    """A tree whose leaves differ in dtype would be promoted in the one
    buffer (an int64 count past 2^24 rounded): all_reduce_tree raises before
    any collective, so no group is needed to see it."""
    tree = {"loss": torch.tensor(1.5), "count": torch.tensor(2 ** 40 + 3, dtype=torch.int64)}
    with pytest.raises(TypeError, match="one dtype"):
        all_reduce_tree(tree, None)


def _grid(n, i, axis="data"):
    """Rank i's view of a 1-D grid of n ranks along ``axis`` (no groups: the
    slicing helpers read the shape and coordinates only)."""
    names = (axis, "model") if axis == "data" else ("ens", axis)
    shape, coords = ((n, 1), (i, 0)) if axis == "data" else ((1, n), (0, i))
    return Grid(names, shape, tuple(range(n)), coords, {})


def test_shard_batch_gives_each_rank_its_rows_and_global_ids():
    """A batch without sample_id gets the global row positions before the
    slice (numpy and tensors alike), so a rank draws what one device draws
    for its rows; scalars pass whole; the rows must divide."""
    b = {"observations": np.arange(8 * 2, dtype=np.float32).reshape(8, 2), "mask": np.ones(8, np.float32),
         "aux_mult": np.float32(3.0)}
    for i in range(4):
        out = shard_batch(_grid(4, i), b)
        assert out["observations"].tolist() == b["observations"][2 * i:2 * i + 2].tolist()
        assert out["sample_id"].tolist() == [2 * i, 2 * i + 1] and out["aux_mult"] == 3.0
        t = shard_batch(_grid(4, i), {k: torch.as_tensor(v) for k, v in b.items()})
        assert t["sample_id"].tolist() == [2 * i, 2 * i + 1] and t["observations"].is_contiguous()
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(_grid(3, 0), b)


def test_shard_stacked_slices_the_batch_axis():
    stack = stacked_minibatches(_split(13, 1), 8, shuffle=True, rng=np.random.RandomState(0))
    stack["aux_mult"] = np.full((2,), 5.0, np.float32)
    parts = [shard_stacked(_grid(2, i), stack) for i in range(2)]
    for k in ("observations", "mask", "sample_id"):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts], axis=1), stack[k])
        assert all(p[k].flags.c_contiguous for p in parts)
    assert all(p["aux_mult"] is stack["aux_mult"] for p in parts)


def test_pad_batch_to_multiple():
    b = {k: v for k, v in _split(13, 0).items()}
    out = pad_batch_to_multiple(b, 8)
    assert out["observations"].shape[0] == 16 and out["mask"].sum() == 13


def test_parallel_guards_raise_before_any_work(monkeypatch):
    """The JAX package's messages: more ranks than cards (on CUDA, one rank
    a card), a minibatch that does not divide over the data ranks, and a
    backend built outside a group of the right size."""
    cfg = Config(data_parallel=2, time_parallel=1, mini_batch_size=16)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--data-parallel 2 x --time-parallel 1 > 1 available devices"):
        backend.parallel_extent(cfg, "cuda")
    assert backend.parallel_extent(cfg, "cpu") == (2, 1)
    with pytest.raises(ValueError, match="mini_batch_size 16 not divisible by --data-parallel 3"):
        backend.parallel_extent(Config(data_parallel=3, mini_batch_size=16), "cpu")
    _, pspec = _specs()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        backend.make_training_backend(pspec, torch.arange(float(T)), Config(cfg, learning_rate=LR), None)


def test_a_collective_no_peer_joins_fails_its_call():
    """Rank 0 waits in an all_reduce that rank 1 never joins: the
    collective's time limit fails the call in the parent, and the pool
    stops its ranks."""
    p = launch.RankPool(2, threads=1, timeout_s=3)
    try:
        assert p.run(tasks.world) == [2, 2]
        with pytest.raises(RuntimeError, match=r"failed on ranks \[0\]"):
            p.run(tasks.hang)
        with pytest.raises(RuntimeError, match="closed"):
            p.run(tasks.world)
    finally:
        p.close()


def _assert_npz_close(path, ref_path, rtol, atol):
    with np.load(path) as got, np.load(ref_path) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            if ref[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def cvs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


ARGS = ["--num-epochs", "1", "--mini-batch-size", "8", "--no-plot", "--device", "cpu"]


@pytest.fixture(scope="module")
def one_device_run(cvs_dir, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("one"))
    return training_cvs.main(["--data-path", cvs_dir, "--results-root", root] + ARGS)


@pytest.mark.parametrize("flags,rtol,atol", [(["--data-parallel", "2"], 1e-4, 1e-5),
                                             (["--time-parallel", "2"], 1e-3, 1e-4),
                                             (["--data-parallel", "2", "--time-parallel", "2"], 1e-3, 1e-4)],
                         ids=["data2", "time2", "data2-time2"])
def test_cli_on_ranks_matches_one_device(cvs_dir, one_device_run, tmp_path, flags, rtol, atol):
    """training_cvs.main spawns the ranks (gloo on the CPU) and returns rank
    0's run: final and best params within the DP (JAX tests/test_parallel.py)
    or time-parallel (tests/test_timepar.py) bounds of the one-device run,
    the same best epoch, rank 0's artifacts written, and the epoch and test
    statistics global."""
    out = training_cvs.main(["--data-path", cvs_dir, "--results-root", str(tmp_path)] + ARGS + flags)
    ref = one_device_run
    for a, b in zip(tree_leaves(out["state"].params) + tree_leaves(out["best"]["params"]),
                    tree_leaves(ref["state"].params) + tree_leaves(ref["best"]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    assert out["best"]["epoch"] == ref["best"]["epoch"]
    np.testing.assert_allclose(out["best"]["criterion"], ref["best"]["criterion"], rtol=1e-5)
    np.testing.assert_allclose(out["test_post"].elbo, ref["test_post"].elbo, rtol=1e-5)
    np.testing.assert_allclose(out["test_post"].l1, ref["test_post"].l1, rtol=1e-4)
    _assert_npz_close(os.path.join(out["out_dir"], "best_model.npz"),
                      os.path.join(ref["out_dir"], "best_model.npz"), rtol, atol)
    assert os.path.exists(os.path.join(out["out_dir"], "mu_50_post.npy"))
    assert os.path.getsize(os.path.join(out["out_dir"], "model.log")) > 0


def test_torchrun_joins_its_group(cvs_dir, one_device_run, tmp_path):
    """Under torchrun (two processes over gloo) the driver joins torchrun's
    group instead of spawning, and rank 0 writes a best_model.npz within the
    DP bounds of the one-device run's."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
           str(launch._free_port()), "-m", "structured_latent_odes_tpu_torch.training_cvs", "--data-path", cvs_dir,
           "--results-root", str(tmp_path), "--data-parallel", "2"] + ARGS
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _assert_npz_close(os.path.join(tmp_path, "results_Mechanistic", "best_model.npz"),
                      os.path.join(one_device_run["out_dir"], "best_model.npz"), 1e-4, 1e-5)

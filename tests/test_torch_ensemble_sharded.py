"""The port's member parallelism (train/ensemble.py's member_mesh,
shard_member_inputs, shard_runner_inputs and gather_results, and sweep.py's
--ensemble-parallel and --ensemble-data-parallel) on the CPU: ranks spawned
from the test over gloo, one group of four shared by the module's cases,
and the sweep CLI spawning its own.

Each rank runs its members with the stacked runner, so a member-sharded run
is held against the unsharded run of the same members in groups of a rank's
size (``member_group``; at S/n members a stack a member's numbers are the
same computation): with the members alone sharded, the JAX package's
member-sharded bound (tests/test_ensemble.py), params rtol 1e-5 and atol
1e-7, criterion rtol 1e-6, best epochs equal; with each minibatch also
summed over data ranks in another order, its ens x data bound, params rtol
2e-4 and atol 1e-6, criterion rtol 2e-4. Adam's moments scale with the
summed gradients, which the params alone would not show: they are held
within the params' rtol of each leaf's largest value (at least 1), since
they are sums of gradients in the hundreds. Each sharded run's params are also held against the
unsharded stack of all S members at the bound of a stacked member against
its sequential run (rtol 2e-4 and atol 1e-6): torch's batched products (the
vmapped convolution) round differently at another member count.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch import sweep
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.parallel import launch
from structured_latent_odes_tpu_torch.parallel.mesh import Grid
from structured_latent_odes_tpu_torch.train.ensemble import shard_member_inputs, shard_runner_inputs
from structured_latent_odes_tpu_torch.train.svi import AdamSlots, SVIState
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
import _torch_rank_tasks as tasks
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

SEEDS = [3, 4, 5, 6]
BOUNDS = {"members": (1e-5, 1e-7, 1e-6), "data": (2e-4, 1e-6, 2e-4), "stacked": (2e-4, 1e-6, 2e-4)}


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, threads=1, timeout_s=60) as p:
        yield p


@pytest.fixture(scope="module")
def cvs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


def _config(cvs_dir):
    cfg = sweep.load_base_config("cvs")
    cfg.update(data_path=cvs_dir, mini_batch_size=8, num_epochs=1, prior_refit_epochs=1)
    return cfg


@pytest.fixture(scope="module")
def unsharded(cvs_dir):
    """The unsharded runs of SEEDS, by member-group size (0: one stack), at
    one intra-op thread as the ranks run (a module fixture is set up before
    the autouse one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        members = [sweep.prepare_member("cvs", _config(cvs_dir), s, "cpu") for s in SEEDS]
        return {g: sweep.train_ensemble(members, member_group=g, device="cpu") for g in (0, 1, 2)}
    finally:
        torch.set_num_threads(threads)


def _assert_results_close(got, ref, bounds, moments=True):
    rtol, atol, crit_rtol = bounds
    np.testing.assert_array_equal(got.best_epoch, ref.best_epoch)
    np.testing.assert_allclose(got.best_crit, ref.best_crit, rtol=crit_rtol)
    for a, b in zip(tree_leaves([got.best_params, got.state.params]), tree_leaves([ref.best_params, ref.state.params])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    if moments:  # sums of gradients (hundreds here): within rtol of each leaf's largest, at least 1
        for i, (a, b) in enumerate(zip(tree_leaves([got.state.opt.mu, got.state.opt.nu]),
                                       tree_leaves([ref.state.opt.mu, ref.state.opt.nu]))):
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
            assert err <= rtol, ("moment", i, tuple(b.shape), err)
    for k in ref.history:
        np.testing.assert_allclose(got.history[k], ref.history[k], rtol=crit_rtol)
    assert got.state.seed == ref.state.seed


@pytest.mark.parametrize("ens,data", [(4, 1), (2, 2), (1, 4)], ids=["ens4", "ens2-data2", "data4"])
def test_sharded_ensemble_matches_unsharded(pool, cvs_dir, unsharded, ens, data):
    """Four members (one epoch beyond epoch 0, then a prior refit) over four
    ranks: one member a rank; two members a rank pair, each minibatch halved
    over the pair; all members on every rank, each minibatch quartered.
    Rank 0 gets every member's result, in member order; the others None."""
    outs = pool.run(tasks.sweep_ensemble, dict(dataset="cvs", config=_config(cvs_dir), seeds=SEEDS, ens=ens,
                                               data=data))
    assert all(o is None for o in outs[1:])
    group = len(SEEDS) // ens if ens > 1 else 0
    _assert_results_close(outs[0], unsharded[group], BOUNDS["members" if data == 1 else "data"])
    _assert_results_close(outs[0], unsharded[0], BOUNDS["stacked"], moments=False)


def test_runner_inputs_slices_on_the_grid(pool):
    """shard_runner_inputs on the 2 x 2 (ens, data) grid: each rank's members
    (seeds, eval seeds, perms) and its half of every minibatch axis (perms,
    mask)."""
    perms = np.arange(4 * 2 * 3 * 8).reshape(4, 2, 3, 8)
    mask = np.arange(3 * 8, dtype=np.float32).reshape(3, 8)
    outs = pool.run(tasks.member_slices, dict(ens=2, data=2, perms=perms, mask=mask))
    for r, out in enumerate(outs):
        e, d = divmod(r, 2)
        assert out["coords"] == (e, d)
        assert out["seeds"] == [2 * e, 2 * e + 1] and out["eval_seeds"] == [100 + 2 * e, 101 + 2 * e]
        np.testing.assert_array_equal(out["perms"], perms[2 * e:2 * e + 2, ..., 4 * d:4 * d + 4])
        np.testing.assert_array_equal(out["mask"], mask[:, 4 * d:4 * d + 4])


def test_member_sharding_requires_divisible_members(monkeypatch):
    """The JAX package's errors: members that do not divide over the member
    ranks, a minibatch that does not divide over the data ranks, and a grid
    past the devices."""
    grid = Grid(("ens", "data"), (4, 1), (0, 1, 2, 3), (1, 0), {})
    with pytest.raises(ValueError, match="member axis 6 not divisible by mesh size 4"):
        shard_member_inputs(grid, (np.zeros((6, 3)),))
    assert shard_member_inputs(grid, (np.arange(8)[:, None], None), (np.ones(2),))[0][0].tolist() == [[2], [3]]
    zeros = {"w": torch.zeros(4, 1)}
    states = SVIState(zeros, AdamSlots(zeros, zeros, {"w": 0}), [0, 1, 2, 3], 0)
    with pytest.raises(ValueError, match="not divisible by mesh extent 2"):
        shard_runner_inputs(Grid(("ens", "data"), (1, 2), (0, 1), (0, 0), {}), states=states, eval_seeds=[0] * 4,
                            train_splits=None, val_stacks=None, perms=np.zeros((4, 2, 3, 5)),
                            mask=np.zeros((3, 5)), aux_mult=np.ones((4, 2)), shared_data=True)
    args = argparse.Namespace(ensemble_parallel=4, ensemble_data_parallel=1)
    with pytest.raises(ValueError, match="member axis 6 not divisible by mesh size 4"):
        sweep.member_extent(args, 6, "cpu")
    assert sweep.member_extent(args, 8, "cpu") == (4, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="ensemble mesh 4x1 > 1 available devices"):
        sweep.member_extent(args, 8, "cuda")


def test_flagless_sweep_stays_on_one_rank(monkeypatch):
    """As in the JAX package, a sweep shards only when --ensemble-parallel or
    --ensemble-data-parallel is above 1, however many cards there are; with
    --ensemble-data-parallel alone above 1, the member ranks are the cards
    over it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for ens in (0, 1):
        args = argparse.Namespace(ensemble_parallel=ens, ensemble_data_parallel=1)
        assert sweep.member_extent(args, 3, "cuda") == (1, 1)
    args = argparse.Namespace(ensemble_parallel=0, ensemble_data_parallel=2)
    assert sweep.member_extent(args, 4, "cuda") == (2, 2)
    with pytest.raises(ValueError, match="member axis 3 not divisible by mesh size 2"):
        sweep.member_extent(args, 3, "cuda")
    assert sweep.member_extent(args, 3, "cpu") == (1, 2)


def _sweep_cli(cvs_dir, root, extra):
    return sweep.main(["cvs", "--device", "cpu", "--seeds", "3..6", "--num-epochs", "1", "--mini-batch-size", "8",
                       "--data-path", cvs_dir, "--results-root", str(root)] + extra)


@pytest.mark.parametrize("flags,group,bounds", [(["--ensemble-parallel", "2"], "2", "members"),
                                                (["--ensemble-data-parallel", "2"], "0", "data")],
                         ids=["ensemble-parallel", "ensemble-data-parallel"])
def test_sweep_cli_on_ranks_matches_unsharded(cvs_dir, tmp_path, flags, group, bounds):
    """sweep.main spawns two ranks; rank 0 finalizes every member: the
    summary's members, their best epochs and criteria, and each member's
    best_model.npz within the bounds of the unsharded sweep's, run in
    member groups of a rank's size."""
    rtol, atol, crit_rtol = BOUNDS[bounds]
    ref = _sweep_cli(cvs_dir, tmp_path / "one", ["--member-group", group])
    got = _sweep_cli(cvs_dir, tmp_path / "two", flags)
    with open(tmp_path / "two" / "sweep.json") as f:
        assert json.load(f)["seeds"] == SEEDS
    for a, b in zip(got["members"], ref["members"]):
        assert a["seed"] == b["seed"] and a["best_epoch"] == b["best_epoch"]
        np.testing.assert_allclose(a["criterion"], b["criterion"], rtol=crit_rtol)
        with np.load(os.path.join(a["results_dir"], "best_model.npz")) as x, \
                np.load(os.path.join(b["results_dir"], "best_model.npz")) as y:
            for k in y.files:
                if y[k].dtype.kind == "f":
                    np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=atol, err_msg=k)
    assert os.path.isdir(tmp_path / "two" / "deploy_mean")

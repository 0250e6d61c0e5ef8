"""Batch-exact checkpoint and resume of the PyTorch port's training loop, on
the CPU.

A CVS run (``training_cvs.main``, tiny generated data) checkpointed at epoch
2 and resumed to epoch 4 ends bit for bit where the uninterrupted 4-epoch
run ends: the params, the Adam moments and step counts, the best params and
epoch, and the ``.npy`` artifacts written after the prior refit, in the
``shared`` and ``split`` optimizer modes. The host shuffle RNG's snapshot
equals the JAX package's leaf for leaf. A resume without a file starts
afresh; the JAX package's ``train_state.npz`` is refused by the structure
check; the params part of the port's ``train_state.npz`` restores into the
JAX package's ``best_model`` structure.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init_params
from structured_latent_odes_tpu.train import checkpoint as jax_ckpt
from structured_latent_odes_tpu.train.svi import make_train_step as jax_make_train_step
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.train import checkpoint
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

ARGS = ["--mini-batch-size", "8", "--no-plot", "--no-eval-train", "--device", "cpu", "--prior-refit-epochs", "1"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


def _run(data_dir, root, *extra):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = training_cvs.main(["--data-path", data_dir, "--results-root", str(root)] + ARGS + list(extra))
    return result, out.getvalue()


def _assert_trees_equal(a, b, where):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), where
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (where, i)
        else:
            assert x == y, (where, i, x, y)


def _assert_states_equal(s1, s2):
    _assert_trees_equal(s1.params, s2.params, "params")
    slots1 = [s1.opt] if not isinstance(s1.opt, tuple) else list(s1.opt)
    slots2 = [s2.opt] if not isinstance(s2.opt, tuple) else list(s2.opt)
    assert len(slots1) == len(slots2)
    for a, b in zip(slots1, slots2):
        _assert_trees_equal(a.mu, b.mu, "mu")
        _assert_trees_equal(a.nu, b.nu, "nu")
        _assert_trees_equal(a.count, b.count, "count")
    assert (s1.seed, s1.step) == (s2.seed, s2.step)


@pytest.mark.parametrize("optimizer", ["shared", "split"])
def test_resume_is_batch_exact(data_dir, tmp_path, optimizer):
    full, _ = _run(data_dir, tmp_path / "full", "--optimizer", optimizer, "--num-epochs", "4",
                   "--checkpoint-every", "2")
    part = tmp_path / "part"
    _run(data_dir, part, "--optimizer", optimizer, "--num-epochs", "2", "--checkpoint-every", "2")
    resumed, log = _run(data_dir, part, "--optimizer", optimizer, "--num-epochs", "4", "--resume")
    assert "at epoch 3" in log and log.count("[Epoch ") == 2  # epochs 3 and 4 only

    _assert_states_equal(full["state"], resumed["state"])
    assert isinstance(resumed["state"].opt, tuple) == (optimizer == "split")
    assert full["best"]["epoch"] == resumed["best"]["epoch"]
    assert full["best"]["criterion"] == resumed["best"]["criterion"]
    _assert_trees_equal(full["best"]["params"], resumed["best"]["params"], "best params after the refit")
    a, b = full["out_dir"], resumed["out_dir"]
    npys = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    assert len(npys) == 14 and npys == sorted(f for f in os.listdir(b) if f.endswith(".npy"))
    for name in npys:
        np.testing.assert_array_equal(np.load(os.path.join(a, name)), np.load(os.path.join(b, name)), err_msg=name)
    with np.load(os.path.join(a, "best_model.npz")) as za, np.load(os.path.join(b, "best_model.npz")) as zb:
        assert all(np.array_equal(za[k], zb[k]) for k in za.files)


def test_host_rng_snapshot_matches_jax_and_round_trips():
    rng = np.random.RandomState(7)
    rng.rand(13)
    rng.standard_normal()  # a cached Gaussian in the state
    ours, ref = checkpoint.host_rng_tree(rng), jax_ckpt.host_rng_tree(rng)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    expected = (rng.rand(5), rng.standard_normal(3))
    rng2 = np.random.RandomState(0)
    checkpoint.apply_host_rng_tree(rng2, ours)
    np.testing.assert_array_equal(rng2.rand(5), expected[0])
    np.testing.assert_array_equal(rng2.standard_normal(3), expected[1])


def test_int_leaves_round_trip(tmp_path):
    path = str(tmp_path / "ints.npz")
    tree = {"count": [0, 7], "seed": -(1 << 62), "w": np.ones(3, np.float32)}
    checkpoint.save(path, tree)
    back = checkpoint.restore(path, tree)
    assert back["count"] == [0, 7] and back["seed"] == -(1 << 62) and type(back["seed"]) is int
    with np.load(path) as z:
        assert z["leaf_0"].dtype == np.int64


def test_resume_without_a_file_starts_afresh(data_dir, tmp_path):
    plain, _ = _run(data_dir, tmp_path / "plain", "--num-epochs", "1")
    fresh, log = _run(data_dir, tmp_path / "fresh", "--num-epochs", "1", "--resume")
    assert "resumed" not in log and log.count("[Epoch ") == 2
    _assert_states_equal(plain["state"], fresh["state"])


def _jax_train_state(path):
    """The JAX package's train_state.npz for the CVS model, as its loop saves
    it (state, best params, eval key, host RNG), untrained."""
    spec = jax_cvs_spec(jax_cvs_config())
    params = jax_init_params(jax.random.key(0), spec)
    init_state, _, _ = jax_make_train_step(spec, jnp.arange(86.0), 1e-3, params)
    state = init_state(params, jax.random.key(1))
    jax_ckpt.save(path, {"state": state, "best_params": params, "eval_key": jax.random.key(2),
                         "host_rng": jax_ckpt.host_rng_tree(np.random.RandomState(0))},
                  metadata={"epoch": 0, "best_epoch": 0, "criterion": 1.0})
    return params


def test_jax_train_state_is_refused(data_dir, tmp_path):
    rd = tmp_path / "results_Mechanistic"
    rd.mkdir()
    _jax_train_state(str(rd / "train_state.npz"))
    with pytest.raises(ValueError, match=r"checkpoint structure mismatch at leaf \d+: stored path"):
        _run(data_dir, tmp_path, "--num-epochs", "2", "--resume")


def test_train_state_params_restore_into_jax_best_model(data_dir, tmp_path):
    out, _ = _run(data_dir, tmp_path, "--num-epochs", "1", "--checkpoint-every", "1")
    path = os.path.join(out["out_dir"], "train_state.npz")
    jax_params = jax_init_params(jax.random.key(0), jax_cvs_spec(jax_cvs_config()))
    prefix = "['state']/['params']/"
    with open(path + ".json") as f:
        paths = [p[len(prefix):] for p in json.load(f)["paths"] if p.startswith(prefix)]
    assert paths == jax_ckpt._paths_of(jax_params)

    tree = out["state"].to_tree()
    like = {"state": tree, "best_params": tree["params"],
            "host_rng": checkpoint.host_rng_tree(np.random.RandomState(0))}
    params = checkpoint.restore(path, like)["state"]["params"]
    np_path = str(tmp_path / "params.npz")
    checkpoint.save(np_path, params)
    restored = jax_ckpt.restore(np_path, jax_params)
    assert jax.tree.structure(restored) == jax.tree.structure(jax_params)
    for a, b in zip(jax.tree.leaves(restored), tree_leaves(tree["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)

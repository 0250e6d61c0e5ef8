"""The PyTorch port's proc and challenge data against the JAX package's, held
exactly (array equality, equal dtypes): the configs key by key with proc's
derived maps, challenge's ``build_datasets`` (with and without
``data_seed``), proc's ``parse_file`` of each of the six files against both
JAX paths (its C++ parser where the library builds, and its pandas path),
``build_dataset``, ``split_folds``, ``split_holdout_device`` and its error,
and the splits that ``serve._build`` returns for both datasets.

The port parses with the standard library's ``csv`` module and Python's
``float``; the JAX package's pandas path uses pandas' own float parser.
Both round to float32 and the tests find no element that differs.
"""

import os

import numpy as np
import pytest

from structured_latent_odes_tpu import serve as jax_serve
from structured_latent_odes_tpu.data import challenge as jax_challenge
from structured_latent_odes_tpu.data import proc as jax_proc
from structured_latent_odes_tpu.data import configs as jax_configs
from structured_latent_odes_tpu_torch import serve
from structured_latent_odes_tpu_torch.data import challenge, configs, proc

PROC_FILES = configs.proc_data_config().files


def _assert_same(ours, ref, where="config"):
    """Recursive exact equality of configs: keys in the same order, values of
    the same type, arrays equal with equal dtypes."""
    if isinstance(ref, dict):
        assert type(ours).__name__ == type(ref).__name__, where
        assert list(ours) == list(ref), where
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, where
        np.testing.assert_array_equal(ours, ref, err_msg=where)
    else:
        assert type(ours) is type(ref) and ours == ref, (where, ours, ref)


def _assert_arrays(ours, ref, where=""):
    assert len(ours) == len(ref), where
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}[{i}]")


def _assert_splits(ours, ref):
    assert sorted(ours) == sorted(ref)
    for name in ref:
        assert sorted(ours[name]) == sorted(ref[name]), name
        for k in ref[name]:
            _assert_arrays([ours[name][k]], [np.asarray(ref[name][k])], f"{name}.{k}")


@pytest.mark.parametrize("dataset", ["cvs", "proc", "challenge"])
def test_configs_match_jax(dataset):
    _assert_same(configs.LOADERS[dataset](), jax_configs.LOADERS[dataset](), dataset)


def test_proc_derived_maps():
    data = configs.proc_data_config()
    assert data.device_depth == 7
    np.testing.assert_array_equal(data.relevance_vectors["aR"], [1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(data.relevance_vectors["aS"], [0, 0, 0, 1, 1, 1, 1])
    assert data.device_lookup[4.0] == "R33S34_Y81C76" == data.device_idx_to_device_name[4]


@pytest.mark.parametrize("data_seed", [None, 99])
def test_challenge_build_datasets_match_jax(data_seed):
    pc, jc = configs.load_challenge_config(), jax_configs.load_challenge_config()
    pc.data_seed = jc.data_seed = data_seed
    splits, norm, times = challenge.build_datasets(pc)
    jsplits, jnorm, jtimes = jax_challenge.build_datasets(jc)
    _assert_splits(splits, jsplits)
    _assert_same(norm, jnorm, "norm_params")
    _assert_arrays([times], [jtimes], "times")
    assert splits["train"]["observations"].shape == (28, 142, 4) and splits["val"]["shedding"].shape == (7, 1)


def test_challenge_fold_indices_match_jax():
    for split in range(1, 6):
        _assert_arrays(challenge.fold_indices(35, 5, split, 3), jax_challenge.fold_indices(35, 5, split, 3))
    with pytest.raises(ValueError, match="split"):
        challenge.fold_indices(35, 5, 6, 3)


@pytest.mark.parametrize("name", PROC_FILES)
def test_proc_parse_file_matches_both_jax_paths(name):
    pc, jc = configs.load_proc_config(), jax_configs.load_proc_config()
    path = os.path.join(pc.data_path, name)
    ours = proc.parse_file(path, pc.data)
    _assert_arrays(ours, jax_proc.parse_file(path, jc.data, use_native=False), f"{name} pandas")
    _assert_arrays(ours, jax_proc.parse_file(path, jc.data), f"{name} native")


@pytest.fixture(scope="module")
def proc_datasets():
    return proc.build_dataset(configs.load_proc_config()), jax_proc.build_dataset(jax_configs.load_proc_config())


def test_proc_build_dataset_matches_jax(proc_datasets):
    ours, ref = proc_datasets
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _assert_arrays([ours[k]], [ref[k]], k)
    assert ours["observations"].shape == (312, 4, 100) and ours["dev_1hot"].shape == (312, 7)


@pytest.mark.parametrize("data_seed", [None, 99])
@pytest.mark.parametrize("split", [1, 4])
def test_proc_split_folds_match_jax(proc_datasets, split, data_seed):
    ours, _ = proc_datasets
    pc, jc = configs.load_proc_config(), jax_configs.load_proc_config()
    pc.split = jc.split = split
    pc.data_seed = jc.data_seed = data_seed
    _assert_arrays(proc.split_folds(ours, pc), jax_proc.split_folds(ours, jc))
    pc.split = 5
    with pytest.raises(ValueError, match="split"):
        proc.split_folds(ours, pc)


def test_proc_split_holdout_device(proc_datasets):
    ours, _ = proc_datasets
    pc, jc = configs.load_proc_config(), jax_configs.load_proc_config()
    pc.heldout = jc.heldout = "R33S34_Y81C76"
    train, val = proc.split_holdout_device(ours, pc)
    _assert_arrays((train, val), jax_proc.split_holdout_device(ours, jc))
    assert len(train) + len(val) == 312 and (ours["devices"][val] == 4).all()
    pc.heldout = "no_such_device"
    with pytest.raises(ValueError, match="--heldout must be one of"):
        proc.split_holdout_device(ours, pc)


@pytest.mark.parametrize("heldout", [None, "R33S34_Y81C76"], ids=["folds", "heldout"])
def test_proc_build_splits_match_jax(heldout):
    pc, jc = configs.load_proc_config(), jax_configs.load_proc_config()
    pc.heldout = jc.heldout = heldout
    splits, times = proc.build_splits(pc)
    jsplits, jtimes = jax_proc.build_splits(jc)
    _assert_splits(splits, jsplits)
    _assert_arrays([times], [jtimes])


@pytest.mark.parametrize("dataset", ["proc", "challenge"])
def test_serve_build_matches_jax(dataset):
    spec, splits, times = serve._build(dataset, configs.LOADERS[dataset](), "cpu")
    jspec, jsplits, jtimes = jax_serve._build(dataset, jax_configs.LOADERS[dataset]())
    _assert_splits(splits, jsplits)
    _assert_arrays([times], [jtimes])
    assert spec.n_time == jspec.n_time == len(times) == {"proc": 100, "challenge": 142}[dataset]
    assert splits["val"]["observations"].shape[1:] == (4, len(times))

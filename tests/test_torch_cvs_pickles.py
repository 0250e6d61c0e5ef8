"""The reference's CVS pickles (``data/cvs.py::load_reference_pickles``) in
the PyTorch port against the JAX package, on the CPU: small pickles written
with ``torch.save`` give the same splits and norm params in both packages'
``load_splits(config, reference_dir=...)``, with and without
``data_norm_params.pkl``, and the same normalized splits through both
``training_cvs.build_splits``; with the norm file the port's splits equal
those of the ``cvs.npz`` the pickles were written from. The real pickles
are not in the repo."""

import os

import numpy as np
import pytest

from structured_latent_odes_tpu import training_cvs as jax_training_cvs
from structured_latent_odes_tpu.data import cvs as jax_cvs
from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data import cvs
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from _torch_reference_pickles import write_reference_pickles


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    cvs.make_dataset(d, data_size=20, seed=3, device="cpu")
    return d


def _assert_equal(ours, ref, where):
    assert sorted(ours) == sorted(ref), where
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_equal(ours[k], ref[k], f"{where}.{k}")
        else:
            a, b = np.asarray(ours[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{where}.{k}")


@pytest.mark.parametrize("norm", [True, False], ids=["with-norm-file", "without-norm-file"])
def test_pickled_splits_match_jax(npz_dir, tmp_path, norm):
    ref_dir = write_reference_pickles(os.path.join(npz_dir, "cvs.npz"), str(tmp_path / "ref"), norm=norm)
    splits, norm_params = cvs.load_splits(load_cvs_config(), reference_dir=ref_dir, device="cpu")
    jsplits, jnorm = jax_cvs.load_splits(jax_cvs_config(), reference_dir=ref_dir)
    _assert_equal(splits, jsplits, "splits")
    _assert_equal(norm_params, jnorm, "norm_params")
    assert splits["train"]["observations"].shape == (16, 86, 3) and splits["test"]["iext"].shape == (2, 1)

    pc, jc = load_cvs_config(), jax_cvs_config()
    pc.reference_data_dir = jc.reference_data_dir = ref_dir
    ours, _ = training_cvs.build_splits(pc, device="cpu")
    ref, _ = jax_training_cvs.build_splits(jc)
    _assert_equal(ours, ref, "normalized")


def test_pickled_splits_equal_the_npz_splits(npz_dir, tmp_path):
    ref_dir = write_reference_pickles(os.path.join(npz_dir, "cvs.npz"), str(tmp_path / "ref"))
    pc, nc = load_cvs_config(), load_cvs_config()
    pc.reference_data_dir = ref_dir
    nc.data_path = npz_dir
    _assert_equal(training_cvs.build_splits(pc, device="cpu")[0], training_cvs.build_splits(nc, device="cpu")[0],
                  "pickles vs cvs.npz")

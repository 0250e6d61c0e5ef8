"""The PyTorch port's CVS data (data/cvs.py, data/loader.py,
data/transforms.py, training_cvs.build_splits) against the JAX package.

``make_dataset`` at data_size=40: the interventions (labels) and the
observation noise come from numpy ``RandomState`` in the same order, so they
are bit-equal; the RK4 states come from two float32 integrators (XLA and
PyTorch) over 850 steps and agree within 1e-5 abs (states are O(1); the
measured gap is a few 1e-7).
"""

import jax  # noqa: F401  (JAX on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data import cvs as jax_cvs
from structured_latent_odes_tpu.data import loader as jax_loader
from structured_latent_odes_tpu.data import transforms as jax_tf
from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.training_cvs import build_splits as jax_build_splits
from structured_latent_odes_tpu_torch.data import cvs as port_cvs
from structured_latent_odes_tpu_torch.data import loader as port_loader
from structured_latent_odes_tpu_torch.data import transforms as port_tf
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.training_cvs import build_splits
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

STATE_TOL = 1e-5


class _Recording(np.random.RandomState):
    """RandomState that records every draw, to compare the draws bit for bit."""

    draws = None

    def rand(self, *args):
        out = super().rand(*args)
        self.draws.append(("rand", out))
        return out

    def standard_normal(self, *args, **kwargs):
        out = super().standard_normal(*args, **kwargs)
        self.draws.append(("standard_normal", out))
        return out


def _make(module, path, monkeypatch, **kw):
    draws = []
    monkeypatch.setattr(_Recording, "draws", draws)
    monkeypatch.setattr(np.random, "RandomState", _Recording)
    module.make_dataset(str(path), data_size=40, **kw)
    monkeypatch.undo()
    with np.load(path / "cvs.npz") as z:
        return {k: z[k] for k in z.files}, draws


def test_make_dataset_matches_jax(tmp_path, monkeypatch):
    ref, ref_draws = _make(jax_cvs, tmp_path / "jax", monkeypatch)
    out, out_draws = _make(port_cvs, tmp_path / "port", monkeypatch, device="cpu")
    assert sorted(out) == sorted(ref)
    # labels and noise: the same RandomState draws in the same order, bit-equal
    assert [k for k, _ in out_draws] == [k for k, _ in ref_draws] == ["rand", "rand"] + ["standard_normal"] * 2
    for (_, a), (_, b) in zip(out_draws, ref_draws):
        np.testing.assert_array_equal(a, b)
    for k in ("train_iext", "train_rtpr", "test_iext", "test_rtpr"):
        np.testing.assert_array_equal(out[k], ref[k])
    # states, clean observations and noisy observations (the noise is equal)
    assert out["train_latent"].shape == (36, 86, 4) and out["test_obs"].shape == (4, 86, 3)
    for k in ("train_latent", "test_latent", "gt_test_obs", "train_obs", "test_obs"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=STATE_TOL, err_msg=k)
    for k in ("norm_mean", "norm_std", "norm_min", "norm_max"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=STATE_TOL, err_msg=k)


def test_cvs_rhs_matches_jax():
    rng = np.random.RandomState(0)
    state = rng.uniform(0.5, 1.5, (8, 4)).astype(np.float32)
    i_ext = np.where(rng.rand(8) > 0.5, 0.0, -2.0).astype(np.float32)
    r_tpr = np.where(rng.rand(8) > 0.5, 0.0, 0.5).astype(np.float32)
    ref = np.asarray(jax_cvs.cvs_rhs(0.0, state, i_ext, r_tpr))
    out = port_cvs.cvs_rhs(0.0, *map(torch.from_numpy, (state, i_ext, r_tpr))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_build_splits_matches_jax(tmp_path):
    """Both packages read one generated cvs.npz: splits, labels and norm
    params are numpy and bit-equal."""
    jc, pc = jax_cvs_config(), load_cvs_config()
    jc.data_path = pc.data_path = str(tmp_path)
    jc.data_size = pc.data_size = 40
    out, out_norm = build_splits(pc, device="cpu")  # generates cvs.npz
    ref, ref_norm = jax_build_splits(jc)
    assert sorted(out) == sorted(ref) == ["test", "train", "val"]
    for name in ref:
        assert sorted(out[name]) == sorted(ref[name])
        for k in ref[name]:
            np.testing.assert_array_equal(out[name][k], ref[name][k])
    assert out["train"]["observations"].shape == (32, 3, 86)
    for k in ref_norm:
        np.testing.assert_array_equal(out_norm[k], ref_norm[k])


@pytest.mark.parametrize("norm", ["zscore", "zero_to_one", None])
def test_loader_helpers_match_jax(norm):
    rng = np.random.RandomState(1)
    split = {"observations": rng.rand(5, 86, 3).astype(np.float32),
             "iext": rng.rand(5, 1).astype(np.float32)}
    params = jax_tf.find_norm_params(split["observations"])
    np.testing.assert_array_equal(port_tf.find_norm_params(split["observations"])["std"], params["std"])
    ref = jax_loader.pad_to(jax_loader.to_model_layout(
        jax_loader.normalize_split(split, jax_tf.create_transforms(norm, params))), 8)
    out = port_loader.pad_to(port_loader.to_model_layout(
        port_loader.normalize_split(split, port_tf.create_transforms(norm, params))), 8)
    assert sorted(out) == sorted(ref) == ["iext", "mask", "observations"]
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def _split(n, seed):
    r = np.random.RandomState(seed)
    return {
        "observations": r.rand(n, 3, 12).astype(np.float32),
        "iext": (r.rand(n, 1) > 0.5).astype(np.float32),
        "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32),
    }


def _assert_equal_batches(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("shuffle,crop_len", [(False, None), (True, None), (True, 7)])
def test_minibatch_iterators_match_jax(shuffle, crop_len):
    """iter_minibatches and stacked_minibatches (the port gathers with numpy
    where the JAX package may call its ctypes packer): the same batches,
    padding, masks and sample ids from the same RandomState."""
    split = _split(11, 3)
    ours = list(port_loader.iter_minibatches(split, 4, shuffle=shuffle, rng=np.random.RandomState(1),
                                             crop_len=crop_len))
    ref = list(jax_loader.iter_minibatches(split, 4, shuffle=shuffle, rng=np.random.RandomState(1),
                                           crop_len=crop_len))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        _assert_equal_batches(a, b)
    _assert_equal_batches(
        port_loader.stacked_minibatches(split, 4, shuffle=shuffle, rng=np.random.RandomState(2), crop_len=crop_len),
        jax_loader.stacked_minibatches(split, 4, shuffle=shuffle, rng=np.random.RandomState(2), crop_len=crop_len),
    )


@pytest.mark.parametrize("pad_to_size", [None, 16])
def test_full_batch_matches_jax(pad_to_size):
    split = _split(11, 4)
    _assert_equal_batches(port_loader.full_batch(split, pad_to_size), jax_loader.full_batch(split, pad_to_size))

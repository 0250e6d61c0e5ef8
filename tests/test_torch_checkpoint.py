"""Checkpoints and parameter interop between the JAX package and the PyTorch
port: a checkpoint saved by either package restores in the other, bit for
bit; the sidecar is the same; a structure mismatch names the first differing
path; and the port's own ``init_params`` has the JAX package's tree, leaf
paths and shapes once carried to the JAX layout."""

import json

import jax
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.train import checkpoint as jax_ckpt
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.train import checkpoint as port_ckpt
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(params=["Mechanistic", "MechanisticGauss"])
def models(request):
    jc, pc = jax_cvs_config(), load_cvs_config()
    jc.model = pc.model = request.param
    jspec, pspec = jax_cvs_spec(jc), cvs_spec(pc)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jspec))
    return jparams, pspec


def _leaves_with_paths(tree):
    return [("/".join(str(k) for k in kp), np.asarray(v))
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_jax_checkpoint_restores_in_port(tmp_path, models):
    jparams, pspec = models
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save(path, jparams)
    like = params_to_jax(init_params(pspec, 1, device="cpu"))
    restored = port_ckpt.restore(path, like)
    ref = _leaves_with_paths(jparams)
    got = _leaves_with_paths(restored)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b, err_msg=p)
    port_params = params_from_jax(restored, device="cpu")
    dyn = port_params["decoder"]["ode"]["dyn_hidden"]["W"]
    assert dyn.shape == (25, 16)  # (H, L+1): column 0 is the time weight
    np.testing.assert_array_equal(dyn[:, 0].numpy(), jparams["decoder"]["ode"]["dyn_hidden"]["W"][0])


def test_port_checkpoint_restores_in_jax(tmp_path, models):
    jparams, pspec = models
    tree = params_to_jax(init_params(pspec, 3, device="cpu"))
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port_ckpt.save(port_path, tree)
    restored = jax_ckpt.restore(port_path, jparams)
    got, ref = _leaves_with_paths(restored), _leaves_with_paths(tree)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b, err_msg=p)
    # the sidecar is the one the JAX package writes for the same tree
    jax_ckpt.save(jax_path, tree)
    with open(port_path + ".json") as f, open(jax_path + ".json") as g:
        assert json.load(f) == json.load(g)


def test_port_init_has_the_jax_tree(models):
    jparams, pspec = models
    port_tree = params_to_jax(init_params(pspec, 0, device="cpu"))
    assert jax.tree_util.tree_structure(port_tree) == jax.tree_util.tree_structure(jparams)
    for (p, a), (_, b) in zip(_leaves_with_paths(port_tree), _leaves_with_paths(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, p


def test_interop_round_trip_is_exact(models):
    jparams, _ = models
    back = params_to_jax(params_from_jax(jparams, device="cpu"))
    for (p, a), (_, b) in zip(_leaves_with_paths(back), _leaves_with_paths(jparams)):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_restore_names_the_first_differing_path(tmp_path, models):
    jparams, pspec = models
    path = str(tmp_path / "ckpt.npz")
    port_ckpt.save(path, jparams)
    like = params_to_jax(init_params(pspec, 0, device="cpu"))
    like["encoder"]["z_extra"] = like["encoder"].pop("z_scale")  # same shapes, moved in the tree
    with pytest.raises(ValueError, match=r"\['encoder'\]/\['z_extra'\]"):
        port_ckpt.restore(path, like)
    like = params_to_jax(init_params(pspec, 0, device="cpu"))
    like["decoder"]["constant_std"] = np.zeros((3, 85), np.float32)
    with pytest.raises(ValueError, match="constant_std"):
        port_ckpt.restore(path, like)
    assert isinstance(params_from_jax(jparams, device="cpu")["encoder"]["conv_W"], torch.Tensor)

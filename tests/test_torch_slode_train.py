"""The training half of the PyTorch port's model (models/slode.py) against the
JAX package at the JAX ``init_params(jax.random.key(0), cvs_spec(cfg))``
carried across and the same standard-normal draws: ``param_masks``, the
losses ``elbo_main`` (with its L1 metric) and ``elbo_aux`` with and without a
padding mask, quantile and Gauss likelihoods, and their gradients into every
parameter leaf on the ``semilinear`` (K1, K1-bwd) and ``semilinear_fused``
(K2, K3) backends.

The draws are JAX's own ``sample_normal_ps(sub, sids, 0, 1)`` under the key
splits that ``elbo_main`` and ``elbo_aux`` make, handed to the port through
``noise=``. On the JAX side ``semilinear`` is the associative scan and
``semilinear_fused`` the Pallas kernels in interpret mode.

Tolerances: losses 2e-6 relative (sums of thousands of float32 log-probs,
the ODE's roundoff at |x| of tens included; measured 2.5e-7); the L1 metric
1e-5 relative (measured 6.7e-7); gradients max|port - JAX| / max(max|JAX|, 1)
per leaf below 1e-5 (float32 sums over the batch, time and stages in another
order; measured 9.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.data.loader import pad_to
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import elbo_aux as jax_elbo_aux
from structured_latent_odes_tpu.models import elbo_main as jax_elbo_main
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.models import param_masks as jax_param_masks
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, elbo_aux, elbo_main, param_masks
from structured_latent_odes_tpu_torch.prob import l1_of_parts
from structured_latent_odes_tpu_torch.train.svi import value_and_grad
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

LOSS_RTOL = 2e-6
L1_RTOL = 1e-5
GRAD_TOL = 1e-5
N, T = 6, 86


def _specs(model="Mechanistic", backend="semilinear"):
    jc, pc = jax_cvs_config(), load_cvs_config()
    jc.model = pc.model = model
    jc.ode_backend = pc.ode_backend = backend
    return jax_cvs_spec(jc), cvs_spec(pc)


def _batch(masked: bool):
    rng = np.random.RandomState(5)
    split = {
        "observations": rng.rand(N, 3, T).astype(np.float32),
        "iext": (rng.rand(N, 1) > 0.5).astype(np.float32),
        "rtpr": (rng.rand(N, 1) > 0.5).astype(np.float32),
    }
    if masked:  # two padded rows with a zero mask, and loader sample ids
        split["sample_id"] = np.arange(N, dtype=np.int32) + 40
        split = pad_to(split, N + 2)
    return split


def _sids(batch):
    return jnp.asarray(batch.get("sample_id", np.arange(batch["observations"].shape[0])))


def _eps(key, sids, dim):
    zeros = jnp.zeros((sids.shape[0], dim))
    return torch.tensor(np.asarray(jax_sample(key, sids, zeros, jnp.ones_like(zeros))))


def jax_main_noise(spec, key, batch):
    """The draws of the JAX elbo_main under ``key`` (separate priors)."""
    sids, noise = _sids(batch), {}
    for block in spec.labeled_blocks:
        key, sub = jax.random.split(key)
        noise[block.name] = _eps(sub, sids, block.dim)
    key, sub = jax.random.split(key)
    noise[spec.epsilon_block.name] = _eps(sub, sids, spec.epsilon_block.dim)
    return noise


def jax_aux_noise(spec, key, batch):
    """The draws of the JAX elbo_aux under ``key``."""
    sids, noise = _sids(batch), {}
    for block in spec.labeled_blocks:
        key, sub = jax.random.split(key)
        noise[block.name] = _eps(sub, sids, block.dim)
    return noise


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def test_param_masks_match_jax():
    jspec, pspec = _specs()
    params = jax_init(jax.random.key(0), jspec)
    for ours, ref in zip(param_masks(pspec, _port(params)), jax_param_masks(jspec, params)):
        assert tree_leaves(ours) == [bool(x) for x in jax.tree.leaves(ref)]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("model", ["Mechanistic", "MechanisticGauss"])
def test_losses_match_jax(model, masked):
    jspec, pspec = _specs(model)
    params = jax_init(jax.random.key(0), jspec)
    batch = _batch(masked)
    ts = np.arange(T, dtype=np.float32)
    k1, k2 = jax.random.key(3), jax.random.key(4)
    ref_m, ref_mets = jax_elbo_main(jspec, params, k1, _jax(batch), ts)
    ref_a = jax_elbo_aux(jspec, params, k2, _jax(batch))
    p = _port(params)
    loss_m, mets = elbo_main(pspec, p, 0, _torch(batch), ts, noise=jax_main_noise(jspec, k1, batch))
    loss_a = elbo_aux(pspec, p, 0, _torch(batch), noise=jax_aux_noise(jspec, k2, batch))
    np.testing.assert_allclose(float(loss_m), float(ref_m), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(l1_of_parts(*mets["l1_parts"])), float(ref_mets["l1"]), rtol=L1_RTOL)
    np.testing.assert_allclose(float(loss_a), float(ref_a), rtol=LOSS_RTOL)


def _assert_grads_close(ours, ref_tree, what):
    ref = tree_leaves(_port(ref_tree))
    ours = tree_leaves(ours)
    assert len(ours) == len(ref)
    for i, (g, r) in enumerate(zip(ours, ref)):
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err < GRAD_TOL, (what, i, tuple(r.shape), err)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("backend", ["semilinear", "semilinear_fused"])
def test_loss_gradients_match_jax(backend, masked):
    """Gradients of both losses into every leaf: through K1/K1-bwd or K2/K3
    (their plain versions here) against jax.grad."""
    jspec, pspec = _specs(backend=backend)
    params = jax_init(jax.random.key(0), jspec)
    batch = _batch(masked)
    ts = np.arange(T, dtype=np.float32)
    k1, k2 = jax.random.key(3), jax.random.key(4)
    jb = _jax(batch)
    ref_m = jax.grad(lambda q: jax_elbo_main(jspec, q, k1, jb, ts)[0])(params)
    ref_a = jax.grad(lambda q: jax_elbo_aux(jspec, q, k2, jb))(params)
    p, tb = _port(params), _torch(batch)
    _, _, g_m = value_and_grad(
        lambda q: elbo_main(pspec, q, 0, tb, ts, noise=jax_main_noise(jspec, k1, batch)), p)
    _, _, g_a = value_and_grad(lambda q: elbo_aux(pspec, q, 0, tb, noise=jax_aux_noise(jspec, k2, batch)), p)
    _assert_grads_close(g_m, ref_m, "elbo_main")
    _assert_grads_close(g_a, ref_a, "elbo_aux")

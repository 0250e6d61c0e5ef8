"""The PyTorch port's Trace-ELBO (prob/elbo.py) against the JAX package's:
``Trace`` in its MC-KL form with the per-sample mask, the quantile
asymmetric-Laplace log-likelihood and the side-channel L1, on the cases of
tests/test_distributions.py.

Tolerance 1e-5 relative: sums of a few dozen float32 log-probs taken in the
same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu import prob as jprob
from structured_latent_odes_tpu_torch import prob
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _both(*arrays):
    arrays = [np.asarray(a, dtype=np.float32) for a in arrays]
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def _trace(mod, z, m, s, p_loc, p_scale, x, scale):
    tr = mod.Trace()
    tr.latent_normal(z, m, s, p_loc, p_scale)
    tr.model_sampled_normal(z, m, s)
    tr.obs(mod.normal_logpdf(x, z, s), scale=scale)
    tr.obs(mod.laplace_logpdf(x[:, :, None] + 0 * z[:, None, :], z[:, None, :], s[:, None, :]), event_dims=2)
    return tr


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_trace_matches_jax(masked):
    rng = np.random.RandomState(1)
    (t_args, j_args) = _both(rng.randn(4, 2), rng.randn(4, 2), rng.rand(4, 2) + 0.5, rng.randn(4, 2),
                             rng.rand(4, 2) + 0.5, rng.randn(4, 2))
    (tm,), (jm,) = _both([1.0, 1.0, 0.0, 1.0])
    t_tr, j_tr = _trace(prob, *t_args, 46.0), _trace(jprob, *j_args, 46.0)
    np.testing.assert_allclose(t_tr.per_sample().numpy(), np.asarray(j_tr.per_sample()), rtol=RTOL)
    t_loss = t_tr.loss(tm if masked else None)
    j_loss = j_tr.loss(jm if masked else None)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL)


def test_trace_mask_zeroes_padded_samples():
    tr = prob.Trace()
    tr.obs(torch.ones((4, 3)))
    assert float(tr.elbo(torch.tensor([1.0, 1.0, 0.0, 0.0]))) == 6.0


@pytest.mark.parametrize("tau", [0.5, 0.975, 0.025])
def test_quantile_laplace_logprob_matches_jax(tau):
    rng = np.random.RandomState(0)
    t_args, j_args = _both(rng.randn(5, 3, 7), rng.randn(5, 3, 7), np.abs(rng.randn(5, 3, 7)) + 0.5)
    t_args[1][0, 0, :3] = t_args[0][0, 0, :3]  # ties: target == mu weighs tau
    j_args[1] = jnp.asarray(t_args[1].numpy())
    out = prob.quantile_laplace_logprob(*t_args, tau)
    np.testing.assert_allclose(out.numpy(), np.asarray(jprob.quantile_laplace_logprob(*j_args, tau)), rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_masked_l1_per_channel_matches_jax(masked):
    rng = np.random.RandomState(1)
    t_args, j_args = _both(rng.randn(4, 3, 6), rng.randn(4, 3, 6))
    (tm,), (jm,) = _both([1.0, 0.0, 1.0, 1.0])
    out = prob.masked_l1_per_channel(*t_args, tm if masked else None)
    ref = jprob.masked_l1_per_channel(*j_args, jm if masked else None)
    np.testing.assert_allclose(float(out), float(ref), rtol=RTOL)

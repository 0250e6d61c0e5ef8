"""The PyTorch port's log-probs (prob/distributions.py) against the JAX
package's, on the cases of tests/test_distributions.py plus the clip edges.

Tolerance 1e-6 abs + 1e-6 relative: the same float32 formulas, elementwise,
with the same 1e-7 clips; log and log1p round differently by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu import prob as jprob
from structured_latent_odes_tpu_torch import prob
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _f32(*arrays):
    return [np.asarray(a, dtype=np.float32) for a in arrays]


@pytest.mark.parametrize("name,loc,scale", [("normal_logpdf", 0.3, 1.7), ("laplace_logpdf", -0.2, 0.8)])
def test_continuous_logpdf_matches_jax(name, loc, scale):
    x, loc, scale = _f32(np.linspace(-3, 3, 11), np.full(11, loc), np.full(11, scale))
    out = getattr(prob, name)(*map(torch.from_numpy, (x, loc, scale)))
    _close(out, getattr(jprob, name)(*map(jnp.asarray, (x, loc, scale))))


@pytest.mark.parametrize("x", [0.0, 1.0])
def test_bernoulli_logpmf_matches_jax(x):
    """Including probabilities at and beyond the 1e-7 clips."""
    probs, = _f32([0.1, 0.5, 0.93, 0.0, 1.0, 3e-8])
    xs = np.full_like(probs, x)
    out = prob.bernoulli_logpmf(torch.from_numpy(xs), torch.from_numpy(probs))
    _close(out, jprob.bernoulli_logpmf(jnp.asarray(xs), jnp.asarray(probs)))


def test_onehot_categorical_logpmf_matches_jax():
    x, probs = _f32([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    [[0.2, 0.3, 0.5], [0.6, 0.1, 0.3], [0.5, 0.5, 0.0]])
    out = prob.sum_event(prob.onehot_categorical_logpmf(torch.from_numpy(x), torch.from_numpy(probs)))
    ref = jprob.sum_event(jprob.onehot_categorical_logpmf(jnp.asarray(x), jnp.asarray(probs)))
    _close(out, ref)


def test_kl_normal_normal_matches_jax():
    args = _f32([0.5, -1.0], [1.2, 0.3], [-0.3, 0.2], [0.7, 2.0])
    _close(prob.kl_normal_normal(*map(torch.from_numpy, args)), jprob.kl_normal_normal(*map(jnp.asarray, args)))


@pytest.mark.parametrize("event_dims", [0, 1, 2])
def test_sum_event_matches_jax(event_dims):
    x = np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)
    _close(prob.sum_event(torch.from_numpy(x), event_dims), jprob.sum_event(jnp.asarray(x), event_dims))

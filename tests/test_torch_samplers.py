"""The samplers ``sample_laplace``, ``sample_bernoulli`` and
``sample_onehot_categorical`` of the PyTorch port (``prob/distributions.py``,
on the counter hash), on the CPU. They are not the JAX package's draws, so
they are held to their distributions: means and variances within 5 standard
errors over 2**16 samples; the (seed, site, sample_id) property, a row's
draw not depending on the other rows of its batch, nor a member's on the
other members of a tensor of seeds; and categorical draws one-hot."""

import math

import pytest
import torch

from structured_latent_odes_tpu_torch.prob import (
    sample_bernoulli,
    sample_laplace,
    sample_onehot_categorical,
    seed_tensor,
    uniform_ps,
    uniform_words_ps,
)
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

N = 1 << 16
IDS = torch.arange(N)


def _within(samples: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, fourth=None):
    """Sample mean within 5 standard errors of ``mean``, and the sample
    variance within 5 of its own, ``Var(s^2) = (m4 - (n-3)/(n-1) var^2) / n``
    with m4 the fourth central moment."""
    x = samples.to(torch.float64)
    n = x.shape[0]
    assert torch.all((x.mean(0) - mean).abs() <= 5 * torch.sqrt(var / n)), (x.mean(0), mean)
    m4 = fourth if fourth is not None else ((x - mean) ** 4).mean(0)
    se = torch.sqrt((m4 - (n - 3) / (n - 1) * var ** 2) / n)
    assert torch.all((x.var(0) - var).abs() <= 5 * se), (x.var(0), var)


def test_uniforms():
    words = uniform_words_ps(11, "u", IDS, 3)
    assert words.dtype == torch.int64 and words.shape == (N, 3)
    assert int(words.min()) >= 0 and int(words.max()) < 1 << 24
    u = uniform_ps(11, "u", IDS, (3,))
    assert torch.equal(u, (words.double() + 0.5) / 2 ** 24)
    _within(u, torch.full((3,), 0.5, dtype=torch.float64), torch.full((3,), 1 / 12, dtype=torch.float64))


def test_laplace_moments():
    loc = torch.tensor([[0.0, 1.5, -2.0]]).expand(N, 3)
    scale = torch.tensor([[1.0, 0.5, 3.0]]).expand(N, 3)
    x = sample_laplace(5, "lap", IDS, loc, scale)
    assert x.dtype == torch.float32 and x.shape == (N, 3) and torch.isfinite(x).all()
    var = 2 * scale[0].double() ** 2
    _within(x, loc[0].double(), var, fourth=24 * scale[0].double() ** 4)


def test_bernoulli_moments():
    p = torch.tensor([[0.05, 0.5, 0.9, 0.0, 1.0]]).expand(N, 5)
    x = sample_bernoulli(6, "bern", IDS, p)
    assert x.dtype == torch.float32 and set(x.unique().tolist()) <= {0.0, 1.0}
    assert x[:, 3].sum() == 0 and x[:, 4].sum() == N
    pm = p[0, :3].double()
    _within(x[:, :3], pm, pm * (1 - pm))


def test_onehot_categorical_moments_and_one_hot():
    probs = torch.tensor([[0.1, 0.6, 0.3, 0.0]]).expand(N, 4)
    x = sample_onehot_categorical(7, "cat", IDS, probs)
    assert x.dtype == torch.float32 and x.shape == (N, 4)
    assert torch.equal(x.sum(-1), torch.ones(N)) and set(x.unique().tolist()) <= {0.0, 1.0}
    # the JAX sampler clips probabilities to 1e-7 before normalizing
    p = torch.clamp(probs[0].double(), 1e-7, 1.0)
    p = (p / p.sum())[:3]
    _within(x[:, :3], p, p * (1 - p))
    assert x[:, 3].sum() <= 2  # about 0.007 expected at 1e-7
    batched = sample_onehot_categorical(7, "cat", IDS[:8], torch.rand(8, 2, 5))
    assert batched.shape == (8, 2, 5) and torch.equal(batched.sum(-1), torch.ones(8, 2))


SAMPLERS = {
    "laplace": lambda seed, ids, a: sample_laplace(seed, "s", ids, a, 1.0 + a),
    "bernoulli": lambda seed, ids, a: sample_bernoulli(seed, "s", ids, a),
    "categorical": lambda seed, ids, a: sample_onehot_categorical(seed, "s", ids, a),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_a_draw_depends_only_on_seed_site_and_sample_id(name):
    draw = SAMPLERS[name]
    gen = torch.Generator().manual_seed(0)
    ids = torch.tensor([4, 9, 0, 17, 3, 8])
    arg = torch.rand(6, 3, generator=gen)
    full = draw(123, ids, arg)
    sub = draw(123, ids[[3, 1]], arg[[3, 1]])
    assert torch.equal(full[[3, 1]], sub)  # the other rows do not matter
    assert not torch.equal(draw(124, ids, arg), full) and not torch.equal(draw(123, ids + 100, arg), full)
    members = draw(seed_tensor([123, 7]), ids, arg)  # a tensor of seeds: a leading member axis
    assert members.shape == (2,) + full.shape
    assert torch.equal(members[0], full) and torch.equal(members[1], draw(7, ids, arg))
    assert math.isfinite(float(full.sum()))

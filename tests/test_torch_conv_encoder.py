"""The conv encoder's front end (``ops/conv_encoder.py``) on the CPU, at the
encoder shapes of CVS (3 channels, 86 steps), proc (4, 100) and challenge
(4, 142), each with 10 filters of width 10 and a pool of 5: the plain
versions of the forward and the weight gradient against ``F.conv1d`` and
``F.avg_pool1d`` and autograd's gradients, and the autograd Function that
the card runs, under ``torch.func.vmap(torch.func.grad_and_value(...))``
over members, against the vmap of the plain path, within the stacked-member
bound of tests/test_ensemble.py (rtol 2e-4, atol 1e-6). The kernels
themselves are held to these plain versions in tests/test_torch_gpu.py."""

import pytest
import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.nn.layers import ConvEncoderSpec
from structured_latent_odes_tpu_torch.ops import conv_encoder as ce
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

# (channels, steps) of each workload's encoder; batch kept small on the CPU
SHAPES = {"cvs": (3, 86), "proc": (4, 100), "challenge": (4, 142)}
FILTERS, WIDTH, POOL, B, S = 10, 10, 5, 6, 3


def _args(name, members=0, seed=0):
    K, T = SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    lead = (members,) if members else ()
    x = torch.rand(lead + (B, K, T), generator=gen)
    w = (torch.rand(lead + (FILTERS, K, WIDTH), generator=gen) - 0.5) * 0.4
    b = torch.rand(lead + (FILTERS,), generator=gen) - 0.5
    n = FILTERS * (T - WIDTH + 2 - POOL)
    head = torch.randn(n, generator=gen) / n ** 0.5  # a linear layer's scale
    return x, w, b, head


def _loss(y, head):
    """A scalar of the front end's output, as the model's losses are: a mean
    over the batch."""
    return torch.mean(torch.tanh(y) @ head)


def _todays(x, w, b):
    """The encoder's front end as nn/layers.py wrote it before the op."""
    y = F.avg_pool1d(F.conv1d(x, w, b), kernel_size=POOL, stride=1)
    return y.reshape(y.shape[0], -1)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_versions_match_conv_pool_and_autograd(name):
    x, w, b, head = _args(name)
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = ce.conv_pool_fwd_plain(x, w, b, POOL)
    assert torch.equal(y, _todays(x, w, b))
    assert y.shape == (B, ConvEncoderSpec(n_channels=x.shape[1], n_time=x.shape[2]).flat_dim)
    g = torch.autograd.grad(_loss(y, head), y)[0]
    dx, dw, db = torch.autograd.grad(_todays(x, w, b), (x, w, b), g)
    pw, pb = ce.conv_pool_wgrad_plain(x.detach(), g, WIDTH, POOL)
    torch.testing.assert_close(pw, dw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pb, db, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ce.conv_pool_dx_plain(g, w.detach(), x.shape[-1], POOL), dx, rtol=1e-5, atol=1e-6)
    mw, mb = ce.conv_pool_wgrad_members_plain(x.detach()[None], g[None], WIDTH, POOL)
    assert torch.equal(mw[0], pw) and torch.equal(mb[0], pb)


@pytest.mark.parametrize("shared", [False, True], ids=["batched_x", "shared_x"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_function_under_vmap_grad_matches_todays_path(name, shared):
    """The Function the card runs, member-batched as the ensemble's stacked
    step runs it (each member its own batch) and as the val ELBO runs it (one
    batch for all members, not copied a member)."""
    x, w, b, head = _args(name, members=S)
    if shared:
        x = x[0]

    def run(front):
        fn = torch.func.grad_and_value(lambda p, obs: _loss(front(obs, *p), head))
        return torch.func.vmap(fn, in_dims=((0, 0), None if shared else 0))((w, b), x)

    (gw, gb), value = run(lambda obs, ww, bb: ce._ConvPool.apply(obs, ww, bb, POOL))
    (rw, rb), ref = run(_todays)
    for out, want in ((gw, rw), (gb, rb), (value, ref)):
        torch.testing.assert_close(out, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_observations_that_ask_for_a_gradient_get_it(name):
    x, w, b, head = _args(name)
    grad = torch.func.grad(lambda obs: _loss(ce._ConvPool.apply(obs, w, b, POOL), head))
    ref = torch.func.grad(lambda obs: _loss(_todays(obs, w, b), head))(x)
    torch.testing.assert_close(grad(x), ref, rtol=1e-5, atol=1e-6)
    dxs = torch.func.vmap(grad)(x[None].expand(S, *x.shape))
    for s in range(S):
        torch.testing.assert_close(dxs[s], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_workload_shapes_fit_and_the_limit_is_named(name):
    K, T = SHAPES[name]
    ce.check_fits("conv_pool_fwd", K, T, FILTERS, WIDTH, POOL)
    for backward in (False, True):
        assert ce.smem_bytes(K, T, FILTERS, WIDTH, POOL, backward) <= 48 * 1024
    with pytest.raises(ValueError, match="227 KB"):
        ce.check_fits("conv_pool_fwd", K, 100 * T, FILTERS, WIDTH, POOL)
    with pytest.raises(ValueError, match="no output"):
        ce.check_fits("conv_pool_fwd", K, WIDTH + POOL - 2, FILTERS, WIDTH, POOL)


def test_wrappers_refuse_mismatched_shapes():
    x, w, b, _ = _args("cvs")
    with pytest.raises(ValueError, match="shapes"):
        ce.conv_pool_fwd(x, w[:, :2], b, POOL)
    with pytest.raises(ValueError, match="shapes"):
        ce.conv_pool_fwd_members(x, w, b, POOL)
    with pytest.raises(ValueError, match="shapes"):
        ce.conv_pool_wgrad(x, torch.zeros(B, 7), WIDTH, POOL)

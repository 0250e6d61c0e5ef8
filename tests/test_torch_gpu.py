"""Kernels K1, K1-bwd, K2 and K3 and the conv encoder's pair of the PyTorch
port against their plain PyTorch versions, on a CUDA card. Marked ``gpu``; each test skips when no
card is present.

This file imports no JAX: the machine with the card has none. Run it there
with (``--noconftest`` skips tests/conftest.py, which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: K1 and K1-bwd compute exactly their plain versions' float32
operations, so they are held bit for bit (torch.equal). K2 and K3 sum the heads in
another order and use CUDA's expf: 1e-5 abs plus 1e-5 relative, the JAX
package's own tolerance for its fused kernel (tests/test_fused_step.py), on
the trajectory and on K3's dx0; K3's du sums 85 * S stage terms that cancel,
so its absolute part is scaled by max|du|. Trajectories at random
weights reach |x| of tens, where float32 roundoff accumulated over 85 steps
differs by about 1e-6 relative between two summation orders. K3's weight
gradients are sums over the batch, steps and stages in another order: each
leaf within 1e-5 of its largest value.

Beyond the kernels: a CVS run on semilinear_fused resumed from its
checkpoint is bit for bit the uninterrupted run, and the profiler trace of
an epoch names K2's and K3's kernels among its device events. The training
and eval epochs replayed as CUDA graphs are bit for bit the eager ones, with
the same launches, and so are a sweep's (the stacked step, the val ELBO,
the prior refit); the trainers replay graphs; a capture that fails raises;
a graph's eager first call, its capture and its replays are spans.
Serving's predict functions and the eval functions (the final test
evaluation, the sample bands) replayed are bit for bit the eager ones.
"""

import json
import os

import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch.data.configs import LOADERS, load_cvs_config
from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, init_params, proc_spec, recon
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec, initialize_state, ode_model_init
from structured_latent_odes_tpu_torch.ops import fused_step, recurrence

pytestmark = pytest.mark.gpu

SPECS = {"proc": proc_spec, "challenge": challenge_spec}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# K1 and K1-bwd (csrc/affine_scan.cu): a block owns four whole trajectories,
# each run copied into shared memory by one bulk copy, a thread per
# component. One step; one trajectory; a tile's ragged edge (3, 7, 130
# trajectories, where the last tile's run ends off a 16-byte boundary and the
# threads copy its tail); 199 steps (the backward's tile needs more than the
# default 48 KB of shared memory); D = 8; the serving, training and large
# batches; and the proc and challenge workloads' shapes: D = 8 over 99 steps
# at the training batch (36) and the val fold (78), 141 steps at challenge's
# padded training batch (32) and its val fold (7).
K1_SHAPES = [(1, 1, 5), (1, 85, 5), (3, 85, 5), (100, 85, 5), (128, 85, 5), (130, 199, 5), (7, 85, 8), (16411, 85, 5),
             (36, 99, 8), (78, 99, 8), (32, 141, 5), (7, 141, 5)]


def _k1_inputs(cuda, Bt, T, D):
    gen = torch.Generator().manual_seed(Bt * 1000 + T * 10 + D)
    A = (torch.rand((Bt, T, D), generator=gen) * 0.5 + 0.5).to(cuda)
    B = ((torch.rand((Bt, T, D), generator=gen) - 0.5) * 0.2).to(cuda)
    x0 = (torch.rand((Bt, D), generator=gen) * 2 - 1).to(cuda)
    g = (torch.rand((Bt, T + 1, D), generator=gen) - 0.5).to(cuda)
    return A, B, x0, g


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_affine_scan_kernel_matches_plain(cuda, shape):
    A, B, x0, _ = _k1_inputs(cuda, *shape)
    before = recurrence.affine_scan_fwd.launches
    out = recurrence.affine_scan_fwd(A, B, x0)
    torch.cuda.synchronize()
    assert recurrence.affine_scan_fwd.launches == before + 1
    assert torch.equal(out, recurrence.affine_scan_batched_plain(A, B, x0))


def _fused_args(cuda, grid, B=100, T=86, dataset="cvs"):
    cfg = LOADERS[dataset]()
    spec = cvs_spec(cfg) if dataset == "cvs" else SPECS[dataset](cfg, n_time=T)
    ode = init_params(spec, 0, device=cuda)["decoder"]["ode"]
    z = torch.randn((B, spec.latent_dim), generator=torch.Generator().manual_seed(1)).to(cuda)
    x0 = initialize_state(ode, z)
    if grid == "uniform":
        ts = torch.arange(float(T), device=cuda)
    else:
        ts = torch.tensor(np.cumsum(np.abs(np.random.RandomState(0).randn(T)) * 0.2 + 0.05),
                          dtype=torch.float32, device=cuda)
    W = ode["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
    return (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"], x0, ts)


@pytest.mark.parametrize("grid", ["uniform", "nonuniform"])
@pytest.mark.parametrize("method", fused_step.METHODS)
def test_fused_kernel_matches_plain(cuda, method, grid):
    args = _fused_args(cuda, grid)
    before = fused_step.fused_semilinear_fwd.launches
    out = fused_step.fused_semilinear_fwd(*args, method)
    torch.cuda.synchronize()
    assert fused_step.fused_semilinear_fwd.launches == before + 1
    ref = fused_step.fused_semilinear_fwd_plain(*args, method)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_affine_scan_bwd_kernel_matches_plain(cuda, shape):
    A, B, x0, g = _k1_inputs(cuda, *shape)
    xs = recurrence.affine_scan_batched_plain(A, B, x0)
    before = recurrence.affine_scan_bwd.launches
    out = recurrence.affine_scan_bwd(A, xs, g)
    torch.cuda.synchronize()
    assert recurrence.affine_scan_bwd.launches == before + 1
    for name, o, r in zip(("dA", "dB", "dx0"), out, recurrence.affine_scan_bwd_batched_plain(A, xs, g)):
        assert torch.equal(o, r), name


@pytest.mark.parametrize("shape", [(128, 85, 5), (7, 85, 8)])
def test_affine_scan_autograd_matches_plain_on_card(cuda, shape):
    """affine_scan under autograd on the card (K1, then K1-bwd: one launch
    each) against the plain batch-major versions: bit for bit, contiguous."""
    A, B, x0, g = _k1_inputs(cuda, *shape)
    leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
    fwd, bwd = recurrence.affine_scan_fwd.launches, recurrence.affine_scan_bwd.launches
    xs = recurrence.affine_scan(*leaves)
    grads = torch.autograd.grad(xs, leaves, g)
    torch.cuda.synchronize()
    assert recurrence.affine_scan_fwd.launches == fwd + 1 and recurrence.affine_scan_bwd.launches == bwd + 1
    ref = recurrence.affine_scan_batched_plain(A, B, x0)
    assert xs.is_contiguous() and torch.equal(xs.detach(), ref)
    for name, o, r in zip(("dA", "dB", "dx0"), grads, recurrence.affine_scan_bwd_batched_plain(A, ref, g)):
        assert o.is_contiguous() and torch.equal(o, r), name


def test_affine_scan_kernels_take_unaligned_views(cuda):
    """Contiguous views that start off a 16-byte boundary (one trajectory of
    425 floats into a larger tensor), which the bulk copy cannot take: the
    threads copy those runs."""
    A, B, x0, g = (t[1:] for t in _k1_inputs(cuda, 6, 85, 5))
    assert A.data_ptr() % 16 and g.data_ptr() % 16
    xs = recurrence.affine_scan_fwd(A, B, x0)
    torch.cuda.synchronize()
    assert torch.equal(xs, recurrence.affine_scan_batched_plain(A, B, x0))
    xs_view = torch.cat([xs[:1], xs])[1:]
    assert xs_view.data_ptr() % 16
    out = recurrence.affine_scan_bwd(A, xs_view, g)
    torch.cuda.synchronize()
    for name, o, r in zip(("dA", "dB", "dx0"), out, recurrence.affine_scan_bwd_batched_plain(A, xs, g)):
        assert torch.equal(o, r), name


def test_affine_scan_kernels_raise_past_shared_memory(cuda):
    """Four trajectories of 580 steps or more at D = 5 overfill a block's
    shared memory backward (967 or more forward): the wrappers raise and
    launch nothing."""
    A, B, x0, g = _k1_inputs(cuda, 2, 581, 5)
    xs = recurrence.affine_scan_fwd(A, B, x0)
    before = recurrence.affine_scan_bwd.launches
    with pytest.raises(ValueError, match="shared memory"):
        recurrence.affine_scan_bwd(A, xs, g)
    A, B, x0, _ = _k1_inputs(cuda, 2, 969, 5)
    with pytest.raises(ValueError, match="shared memory"):
        recurrence.affine_scan_fwd(A, B, x0)
    assert recurrence.affine_scan_bwd.launches == before


def test_affine_scan_time_major_on_card(cuda):
    """The time-major entry goes through the batch-major kernels with one
    component per trajectory: equal to the time-major plain version."""
    A, B, x0, _ = _k1_inputs(cuda, 1, 85, 777)
    A, B, x0 = A[0], B[0], x0[0]
    out = recurrence.affine_scan_tm(A, B, x0)
    torch.cuda.synchronize()
    assert torch.equal(out, recurrence.affine_scan_plain(A, B, x0))


@pytest.mark.parametrize("B", [128, 130])
@pytest.mark.parametrize("grid", ["uniform", "nonuniform"])
@pytest.mark.parametrize("method", fused_step.METHODS)
def test_fused_bwd_kernel_matches_plain(cuda, method, grid, B):
    args = _fused_args(cuda, grid, B)
    xs = fused_step.fused_semilinear_fwd(*args, method)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    bargs = (*args[:6], xs, g, args[7])
    before = fused_step.fused_semilinear_bwd.launches
    outs = fused_step.fused_semilinear_bwd(*bargs, method)
    torch.cuda.synchronize()
    assert fused_step.fused_semilinear_bwd.launches == before + 1
    _assert_bwd_close(outs, fused_step.fused_semilinear_bwd_plain(*bargs, method))


def _assert_bwd_close(outs, refs):
    for name, o, r in zip(("du", "dwt", "dwa", "dba", "dwd", "dbd", "dx0"), outs, refs):
        assert o.shape == r.shape, name
        if name == "dx0":
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5, msg=name)
        elif name == "du":  # a sum of stage terms that cancel: atol scaled by max|du|
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()), msg=name)
        else:
            assert float((o - r).abs().max()) <= 1e-5 * float(r.abs().max()), name


# The edges of the kernels' layout (csrc/fused_semilinear.cuh): a block owns
# one trajectory at a time and walks its steps in passes of up to 128, one
# thread per step. B = 1, 2 (one more than a block owns at a time), 130, and
# 4,000 (more than fit on the card at once, so blocks loop over
# trajectories); T = 2 (one step), 86 (the CVS grid) and 200 (199 steps: two
# passes, more steps than a block has threads).
@pytest.mark.parametrize("T", [2, 86, 200])
@pytest.mark.parametrize("B", [1, 2, 130, 4000])
@pytest.mark.parametrize("method", fused_step.METHODS)
def test_fused_kernels_edge_shapes(cuda, method, B, T):
    args = _fused_args(cuda, "nonuniform", B, T)
    xs = fused_step.fused_semilinear_fwd(*args, method)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs, fused_step.fused_semilinear_fwd_plain(*args, method), rtol=1e-5, atol=1e-5)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    bargs = (*args[:6], xs, g, args[7])
    outs = fused_step.fused_semilinear_bwd(*bargs, method)
    torch.cuda.synchronize()
    _assert_bwd_close(outs, fused_step.fused_semilinear_bwd_plain(*bargs, method))


# The proc and challenge workloads' shapes at their widths: proc's ODE state
# D = 8 (its own (H, D) = (25, 8) libraries) over T = 100 at the training
# batch and the val fold; challenge's T = 142 (141 steps, two passes of up to
# 128) at its padded training batch and its val fold. Uniform grids, as the
# workloads run them.
WORKLOAD_SHAPES = [("proc", 36, 100), ("proc", 78, 100), ("challenge", 32, 142), ("challenge", 7, 142)]


@pytest.mark.parametrize("shape", WORKLOAD_SHAPES, ids=[f"{d}-B{b}-T{t}" for d, b, t in WORKLOAD_SHAPES])
@pytest.mark.parametrize("method", fused_step.METHODS)
def test_fused_kernels_workload_shapes(cuda, method, shape):
    dataset, B, T = shape
    args = _fused_args(cuda, "uniform", B, T, dataset)
    assert args[0].shape == (B, 25) and args[6].shape == (B, 8 if dataset == "proc" else 5)
    fwd, bwd = fused_step.fused_semilinear_fwd.launches, fused_step.fused_semilinear_bwd.launches
    xs = fused_step.fused_semilinear_fwd(*args, method)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs, fused_step.fused_semilinear_fwd_plain(*args, method), rtol=1e-5, atol=1e-5)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    bargs = (*args[:6], xs, g, args[7])
    outs = fused_step.fused_semilinear_bwd(*bargs, method)
    torch.cuda.synchronize()
    assert (fused_step.fused_semilinear_fwd.launches, fused_step.fused_semilinear_bwd.launches) == (fwd + 1, bwd + 1)
    _assert_bwd_close(outs, fused_step.fused_semilinear_bwd_plain(*bargs, method))


def test_training_backends_agree_on_card(cuda):
    """Autograd through K1/K1-bwd and K2/K3 gives the plain backend's
    gradients: max|diff| / max(max|g_seq|, 1) < 5e-3 over every leaf, the
    JAX package's fused-vs-autodiff bound."""
    from structured_latent_odes_tpu_torch.models import elbo_main
    from structured_latent_odes_tpu_torch.train.svi import value_and_grad
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_cvs_config()
    gen = torch.Generator().manual_seed(2)
    batch = {"observations": torch.rand((64, 3, 86), generator=gen).to(cuda),
             "iext": (torch.rand((64, 1), generator=gen) > 0.5).float().to(cuda),
             "rtpr": (torch.rand((64, 1), generator=gen) > 0.5).float().to(cuda)}
    ts = torch.arange(86.0, device=cuda)
    grads = {}
    for backend in ("semilinear", "semilinear_seq", "semilinear_fused"):
        cfg.ode_backend = backend
        spec = cvs_spec(cfg)
        params = init_params(spec, 0, device=cuda)
        _, _, g = value_and_grad(lambda p: elbo_main(spec, p, 0, batch, ts), params)
        grads[backend] = tree_leaves(g)
    scale = max(max(float(g.abs().max()) for g in grads["semilinear_seq"]), 1.0)
    for backend in ("semilinear", "semilinear_fused"):
        err = max(float((a - b).abs().max()) for a, b in zip(grads[backend], grads["semilinear_seq"]))
        assert err / scale < 5e-3, backend


def test_served_backends_agree_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_cvs_config()
    obs = torch.rand((100, 3, 86), generator=torch.Generator().manual_seed(2)).to(cuda)
    ts = np.arange(86, dtype=np.float32)
    outs = {}
    for backend in ("semilinear", "semilinear_seq", "semilinear_fused"):
        cfg.ode_backend = backend
        spec = cvs_spec(cfg)
        params = init_params(spec, 0, device=cuda)
        with torch.inference_mode():
            outs[backend] = recon(spec, params, 0, {"observations": obs}, ts, True)
    # scaled by each output's largest value: the bands cancel to small values
    # while the state's roundoff stays absolute
    for backend in ("semilinear", "semilinear_fused"):
        for k, v in outs[backend].items():
            ref = outs["semilinear_seq"][k]
            assert float((v - ref).abs().max()) <= 1e-5 + 1e-5 * float(ref.abs().max()), (backend, k)


# C1: above the shared-memory cap the model's entry (affine_scan and its
# autograd node) splits the time axis into runs within the cap, copies each
# run contiguous, and carries the state (forward) and the adjoint (backward)
# across the seams: bit for bit the plain versions, in more than one launch.
@pytest.mark.parametrize("shape", [(2, 581, 5), (2, 969, 5), (16, 4096, 5), (16, 4096, 8), (3, 200, 40)],
                         ids=["T581", "T969", "T4096-D5", "T4096-D8", "D40"])
def test_affine_scan_splits_past_shared_memory(cuda, shape):
    A, B, x0, g = _k1_inputs(cuda, *shape)
    leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
    fwd, bwd = recurrence.affine_scan_fwd.launches, recurrence.affine_scan_bwd.launches
    xs = recurrence.affine_scan(*leaves)
    grads = torch.autograd.grad(xs, leaves, g)
    torch.cuda.synchronize()
    ref = recurrence.affine_scan_batched_plain(A, B, x0)
    assert xs.is_contiguous() and torch.equal(xs.detach(), ref)
    for name, o, r in zip(("dA", "dB", "dx0"), grads, recurrence.affine_scan_bwd_batched_plain(A, ref, g)):
        assert torch.equal(o, r), name
    assert recurrence.affine_scan_bwd.launches - bwd > 1
    assert recurrence.affine_scan_fwd.launches - fwd >= 1 + (shape[1] > 966 or shape[2] > 32)


def _members_args(cuda, S, B, T, dataset):
    """S members' K2 arguments at one shape: each member its own weights
    (init seeds 0..S-1) and latents."""
    cfg = LOADERS[dataset]()
    spec = cvs_spec(cfg) if dataset == "cvs" else SPECS[dataset](cfg, n_time=T)
    per = []
    for s in range(S):
        ode = init_params(spec, s, device=cuda)["decoder"]["ode"]
        z = torch.randn((B, spec.latent_dim), generator=torch.Generator().manual_seed(10 + s)).to(cuda)
        W = ode["dyn_hidden"]["W"]
        u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
        per.append((u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
                    initialize_state(ode, z)))
    args = tuple(torch.stack([p[i] for p in per]) for i in range(7))
    return args + (torch.arange(float(T), device=cuda),)


# The member-batched K2 and K3 (the ensemble's launch: member m on
# blockIdx.y) at the CVS sweep's shape (S = 10, B = 128, (H, D) = (25, 5))
# and the proc sweep's (S = 5, B = 36, (25, 8)): each member bit for bit a
# single-member launch on its slices, weight gradients included, and within
# the K2/K3 tolerances of the plain versions.
@pytest.mark.parametrize("case", [("cvs", 10, 128, 86), ("proc", 5, 36, 100)], ids=["cvs-S10", "proc-S5"])
@pytest.mark.parametrize("method", ["midpoint", "rk4", "dopri5"])
def test_member_batched_fused_kernels(cuda, case, method):
    dataset, S, B, T = case
    args = _members_args(cuda, S, B, T, dataset)
    fwd, bwd = fused_step.fused_semilinear_fwd_members.launches, fused_step.fused_semilinear_bwd_members.launches
    xs = fused_step.fused_semilinear_fwd_members(*args, method)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    outs = fused_step.fused_semilinear_bwd_members(*args[:6], xs, g, args[7], method)
    torch.cuda.synchronize()
    assert (fused_step.fused_semilinear_fwd_members.launches,
            fused_step.fused_semilinear_bwd_members.launches) == (fwd + 1, bwd + 1)
    for s in (0, S // 2, S - 1):
        one = tuple(a[s] for a in args[:7]) + (args[7],)
        assert torch.equal(xs[s], fused_step.fused_semilinear_fwd(*one, method))
        single = fused_step.fused_semilinear_bwd(*one[:6], xs[s], g[s], args[7], method)
        for name, o, r in zip(("du", "dwt", "dwa", "dba", "dwd", "dbd", "dx0"), outs, single):
            assert torch.equal(o[s], r), name
        torch.testing.assert_close(xs[s], fused_step.fused_semilinear_fwd_plain(*one, method), rtol=1e-5, atol=1e-5)
        _assert_bwd_close([o[s] for o in outs],
                          fused_step.fused_semilinear_bwd_plain(*one[:6], xs[s], g[s], args[7], method))


def _wide_args(cuda, H, D, B, T, L=15):
    """K2's arguments at any widths: the port's ODE init at (L, D, H), a
    non-uniform grid of T times."""
    spec = OdeModelSpec(latent_dim=L, ode_state_dim=D, ode_hidden_dim=H)
    ode = {k: v for k, v in ode_model_init(torch.Generator().manual_seed(H + D), spec).items()}
    ode = torch.utils._pytree.tree_map(lambda t: t.to(cuda), ode)
    z = torch.randn((B, L), generator=torch.Generator().manual_seed(B)).to(cuda)
    ts = torch.tensor(np.cumsum(np.abs(np.random.RandomState(0).randn(T)) * 0.2 + 0.05), dtype=torch.float32,
                      device=cuda)
    W = ode["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
    return (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
            initialize_state(ode, z), ts)


# Widths past one warp's lanes (ROADMAP C2): (40, 17) and (128, 32), where
# lanes stride over hidden units and state components, a thread owns several
# components' scans, and K3's passes shorten to fit shared memory (at
# (128, 32): 64 steps at midpoint, 27 at dopri5, so T = 200 takes several
# passes); B = 3 and 130, T = 2 (one step), 86 and 200.
@pytest.mark.parametrize("T", [2, 86, 200])
@pytest.mark.parametrize("B", [3, 130])
@pytest.mark.parametrize("width", [(40, 17), (128, 32)], ids=["H40-D17", "H128-D32"])
@pytest.mark.parametrize("method", ["midpoint", "dopri5"])
def test_fused_kernels_wide_widths(cuda, method, width, B, T):
    args = _wide_args(cuda, *width, B, T)
    xs = fused_step.fused_semilinear_fwd(*args, method)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs, fused_step.fused_semilinear_fwd_plain(*args, method), rtol=1e-5, atol=1e-5)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    bargs = (*args[:6], xs, g, args[7])
    outs = fused_step.fused_semilinear_bwd(*bargs, method)
    torch.cuda.synchronize()
    _assert_bwd_close(outs, fused_step.fused_semilinear_bwd_plain(*bargs, method))


@pytest.mark.parametrize("width", [(25, 5), (25, 8), (40, 17), (128, 32)], ids=["cvs", "proc", "H40-D17", "H128-D32"])
def test_fused_kernel_max_steps_mirror_the_libraries(cuda, width):
    """The wrappers' mirror of K2's and K3's shared-memory layout
    (kernel_max_steps, which refuses widths before any build) agrees with
    the steps a pass each built library reports, at every method."""
    for method in fused_step.METHODS:
        for backward in (False, True):
            assert fused_step.library_max_steps(*width, method, backward) == \
                fused_step.kernel_max_steps(*width, method, backward), (method, backward)


def test_fused_kernels_refuse_past_shared_memory(cuda):
    """(H, D) = (512, 64): not one step of K2 fits in a block's 227 KB; the
    wrapper raises a ValueError naming the limit, before nvcc runs."""
    args = _wide_args(cuda, 512, 64, 2, 5)
    with pytest.raises(ValueError, match="shared memory"):
        fused_step.fused_semilinear_fwd(*args, "midpoint")


def test_semilinear_auto_launches_the_path_it_picks(cuda):
    """semilinear_auto on the card at CVS's widths takes the fused path (the
    H100's crossover, nn/ode_model.py): one K2 launch forward, one K3
    backward, no K1; its result within 1e-5 + 1e-5 * |x| of semilinear's."""
    from structured_latent_odes_tpu_torch.nn.ode_model import auto_picks_fused, solve_ode

    spec = OdeModelSpec(latent_dim=15, ode_state_dim=5, ode_hidden_dim=25, backend="semilinear_auto")
    ode = torch.utils._pytree.tree_map(lambda t: t.to(cuda).requires_grad_(),
                                       ode_model_init(torch.Generator().manual_seed(0), spec))
    z = torch.randn((128, 15), generator=torch.Generator().manual_seed(1)).to(cuda)
    ts = torch.arange(86.0, device=cuda)
    assert auto_picks_fused(spec, z)
    counts = (fused_step.fused_semilinear_fwd.launches, fused_step.fused_semilinear_bwd.launches,
              recurrence.affine_scan_fwd.launches)
    out = solve_ode(spec, ode, z, ts)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (fused_step.fused_semilinear_fwd.launches, fused_step.fused_semilinear_bwd.launches,
            recurrence.affine_scan_fwd.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    ref = solve_ode(OdeModelSpec(15, 5, 25, backend="semilinear"), ode, z, ts)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["batchwide", "per_sample"])
def test_adaptive_trip_graph_replays_match_eager_trips(cuda, per_row):
    """The adaptive solvers on the card replay a CUDA graph of a loop trip
    from the third trip on (ode/solvers.py::_Trip): the same operations as
    the trips run eagerly, so the solve, its trip count and its accepted
    steps are bit for bit those of an eager solve; and so are the adaptive
    adjoint's gradients (the augmented system's trips, each stage a
    vector-Jacobian product, replayed)."""
    from structured_latent_odes_tpu_torch.nn import ode_model
    from structured_latent_odes_tpu_torch.ode import solvers

    spec = OdeModelSpec(latent_dim=15, ode_state_dim=5, ode_hidden_dim=25,
                        backend="adaptive_per_sample" if per_row else "adaptive")
    ode = torch.utils._pytree.tree_map(lambda t: t.to(cuda), ode_model_init(torch.Generator().manual_seed(0), spec))
    z = torch.randn((16, 15), generator=torch.Generator().manual_seed(1)).to(cuda)
    ts = torch.arange(12.0, device=cuda)

    def run(graphs: bool):
        warm = solvers._Trip.__init__

        def init(self, trip, device):
            warm(self, trip, device)
            if not graphs:
                self.plain = True

        solvers._Trip.__init__ = init
        try:
            counter = solvers.odeint_adaptive_per_sample.trips if per_row else solvers.odeint_adaptive.trips
            before = dict(counter)
            leaves = [t.detach().requires_grad_() for t in torch.utils._pytree.tree_leaves(ode)]
            params = torch.utils._pytree.tree_unflatten(leaves, torch.utils._pytree.tree_structure(ode))
            out = ode_model.solve_ode(spec, params, z, ts)
            grads = torch.autograd.grad(out.square().sum(), leaves)
            torch.cuda.synchronize()
            return out.detach(), grads, {k: counter[k] - before.get(k, 0) for k in ("trips", "accepted")}
        finally:
            solvers._Trip.__init__ = warm

    out, grads, trips = run(True)
    ref, ref_grads, ref_trips = run(False)
    assert trips == ref_trips and trips["trips"] > 3
    assert torch.equal(out, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def _cvs_run(cuda, data_dir, root, *extra):
    from structured_latent_odes_tpu_torch import training_cvs

    return training_cvs.main(["--data-path", data_dir, "--results-root", str(root), "--no-plot", "--ode-backend",
                              "semilinear_fused", "--mini-batch-size", "16", "--device", str(cuda), *extra])


@pytest.fixture
def tiny_cvs(cuda, tmp_path):
    from structured_latent_odes_tpu_torch.data.cvs import make_dataset

    d = str(tmp_path / "cvs")
    make_dataset(d, data_size=60, seed=0, device=cuda)
    return d


def _arrays(rd):
    """Every leaf of train_state.npz and best_model.npz and every .npy."""
    out = {}
    for npz in ("train_state.npz", "best_model.npz"):
        with np.load(os.path.join(rd, npz)) as z, open(os.path.join(rd, npz + ".json")) as f:
            out.update({f"{npz}:{p}": z[f"leaf_{i}"] for i, p in enumerate(json.load(f)["paths"])})
    out.update({n: np.load(os.path.join(rd, n)) for n in os.listdir(rd) if n.endswith(".npy")})
    return out


def test_cvs_resume_is_bit_equal_on_card(cuda, tiny_cvs, tmp_path):
    """Epochs 0-1 of CVS on semilinear_fused (full width, 60 trajectories)
    uninterrupted, against epoch 0 and --resume to epoch 1: every array bit
    for bit equal, and the resumed run launches K2 and K3."""
    full = _cvs_run(cuda, tiny_cvs, tmp_path / "full", "--num-epochs", "1", "--checkpoint-every", "1")
    _cvs_run(cuda, tiny_cvs, tmp_path / "part", "--num-epochs", "0", "--checkpoint-every", "1")
    k2, k3 = fused_step.fused_semilinear_fwd.launches, fused_step.fused_semilinear_bwd.launches
    resumed = _cvs_run(cuda, tiny_cvs, tmp_path / "part", "--num-epochs", "1", "--checkpoint-every", "1", "--resume")
    assert fused_step.fused_semilinear_fwd.launches > k2 and fused_step.fused_semilinear_bwd.launches > k3
    a, b = _arrays(full["out_dir"]), _arrays(resumed["out_dir"])
    assert sorted(a) == sorted(b) and len(a) > 100
    for name in a:
        assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


def test_profiler_trace_names_the_fused_kernels(cuda, tiny_cvs, tmp_path):
    _cvs_run(cuda, tiny_cvs, tmp_path / "run", "--num-epochs", "1", "--profile-dir", str(tmp_path / "prof"))
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    for pattern in ("fused_semilinear_fwd_kernel", "fused_semilinear_bwd_kernel"):
        assert any(pattern in k for k in kernels), (pattern, sorted(kernels)[:20])


# Phase 10 of chip_smoke.py as tests: two spawned ranks sharing the card
# over gloo (NCCL refuses two ranks on one GPU) and an NCCL group of one
# rank, running chip_smoke's rank functions at the CVS widths on a random
# batch of 32. The parent computes the one-device references; the bounds are
# chip_smoke's (the JAX package's tests/test_parallel.py and
# tests/test_timepar.py).
RANK_B = 32


@pytest.fixture(scope="module")
def rank_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from structured_latent_odes_tpu_torch.parallel import launch

    with launch.RankPool(2, device="cuda:0", backend="gloo", timeout_s=300, threads=2, quiet=True) as pool:
        yield pool


def _leaves_np(tree):
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    return [x if isinstance(x, np.ndarray) else x.detach().cpu().numpy() for x in tree_leaves(tree)]


def _rank_case(cuda, backend):
    """chip_smoke's phase-10 case dict at RANK_B rows, and the one-device
    dual step on the same params, batch and seed, in full float32 with
    deterministic cuDNN, as the ranks and the trainers run."""
    import chip_smoke
    from structured_latent_odes_tpu_torch.train.driver import device_batch
    from structured_latent_odes_tpu_torch.utils.device import full_fp32

    full_fp32(deterministic=True)

    r = np.random.RandomState(0)
    batch = {"observations": r.rand(RANK_B, 3, 86).astype(np.float32),
             "iext": (r.rand(RANK_B, 1) > 0.5).astype(np.float32), "rtpr": (r.rand(RANK_B, 1) > 0.5).astype(np.float32),
             "mask": np.ones(RANK_B, np.float32), "sample_id": np.arange(RANK_B, dtype=np.int32)}
    times = np.arange(86.0, dtype=np.float32)
    cfg = chip_smoke._config("unused", backend)
    params = init_params(cvs_spec(cfg), 0, device=cuda)
    case = dict(params=chip_smoke._np_tree(params), batch=batch, times=times, seed=5, lr=cfg.learning_rate,
                device="cuda:0", data_dir="unused", steps=1, workload="cvs")
    ref = chip_smoke._one_device_step(cvs_spec(cfg), params, device_batch(batch, cuda), torch.as_tensor(times,
                                      device=cuda), cfg.learning_rate, 5)
    return case, ref, params


def test_dp_step_through_an_nccl_group_of_one_is_the_one_device_step(cuda, rank_pool):
    import chip_smoke

    case, (state, mets, _, grads), _ = _rank_case(cuda, "semilinear_fused")
    out = rank_pool.run(chip_smoke._rank_dp_step, dict(case, ranks=[0], group_backend="nccl",
                                                        backend="semilinear_fused"))[0]
    assert out["loss_main"] == float(mets["loss_main"]) and out["loss_aux"] == float(mets["loss_aux"])
    for a, b in zip(_leaves_np([out["params"], out["grads"]]), _leaves_np([state.params, grads])):
        assert np.array_equal(a, b)
    assert out["counts"]["K2"] > 0 and out["counts"]["K3"] > 0


# the kernels a rank's dual step launches, and no other: its backend's and
# its encoder's conv pair (main and aux)
DP_STEP_KERNELS = [("semilinear_fused", ("K2", "K3", "conv_pool_fwd", "conv_pool_wgrad")),
                   ("semilinear", ("K1", "K1-bwd", "conv_pool_fwd", "conv_pool_wgrad"))]


@pytest.mark.parametrize("backend,kernels", DP_STEP_KERNELS)
def test_dp_step_on_two_ranks_sharing_the_card(cuda, rank_pool, backend, kernels):
    import chip_smoke

    case, (state, mets, _, grads), _ = _rank_case(cuda, backend)
    outs = rank_pool.run(chip_smoke._rank_dp_step, dict(case, ranks=[0, 1], group_backend="gloo", backend=backend))
    for out in outs:
        assert out["rows"] == RANK_B // 2
        assert chip_smoke.grad_ratio(out["grads"], grads) <= 1.0
        for k in ("loss_main", "loss_aux"):
            np.testing.assert_allclose(out[k], float(mets[k]), rtol=chip_smoke.DP_LOSS_RTOL)
        for a, b in zip(_leaves_np(out["params"]), _leaves_np(state.params)):
            np.testing.assert_allclose(a, b, rtol=chip_smoke.DP_PARAM_RTOL, atol=chip_smoke.DP_PARAM_ATOL)
        assert all(out["counts"][k] > 0 for k in kernels)
        assert not any(n for k, n in out["counts"].items() if k not in kernels)
    for a, b in zip(_leaves_np(outs[0]["params"]), _leaves_np(outs[1]["params"])):
        assert np.array_equal(a, b)


def test_time_parallel_step_and_recurrence_on_two_ranks(cuda, rank_pool):
    """The horizon over the two ranks (semilinear_timepar: K1 and K1-bwd on
    each rank's chunk): the solve's values, the main loss's gradients and a
    dual step against one device on semilinear, and the recurrence of 4096
    steps against K1."""
    _check_time_parallel(cuda, rank_pool, (1, 2), "cuda:0")


def _check_time_parallel(cuda, pool, grid, device):
    """chip_smoke's time-parallel case on ``pool``'s ranks, on the
    (data, model) ``grid``, against one device."""
    import chip_smoke
    from structured_latent_odes_tpu_torch.nn.ode_model import solve_ode
    from structured_latent_odes_tpu_torch.train import svi
    from structured_latent_odes_tpu_torch.train.driver import device_batch
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    case, (state, mets, _, _), params = _rank_case(cuda, "semilinear")
    gen = torch.Generator().manual_seed(10)
    long = (torch.rand((RANK_B, 4095, 5), generator=gen) * 0.05 + 0.95,
            (torch.rand((RANK_B, 4095, 5), generator=gen) - 0.5) * 0.02, torch.rand((RANK_B, 5), generator=gen))
    z = torch.randn((RANK_B, 15), generator=gen)
    outs = pool.run(chip_smoke._rank_tp_case, dict(case, device=device, grid=grid, z=z.numpy(),
                                                   long=[t.numpy() for t in long]))
    spec = cvs_spec(chip_smoke._config("unused", "semilinear"))
    ts = torch.arange(86.0, device=cuda)
    with torch.no_grad():
        ref_solve = solve_ode(spec.decoder.ode, params["decoder"]["ode"], z.to(cuda), ts).cpu().numpy()
    _, _, ref_grads = svi.value_and_grad(svi.make_losses(spec, ts)[0], params, 7, device_batch(case["batch"], cuda))
    ref_long = recurrence.affine_scan(*(t.to(cuda) for t in long)).cpu().numpy()
    for out in outs:
        np.testing.assert_allclose(out["solve"], ref_solve, atol=chip_smoke.TP_VALUE_ATOL,
                                   rtol=chip_smoke.TP_VALUE_RTOL)
        for a, b in zip(_leaves_np(out["grads"]), _leaves_np(ref_grads)):
            np.testing.assert_allclose(a, b, rtol=chip_smoke.TP_RTOL, atol=chip_smoke.TP_ATOL)
        np.testing.assert_allclose(out["long"], ref_long, atol=chip_smoke.TP_VALUE_ATOL)
        np.testing.assert_allclose(out["loss_main"], float(mets["loss_main"]), rtol=chip_smoke.DP_LOSS_RTOL)
        for a, b in zip(_leaves_np(out["params"]), tree_leaves(state.params)):
            np.testing.assert_allclose(a, b.cpu().numpy(), rtol=chip_smoke.TP_RTOL, atol=chip_smoke.TP_ATOL)
        assert out["counts"]["K1"] > 0 and out["counts"]["K1-bwd"] > 0 and out["long_counts"]["K1"] > 0
        assert out["counts"]["K2"] == 0 and out["counts"]["K3"] == 0


# Phase 10's (b) and (c) at proc and challenge (ROADMAP C6): chip_smoke's
# RankInputs of the workload (its datasets/, its first training batch, its
# horizon and widths) and rank functions, under chip_smoke's bounds, with
# the launches of each rank held to the path's kernels.
@pytest.fixture(scope="module", params=["proc", "challenge"])
def workload_inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from structured_latent_odes_tpu_torch.utils.device import full_fp32

    full_fp32(deterministic=True)
    return chip_smoke.RankInputs(torch.device("cuda"), "unused", False, request.param)


def _held(hold, *args):
    """A chip_smoke check (which exits on a fault) as a test's failure."""
    try:
        return hold(*args)
    except SystemExit as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_workload_dp_step_on_two_ranks_sharing_the_card(cuda, rank_pool, workload_inputs, backend):
    import chip_smoke

    inp = workload_inputs
    outs = rank_pool.run(chip_smoke._rank_dp_step, dict(inp.base, device="cuda:0", ranks=[0, 1],
                                                         group_backend="gloo", backend=backend))
    assert [o["rows"] for o in outs] == [inp.B // 2] * 2
    _held(chip_smoke._hold_dp, f"{inp.wl} dp2 {backend}", outs, inp, backend, {}, False)


def test_workload_time_parallel_on_two_ranks(cuda, rank_pool, workload_inputs):
    import chip_smoke

    outs = rank_pool.run(chip_smoke._rank_tp_case, workload_inputs.tp_case("cuda:0", (1, 2)))
    _held(chip_smoke._hold_tp, f"{workload_inputs.wl} tp2", outs, workload_inputs, {}, False)


# Phase 11 of chip_smoke.py as tests, where the machine has four cards or
# more: four ranks spawned once, rank r on cuda:r, over NCCL, running
# chip_smoke's rank functions on the batch of RANK_B rows under phase 10's
# bounds; skipped on fewer cards.
@pytest.fixture(scope="module")
def card_pool():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from structured_latent_odes_tpu_torch.parallel import launch

    with launch.RankPool(4, device="cuda", timeout_s=300, threads=2, quiet=True) as pool:
        yield pool


def test_ranks_take_a_card_each(card_pool):
    import chip_smoke

    assert [c.split()[0] for c in card_pool.run(chip_smoke._rank_card)] == [f"cuda:{r}" for r in range(4)]


@pytest.mark.parametrize("backend,kernels", DP_STEP_KERNELS)
def test_dp_step_over_four_cards(cuda, card_pool, backend, kernels):
    import chip_smoke

    case, (state, mets, _, grads), _ = _rank_case(cuda, backend)
    outs = card_pool.run(chip_smoke._rank_dp_step, dict(case, device="cuda", ranks=[0, 1, 2, 3], group_backend=None,
                                                         backend=backend))
    for out in outs:
        assert out["rows"] == RANK_B // 4
        assert chip_smoke.grad_ratio(out["grads"], grads) <= 1.0
        for k in ("loss_main", "loss_aux"):
            np.testing.assert_allclose(out[k], float(mets[k]), rtol=chip_smoke.DP_LOSS_RTOL)
        for a, b in zip(_leaves_np(out["params"]), _leaves_np(state.params)):
            np.testing.assert_allclose(a, b, rtol=chip_smoke.DP_PARAM_RTOL, atol=chip_smoke.DP_PARAM_ATOL)
        assert all(out["counts"][k] > 0 for k in kernels)
        assert not any(n for k, n in out["counts"].items() if k not in kernels)
    for out in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(_leaves_np(out["params"]), _leaves_np(outs[0]["params"])))


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)], ids=["data2-time2", "time4"])
def test_time_parallel_over_four_cards(cuda, card_pool, grid):
    _check_time_parallel(cuda, card_pool, grid, "cuda")


def test_data_parallel_past_the_cards_raises_before_any_launch(cuda, tmp_path):
    from structured_latent_odes_tpu_torch import training_cvs

    n = torch.cuda.device_count()
    launches = [(w, w.launches) for w in (recurrence.affine_scan_fwd, fused_step.fused_semilinear_fwd)]
    with pytest.raises(ValueError, match=rf"> {n} available devices"):
        training_cvs.main(["--num-epochs", "1", "--no-plot", "--data-parallel", str(n + 1), "--data-path",
                           str(tmp_path), "--results-root", str(tmp_path)])
    assert all(w.launches == before for w, before in launches)


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_workload_dp_step_over_four_cards(cuda, card_pool, workload_inputs, backend):
    """Phase 11 (a) at proc (9 rows a card) and challenge (8)."""
    import chip_smoke

    inp = workload_inputs
    outs = card_pool.run(chip_smoke._rank_dp_step, dict(inp.base, device="cuda", ranks=[0, 1, 2, 3],
                                                         group_backend=None, backend=backend))
    assert [o["rows"] for o in outs] == [inp.B // 4] * 4
    _held(chip_smoke._hold_dp, f"{inp.wl} dp4 {backend}", outs, inp, backend, {}, False)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)], ids=["data2-time2", "time4"])
def test_workload_time_parallel_over_four_cards(cuda, card_pool, workload_inputs, grid):
    """Phase 11 (b) at proc's 99 steps and challenge's 141."""
    import chip_smoke

    outs = card_pool.run(chip_smoke._rank_tp_case, workload_inputs.tp_case("cuda", grid))
    _held(chip_smoke._hold_tp, f"{workload_inputs.wl} dp{grid[0]} tp{grid[1]}", outs, workload_inputs, {}, False)


# The CUDA graphs of the training step and the eval epochs (train/svi.py,
# utils/graphs.py; chip_smoke.py phase 12 at full width): at CVS widths on
# 60 generated trajectories, batches of 16.
def _counts():
    return [w.launches for w in (recurrence.affine_scan_fwd, recurrence.affine_scan_bwd,
                                 fused_step.fused_semilinear_fwd, fused_step.fused_semilinear_bwd)]


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_epochs_replay_bit_for_bit_eager_on_card(cuda, tiny_cvs, backend):
    """Two training epochs from one state, replayed (the first warms up and
    captures) and eager: states, counts and metrics bit for bit equal, the
    kernels' launches equal; each eval epoch twice, bit for bit eager."""
    from structured_latent_odes_tpu_torch import training_cvs
    from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
    from structured_latent_odes_tpu_torch.train import svi
    from structured_latent_odes_tpu_torch.train.driver import device_batch
    from structured_latent_odes_tpu_torch.utils.device import full_fp32
    from structured_latent_odes_tpu_torch.utils.graphs import Graph
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    full_fp32(deterministic=True)
    cfg = load_cvs_config()
    cfg.data_path, cfg.ode_backend = tiny_cvs, backend
    splits, _ = training_cvs.build_splits(cfg, device=cuda)
    spec = cvs_spec(cfg)
    assert svi.epoch_dispatch(spec, cuda) == "cuda graph"
    ts = torch.arange(86.0, device=cuda)
    params = init_params(spec, 0, device=cuda)
    batches = device_batch(stacked_minibatches(splits["train"], 16, shuffle=True, rng=np.random.RandomState(0)), cuda)
    init_state, _, eager = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch="eager")
    _, _, graphed = svi.make_train_step(spec, ts, cfg.learning_rate, params)
    assert graphed.dispatch == "cuda graph"
    s_e, s_g = init_state(params, 5), init_state(params, 5)
    for _ in range(2):
        c0 = _counts()
        s_e, m_e = eager(s_e, batches)
        c1, r1 = _counts(), Graph.replays
        s_g, m_g = graphed(s_g, batches)
        torch.cuda.synchronize()
        assert Graph.replays > r1 and [b - a for a, b in zip(c0, c1)] == [b - a for a, b in zip(c1, _counts())]
        assert [s.count for s in svi._slots(s_e.opt)] == [s.count for s in svi._slots(s_g.opt)]
        assert s_e.step == s_g.step
        for a, b in zip(svi._tensors(s_e) + tree_leaves(m_e), svi._tensors(s_g) + tree_leaves(m_g)):
            assert torch.equal(a, b)
    stack = device_batch(stacked_minibatches(splits["val"], 16, shuffle=False), cuda)
    eager_eval, graph_eval = svi.make_eval_epoch(spec, ts, dispatch="eager"), svi.make_eval_epoch(spec, ts)
    for is_post in (True, False):
        ref = eager_eval(s_e.params, 9, stack, is_post)
        for _ in range(2):
            got = graph_eval(s_e.params, 9, stack, is_post)
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ref), tree_leaves(got)))


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_sweep_epochs_replay_bit_for_bit_eager_on_card(cuda, tiny_cvs, backend, capsys):
    """Three members, two epochs and a refit epoch through
    sweep.train_ensemble, replayed (the stacked dual step, the val ELBO and
    the refit's update as CUDA graphs) and eager: every number of the
    result bit for bit equal, the kernels' launches equal."""
    from structured_latent_odes_tpu_torch import sweep
    from structured_latent_odes_tpu_torch.train import svi
    from structured_latent_odes_tpu_torch.utils.device import full_fp32
    from structured_latent_odes_tpu_torch.utils.graphs import Graph
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    full_fp32(deterministic=True)
    cfg = sweep.load_base_config("cvs")
    cfg.data_path, cfg.mini_batch_size, cfg.num_epochs, cfg.ode_backend = tiny_cvs, 16, 1, backend
    cfg.prior_refit_epochs = 1
    members = [sweep.prepare_member("cvs", cfg, seed, cuda) for seed in (3, 4, 5)]
    counts = [_counts()]
    eager = sweep.train_ensemble(members, device=cuda, dispatch="eager")
    counts.append(_counts())
    replays = Graph.replays
    got = sweep.train_ensemble(members, device=cuda)
    torch.cuda.synchronize()
    counts.append(_counts())
    out = capsys.readouterr().out
    assert out.count("epoch dispatch: eager\n") == out.count("epoch dispatch: cuda graph\n") == 1
    assert Graph.replays > replays
    assert [b - a for a, b in zip(counts[0], counts[1])] == [b - a for a, b in zip(counts[1], counts[2])]
    assert [s.count for s in svi._slots(eager.state.opt)] == [s.count for s in svi._slots(got.state.opt)]
    for a, b in zip(svi._tensors(eager.state) + tree_leaves(eager.best_params),
                    svi._tensors(got.state) + tree_leaves(got.best_params)):
        assert torch.equal(a, b)
    assert np.array_equal(eager.best_crit, got.best_crit) and np.array_equal(eager.best_epoch, got.best_epoch)
    assert all(np.array_equal(eager.history[k], got.history[k]) for k in eager.history)


def test_trainer_replays_graphs_on_card(cuda, tiny_cvs, tmp_path, capsys):
    """training_cvs on the card prints its epoch dispatch, a CUDA graph, and
    its epochs replay graphs."""
    from structured_latent_odes_tpu_torch.utils.graphs import Graph

    replays = Graph.replays
    _cvs_run(cuda, tiny_cvs, tmp_path / "run", "--num-epochs", "1")
    assert "epoch dispatch: cuda graph" in capsys.readouterr().out
    assert Graph.replays > replays


def test_failed_capture_raises_on_card(cuda):
    """A body that reads a value on the host cannot be captured: the capture
    raises, and the helper does not fall back to running it eagerly."""
    from structured_latent_odes_tpu_torch.utils.graphs import Graph

    buf = torch.ones(4, device=cuda)

    def body():
        buf.mul_(2.0)
        return {"host": torch.tensor(float(buf.sum().item()), device=cuda)}

    graph = Graph(body, cuda, warm=0)
    with pytest.raises(RuntimeError):
        graph()
    assert graph.graph is None
    torch.cuda.synchronize()


def test_graph_records_warm_capture_then_replays_on_card(cuda):
    """A graph's first call is one ``graph.warm`` span, its second one
    ``graph.capture`` (with the replay that follows it), and every later
    call one ``graph.replay`` alone (``utils/profiling.py``)."""
    import time

    from structured_latent_odes_tpu_torch.utils.graphs import Graph
    from structured_latent_odes_tpu_torch.utils.profiling import SPANS

    buf = torch.zeros(4, device=cuda)

    def body():
        buf.add_(1.0)
        return {"sum": buf.sum()}

    graph = Graph(body, cuda)
    calls = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        out = graph()
        calls.append([s[0] for s in SPANS if s[2] >= t0])
    assert calls == [["graph.warm"], ["graph.capture", "graph.replay"]] + [["graph.replay"]] * 3
    assert float(out["sum"]) == 4 * 5.0  # the warm call and four replays: the capture ran nothing


# Serving's predict functions and the eval functions as CUDA graphs
# (serve.make_predict_fns, svi.make_eval_fns; chip_smoke.py phase 14 at full
# width): at CVS widths on the same 60 trajectories.
@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_predict_fns_replay_bit_for_bit_eager_on_card(cuda, tiny_cvs, backend):
    """Posterior, prior and classifier requests, replayed (the first call
    warms up, the second captures) and eager, bit for bit equal with the
    kernels' launches equal; the first request made in inference mode, a
    second on other params at another seed."""
    from structured_latent_odes_tpu_torch import serve, training_cvs
    from structured_latent_odes_tpu_torch.utils.graphs import Graph
    from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

    cfg = load_cvs_config()
    cfg.data_path, cfg.ode_backend = tiny_cvs, backend
    splits, _ = training_cvs.build_splits(cfg, device=cuda)
    spec = cvs_spec(cfg)
    times = np.arange(86.0, dtype=np.float32)
    eager = serve.make_predict_fns(spec, times, cuda, dispatch="eager")
    graphed = serve.make_predict_fns(spec, times, cuda)
    assert [f.dispatch for f in graphed] == ["cuda graph", "cuda graph"]
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in splits["test"].items()}
    replays = Graph.replays
    for i, (seed, params) in enumerate([(3, init_params(spec, 0, device=cuda))] * 3
                                       + [(8, init_params(spec, 1, device=cuda))]):
        for is_post in (True, False):
            c0 = _counts()
            ref = eager[0](params, seed, batch, is_post)
            c1 = _counts()
            if i == 0:
                with torch.inference_mode():
                    got = graphed[0](params, seed, batch, is_post)
            else:
                got = graphed[0](params, seed, batch, is_post)
            torch.cuda.synchronize()
            assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in zip(c1, _counts())]
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ref), tree_leaves(got)))
        ref, got = eager[1](params, seed, batch["observations"]), graphed[1](params, seed, batch["observations"])
        assert all(torch.equal(ref[k], got[k]) for k in ref)
    assert Graph.replays - replays == 3 * 3  # three graphs, each replayed from its second call on


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_eval_fns_replay_bit_for_bit_eager_on_card(cuda, tiny_cvs, backend):
    """The final test evaluation (eval_split posterior and prior) and the
    sample bands' draws through the replayed eval functions, bit for bit
    what the eager functions give."""
    from structured_latent_odes_tpu_torch import training_challenge, training_cvs
    from structured_latent_odes_tpu_torch.train import driver, svi
    from structured_latent_odes_tpu_torch.utils.graphs import Graph

    cfg = load_cvs_config()
    cfg.data_path, cfg.ode_backend = tiny_cvs, backend
    splits, _ = training_cvs.build_splits(cfg, device=cuda)
    spec = cvs_spec(cfg)
    ts = torch.arange(86.0, device=cuda)
    eager, graphed = svi.make_eval_fns(spec, ts, dispatch="eager"), svi.make_eval_fns(spec, ts)
    assert {f.dispatch for f in graphed} == {"cuda graph"}
    params = init_params(spec, 0, device=cuda)
    replays = Graph.replays
    ref = driver.final_test_eval(spec, params, 4, splits["train"], eager, 16)
    got = driver.final_test_eval(spec, params, 4, splits["train"], graphed, 16)
    assert Graph.replays > replays
    for a, b in zip(ref, got):
        assert a.elbo == b.elbo and a.l1 == b.l1 and a.label_metrics == b.label_metrics
        assert all(np.array_equal(a.recon[k], b.recon[k]) for k in a.recon)
    batch = driver.device_batch(splits["test"], cuda)
    for is_post in (True, False):
        ref = training_challenge.multiple_samples(eager[2], params, 5, batch, 4, is_post)
        got = training_challenge.multiple_samples(graphed[2], params, 5, batch, 4, is_post)
        assert all(np.array_equal(ref[k], got[k]) for k in ref)


# The conv encoder's front end (csrc/conv_encoder.cu): the forward and the
# weight-gradient kernels at the three workloads' encoders, (B, K, T) of the
# training batch with 10 filters of width 10 and a pool of 5, and proc's
# stacked step, 10 members x 36. Against the plain versions in float64 on the
# CPU (the card's F.conv1d would be cuDNN's, in TF32 unless told otherwise):
# the forward elementwise within 1e-5 + 1e-5 * |ref| (40 products and 5 means
# an output, in another order); each weight-gradient leaf, a sum of B * n_conv
# products, within 1e-5 of its largest value, as K3's.
CONV_SHAPES = {"cvs": (0, 128, 3, 86), "proc": (0, 36, 4, 100), "challenge": (0, 32, 4, 142),
               "proc-S10": (10, 36, 4, 100)}


def _conv_args(cuda, S, B, K, T, seed=0):
    from structured_latent_odes_tpu_torch.ops import conv_encoder

    gen = torch.Generator().manual_seed(seed)
    lead = (S,) if S else ()
    x = torch.rand(lead + (B, K, T), generator=gen)
    w = (torch.rand(lead + (10, K, 10), generator=gen) - 0.5) * 0.4
    b = torch.rand(lead + (10,), generator=gen) - 0.5
    g = torch.randn(lead + (B, 10 * (T - 13)), generator=gen)
    return conv_encoder, tuple(t.to(cuda) for t in (x, w, b, g))


def _conv_launch(ce, S, x, w, b, g):
    if S:
        return ce.conv_pool_fwd_members(x, w, b, 5), ce.conv_pool_wgrad_members(x, g, 10, 5)
    return ce.conv_pool_fwd(x, w, b, 5), ce.conv_pool_wgrad(x, g, 10, 5)


@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv_encoder_kernels_match_plain(cuda, name):
    S = CONV_SHAPES[name][0]
    ce, (x, w, b, g) = _conv_args(cuda, *CONV_SHAPES[name])
    counters = (ce.conv_pool_fwd_members, ce.conv_pool_wgrad_members) if S else (ce.conv_pool_fwd, ce.conv_pool_wgrad)
    before = [c.launches for c in counters]
    y, (dw, db) = _conv_launch(ce, S, x, w, b, g)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    x64, w64, b64, g64 = (t.cpu().double() for t in (x, w, b, g))
    if S:
        ref_y = ce.conv_pool_fwd_members_plain(x64, w64, b64, 5)
        ref_dw, ref_db = ce.conv_pool_wgrad_members_plain(x64, g64, 10, 5)
    else:
        ref_y = ce.conv_pool_fwd_plain(x64, w64, b64, 5)
        ref_dw, ref_db = ce.conv_pool_wgrad_plain(x64, g64, 10, 5)
    torch.testing.assert_close(y.cpu().double(), ref_y, rtol=1e-5, atol=1e-5)
    for out, ref in ((dw, ref_dw), (db, ref_db)):
        assert float((out.cpu().double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv_encoder_kernels_repeat_bit_for_bit(cuda, name):
    S = CONV_SHAPES[name][0]
    ce, args = _conv_args(cuda, *CONV_SHAPES[name])
    first, second = _conv_launch(ce, S, *args), _conv_launch(ce, S, *args)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, c) for a, c in zip(first[1], second[1]))


@pytest.mark.parametrize("shared", [False, True], ids=["batched_x", "shared_x"])
def test_conv_encoder_members_are_single_launches(cuda, shared):
    """Each of ten members' outputs, member-batched, bit for bit a
    single-member launch on its slices; with one batch for all members (the
    val ELBO's), passed as an expand."""
    ce, (x, w, b, g) = _conv_args(cuda, *CONV_SHAPES["proc-S10"])
    if shared:
        x = x[0].expand(x.shape)
    y, (dw, db) = _conv_launch(ce, 10, x, w, b, g)
    for s in range(10):
        assert torch.equal(y[s], ce.conv_pool_fwd(x[s], w[s], b[s], 5))
        one_dw, one_db = ce.conv_pool_wgrad(x[s], g[s], 10, 5)
        assert torch.equal(dw[s], one_dw) and torch.equal(db[s], one_db)


def test_conv_encoder_refuses_past_shared_memory(cuda):
    """A horizon whose block passes 227 KB raises a ValueError naming the
    limit, before any launch."""
    ce, (x, w, b, _) = _conv_args(cuda, 0, 2, 4, 6000)
    before = ce.conv_pool_fwd.launches
    with pytest.raises(ValueError, match="shared memory"):
        ce.conv_pool_fwd(x, w, b, 5)
    assert ce.conv_pool_fwd.launches == before


def test_conv_encoder_kernels_run_in_replayed_steps(cuda, tiny_cvs):
    """A replayed CVS dual step launches the single-model kernels, and a
    replayed proc sweep epoch (two members, their stacked steps and val ELBO)
    the member-batched ones, each counted under its workload's shape."""
    from structured_latent_odes_tpu_torch import sweep, training_cvs
    from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
    from structured_latent_odes_tpu_torch.ops import conv_encoder as ce
    from structured_latent_odes_tpu_torch.train import svi
    from structured_latent_odes_tpu_torch.train.driver import device_batch
    from structured_latent_odes_tpu_torch.utils.device import full_fp32
    from structured_latent_odes_tpu_torch.utils.graphs import Graph

    full_fp32(deterministic=True)
    cfg = load_cvs_config()
    cfg.data_path = tiny_cvs
    splits, _ = training_cvs.build_splits(cfg, device=cuda)
    spec = cvs_spec(cfg)
    params = init_params(spec, 0, device=cuda)
    batches = device_batch(stacked_minibatches(splits["train"], 16, shuffle=True, rng=np.random.RandomState(0)), cuda)
    init_state, _, graphed = svi.make_train_step(spec, torch.arange(86.0, device=cuda), cfg.learning_rate, params)
    state = init_state(params, 5)
    state, _ = graphed(state, batches)  # warms up and captures
    single, members = (ce.conv_pool_fwd, ce.conv_pool_wgrad), (ce.conv_pool_fwd_members, ce.conv_pool_wgrad_members)
    before, replays = [c.launches for c in single], Graph.replays
    cvs_shape = ce.conv_pool_wgrad.variants[3, 86, 10, 10, 5]
    graphed(state, batches)
    torch.cuda.synchronize()
    assert Graph.replays > replays and all(c.launches > n for c, n in zip(single, before))
    assert ce.conv_pool_wgrad.variants[3, 86, 10, 10, 5] > cvs_shape

    pcfg = sweep.load_base_config("proc")
    pcfg.num_epochs, pcfg.data_seed = 1, 1
    sweep_members = [sweep.prepare_member("proc", pcfg, seed, cuda) for seed in (3, 4)]
    before, replays = [c.launches for c in members], Graph.replays
    proc_shape = ce.conv_pool_wgrad_members.variants[4, 100, 10, 10, 5]
    sweep.train_ensemble(sweep_members, device=cuda)
    torch.cuda.synchronize()
    assert Graph.replays > replays and all(c.launches > n for c, n in zip(members, before))
    assert ce.conv_pool_wgrad_members.variants[4, 100, 10, 10, 5] > proc_shape

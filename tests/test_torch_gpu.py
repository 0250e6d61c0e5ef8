"""Kernels K1, K1-bwd, K2 and K3 of the PyTorch port against their plain
PyTorch versions, on a CUDA card. Marked ``gpu``; each test skips when no
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
"""

import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch.data.configs import LOADERS, load_cvs_config
from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, init_params, proc_spec, recon
from structured_latent_odes_tpu_torch.nn.ode_model import initialize_state
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
@pytest.mark.parametrize("method", ["midpoint", "rk4"])
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

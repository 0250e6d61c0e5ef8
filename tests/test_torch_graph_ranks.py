"""The data-parallel ranks' graph path on the CPU: two ranks spawned over
gloo (one group for the module's cases, every collective time-limited), each
running the training epoch, the eval epoch and the sweep's ens x data
layout through the graph path's buffers with the graph's plain version
(``dispatch="plain"``) and eagerly, bit for bit equal; and
``svi.epoch_dispatch`` for a reduce over gloo (eager, its reason named), a
reduce marked capturable as ``parallel/mesh.py::data_reduce`` marks an NCCL
sum (a CUDA graph, monkeypatched here without a card), and the time ranks
(eager by design: their collectives live inside the solve)."""

import os

import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch import sweep
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.nn.ode_model import NOT_CAPTURABLE
from structured_latent_odes_tpu_torch.parallel import launch, mesh
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
import _torch_rank_tasks as tasks
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

T = 16
LR = 1e-3
WORLD = 2


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(WORLD, threads=1, timeout_s=60) as p:
        yield p


def _split(n, seed):
    r = np.random.RandomState(seed)
    return {"observations": r.rand(n, 3, T).astype(np.float32),
            "iext": (r.rand(n, 1) > 0.5).astype(np.float32), "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32)}


def _spec(backend="semilinear"):
    cfg = load_cvs_config()
    cfg.ode_backend = backend
    return cvs_spec(cfg, n_time=T)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("backend", ["semilinear", "semilinear_fused"])
def test_dp_epochs_on_plain_graphs_equal_eager(pool, backend):
    """Two training epochs (three steps each, the last batch padded) and the
    eval epoch after them, posterior and prior, on each of two gloo ranks:
    the plain graph path bit for bit the eager path (params, moments,
    per-step metrics, statistics), and both ranks equal. A gloo group's
    reduce says it cannot be captured, and epoch_dispatch names it."""
    spec = _spec(backend)
    params = params_to_jax(init_params(spec, 0, device="cpu"))
    c = dict(spec=spec, ts=np.arange(float(T), dtype=np.float32), lr=LR, params=params,
             stack=stacked_minibatches(_split(10, 1), 4, shuffle=False),
             val=stacked_minibatches(_split(7, 2), 4, shuffle=False), dispatches=("eager", "plain"))
    outs = pool.run(tasks.dp_graph_epochs, c)
    for r, out in enumerate(outs):
        assert out["backend"] == "gloo" and out["capturable"] is False
        assert out["dispatch"].startswith("eager (ranks over gloo: ")
        eager, plain = out["eager"], out["plain"]
        assert eager["dispatches"] == ("eager", "eager") and plain["dispatches"] == ("plain", "plain")
        assert eager["step"] == plain["step"] == 6
        for k in ("params", "moments", "metrics", "stats"):
            assert _equal(plain[k], eager[k]), (r, k)
    for k in ("params", "moments", "metrics", "stats"):
        assert _equal(outs[1]["plain"][k], outs[0]["plain"][k]), k


@pytest.fixture(scope="module")
def cvs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


def test_ens_data_sweep_on_plain_graphs_equal_eager(pool, cvs_dir):
    """A two-member CVS sweep over one member rank by two data ranks
    (--ensemble-data-parallel 2, with a prior refit epoch): its stacked
    step, members' val ELBO and refit on the plain graphs with the data
    group's reduce, bit for bit the eager sweep."""
    cfg = sweep.load_base_config("cvs")
    cfg.update(data_path=cvs_dir, mini_batch_size=8, num_epochs=1, prior_refit_epochs=1)
    runs = {}
    for dispatch in ("eager", "plain"):
        outs = pool.run(tasks.sweep_ensemble, dict(dataset="cvs", config=cfg, seeds=[3, 4], ens=1, data=WORLD,
                                                   dispatch=dispatch))
        assert outs[1] is None
        runs[dispatch] = outs[0]
    a, b = runs["eager"], runs["plain"]
    assert _equal(a.state.params, b.state.params) and _equal(a.best_params, b.best_params)
    assert _equal([a.state.opt.mu, a.state.opt.nu], [b.state.opt.mu, b.state.opt.nu])
    np.testing.assert_array_equal(a.best_crit, b.best_crit)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k])


def _marked(backend):
    def reduce(tree):
        return tree

    reduce.backend, reduce.capturable = backend, backend == "nccl"
    return reduce


@pytest.mark.parametrize("over", ["nccl", "gloo"])
def test_epoch_dispatch_over_ranks(over):
    """On a CUDA device: a reduce marked capturable (NCCL) is captured on
    every capturable backend, and semilinear_timepar stays eager with its
    reason; a gloo reduce is eager with its reason on every backend."""
    cuda = torch.device("cuda")
    reduce = _marked(over)
    for backend in ("semilinear", "semilinear_fused", "generic", "semilinear_timepar", "adaptive"):
        got = svi.epoch_dispatch(_spec(backend), cuda, reduce)
        if over == "gloo":
            assert got == ("eager (ranks over gloo: a gloo sum runs on the host, which a CUDA graph "
                           "cannot capture)"), backend
        elif backend in NOT_CAPTURABLE:
            assert got == f"eager ({backend}: {NOT_CAPTURABLE[backend]})"
        else:
            assert got == "cuda graph", backend
    assert svi.epoch_dispatch(_spec(), "cpu", reduce) == "eager (on cpu: a CUDA graph needs a CUDA device)"


def test_data_reduce_marks_its_backend(monkeypatch):
    """data_reduce names its group's backend and marks an NCCL group's sum
    capturable, a gloo group's not; no grid, no reduce."""
    assert mesh.data_reduce(None) is None
    for backend in ("nccl", "gloo"):
        grid = mesh.Grid(("data", "model"), (1, 1), (0,), (0, 0), {"data": object(), "model": object()})
        monkeypatch.setattr(mesh.dist, "get_backend", lambda group, b=backend: b)
        reduce = mesh.data_reduce(grid)
        assert reduce.backend == backend and reduce.capturable == (backend == "nccl")

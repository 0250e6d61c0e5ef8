"""The sweep's epochs as the port's CUDA graphs take them, on the CPU: the
ensemble runner's graph path (``train/ensemble.py``: the stacked dual step,
the members' val ELBO and the prior refit's update over the graphs'
buffers), run by the graph helper's plain version (``utils/graphs.py``),
trains exactly as the eager runner.

- The runner on the graph path's plain version against the eager runner,
  bit for bit (``torch.equal``), for the four policies on ``semilinear`` and
  ``semilinear_fused``, with the train and val splits shared and stacked,
  an lr schedule and an aux anneal, a tail EMA from epoch 1 (so the epoch
  before it keeps the params, which a later replay overwrites) and one
  refit epoch: the final state (params, moments, counts), the best params,
  criterion and epoch, the history and the EMA.
- ``run_chunked`` over 1-epoch chunks on the plain path, bit for bit one
  dispatch on it.
- A second run on the same memoized graphs leaves the first run's result
  unchanged and captures nothing new; two member groups through
  ``sweep.train_ensemble(member_group=...)`` on the plain path equal the
  eager groups, and the sweep prints its epoch dispatch once.
- ``runner.dispatch`` (and the refit's) for every backend, with and without
  a data ``reduce``, on the CPU and on a CUDA device.

The refit's update fed its bias corrections as a tensor row is held against
JAX in ``tests/test_torch_ensemble.py::test_prior_refit_step_matches_jax``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from structured_latent_odes_tpu_torch import sweep
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.train import ensemble as ens
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.utils.graphs import graphs_of
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_ensemble import T, _config, _ensemble, _splits
from test_torch_graph_step import BACKENDS, NOT_CAPTURED


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _assert_results_equal(a: ens.EnsembleResult, b: ens.EnsembleResult):
    assert (a.state.seed, a.state.step) == (b.state.seed, b.state.step)
    assert [s.count for s in svi._slots(a.state.opt)] == [s.count for s in svi._slots(b.state.opt)]
    _assert_trees_equal(svi._tensors(a.state), svi._tensors(b.state))
    _assert_trees_equal(a.best_params, b.best_params)
    assert np.array_equal(a.best_crit, b.best_crit) and np.array_equal(a.best_epoch, b.best_epoch)
    assert sorted(a.history) == sorted(b.history)
    assert all(np.array_equal(a.history[k], b.history[k]) for k in a.history)
    assert (a.ema_params is None) == (b.ema_params is None)
    if a.ema_params is not None:
        _assert_trees_equal(a.ema_params, b.ema_params)


# every option that the runner's graphs read: the lr schedule (a 0-d batch
# entry), the aux anneal (another fill each epoch), the EMA and the refit
FULL = dict(refit_epochs=1, tail_ema_decay=0.75, tail_ema_start=1)


def _run(policy, backend, dispatch, seeds=(3, 4), shared_data=True, chunk=0, num_epochs=2):
    config = _config(num_epochs, backend=backend, anneal=True, lrdecay=True)
    return _ensemble(config, _splits(), list(seeds), policy, shared_data=shared_data, chunk=chunk,
                     dispatch=dispatch, **FULL)


@pytest.mark.parametrize("shared_data", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("backend", ["semilinear", "semilinear_fused"])
@pytest.mark.parametrize("policy", ens.POLICIES)
def test_plain_graph_runner_matches_eager(policy, backend, shared_data):
    """Three epochs and a refit epoch of two members on the graph path's
    buffers (the plain version) and eagerly: every number of the result bit
    for bit equal."""
    eager = _run(policy, backend, "eager", shared_data=shared_data)
    plain = _run(policy, backend, "plain", shared_data=shared_data)
    _assert_results_equal(eager, plain)
    assert eager.history["loss_main"].shape == (2, 3, 3)
    # the EMA and the best params are their own, not the final state's
    assert not torch.equal(tree_leaves(plain.ema_params)[0], tree_leaves(plain.state.params)[0])


def test_chunked_plain_matches_one_dispatch():
    """run_chunked over 1-epoch chunks on the plain graph path, three
    members: bit for bit one dispatch on it, and the eager run."""
    one = _run("cvs", "semilinear", "plain", seeds=(3, 4, 5))
    chunked = _run("cvs", "semilinear", "plain", seeds=(3, 4, 5), chunk=1)
    _assert_results_equal(one, chunked)
    _assert_results_equal(one, _run("cvs", "semilinear", "eager", seeds=(3, 4, 5)))


@pytest.mark.parametrize("policy,refit_epochs", [("cvs", 1), ("challenge", 0)])
def test_second_run_leaves_the_first_result_and_captures_nothing(policy, refit_epochs):
    """Two runs of other seeds on the same memoized graphs (the step, the val
    ELBO and the refit's update): the first run's result, kept aside, is
    unchanged after the second, which adds no graph to the memo. Without a
    refit, at challenge, both members' best params are the last epoch's:
    the run's own copy of them, not the graph's buffers."""
    kw = dict(FULL, refit_epochs=refit_epochs)
    config = _config(2, backend="semilinear_fused", anneal=True, lrdecay=True)
    first = _ensemble(config, _splits(), [3, 4], policy, dispatch="plain", **kw)
    if not refit_epochs:
        assert list(first.best_epoch) == [2, 2]
    kept = ens.EnsembleResult(svi.own_state(first.state), svi.own_tree(first.best_params), first.best_crit.copy(),
                              first.best_epoch.copy(), {k: v.copy() for k, v in first.history.items()},
                              svi.own_tree(first.ema_params))
    def keys():  # the graphs of the stacked step, of the val ELBO and of the refit's update
        runner = graphs_of("ensemble")
        parts = [{k for k in runner if k[-2] == part} for part in ["step"] + ["val"] * (policy == "cvs")]
        return parts + [set(graphs_of("refit"))] * bool(refit_epochs)

    graphs = keys()
    assert all(graphs)
    second = _ensemble(config, _splits(), [5, 6], policy, dispatch="plain", **kw)
    assert keys() == graphs
    _assert_results_equal(first, kept)
    assert not torch.equal(tree_leaves(first.state.params)[0], tree_leaves(second.state.params)[0])


def test_member_groups_plain_match_eager(capsys):
    """Four challenge members in two groups of two through train_ensemble,
    on the plain graph path (the second group replays the first's graphs)
    and eagerly: bit for bit equal; each sweep prints its epoch dispatch
    once."""
    config = sweep.load_base_config("challenge")
    config.num_epochs, config.data_seed, config.num_samples, config.prior_refit_epochs = 1, 5, 1, 1
    members = [sweep.prepare_member("challenge", config, s, "cpu") for s in (3, 4, 5, 6)]
    runs = {}
    for dispatch in ("eager", "plain"):
        runs[dispatch] = sweep.train_ensemble(members, member_group=2, device="cpu", dispatch=dispatch)
        out = capsys.readouterr().out
        assert out.count("epoch dispatch: ") == 1 and f"epoch dispatch: {dispatch}\n" in out
        assert "member group 2/2 (2 members)" in out
    _assert_results_equal(runs["eager"], runs["plain"])
    assert runs["plain"].state.seed == [m["train_seed"] for m in members]
    sweep.train_ensemble(members[:2], device="cpu")
    assert "epoch dispatch: eager (on cpu: a CUDA graph needs a CUDA device)" in capsys.readouterr().out


@pytest.mark.parametrize("backend", BACKENDS)
def test_runner_dispatch(backend, monkeypatch):
    """The runner's and its refit's dispatch: a CUDA graph on a CUDA device
    for every capturable backend without a data reduce or with one marked
    capturable (NCCL's); eager, with svi.epoch_dispatch's reason, on the
    CPU, with a reduce not marked capturable or over gloo, and on the
    adaptive backends and semilinear_timepar; 'eager' and 'plain' as asked."""
    cfg = load_cvs_config()
    cfg.seq_len, cfg.ode_backend = T, backend
    spec = cvs_spec(cfg, n_time=T)
    params = init_params(spec, 0, device="cpu")

    def dispatch(ts, **kw):
        runner = ens.make_ensemble_runner(spec, ts, 1e-3, params, policy="cvs", refit_epochs=1, **kw)
        assert runner.refit is not None
        refit = ens.make_prior_refit_fn(spec, ts, 1e-3, kw.get("reduce"), kw.get("dispatch"))
        assert refit.dispatch == runner.dispatch
        return runner.dispatch

    with FakeTensorMode():
        cuda_ts = torch.arange(float(T), device="cuda")
    monkeypatch.setattr(svi, "_ts_key", lambda ts: ())  # a fake tensor has no values to key on
    cpu_ts, reduce = torch.arange(float(T)), (lambda tree: tree)
    for ts in (cpu_ts, cuda_ts):
        assert dispatch(ts) == svi.epoch_dispatch(spec, ts.device)
        assert dispatch(ts, reduce=reduce) == svi.epoch_dispatch(spec, ts.device, reduce)
        assert dispatch(ts, dispatch="eager") == "eager"
        assert dispatch(ts, dispatch="plain") == "plain"
    assert dispatch(cpu_ts) == dispatch(cpu_ts, reduce=reduce) == "eager (on cpu: a CUDA graph needs a CUDA device)"
    assert dispatch(cuda_ts) == ("cuda graph" if backend not in NOT_CAPTURED else
                                 f"eager ({backend}: {svi.NOT_CAPTURABLE[backend]})")
    assert dispatch(cuda_ts, reduce=reduce) == "eager (ranks: the reduce is not marked capturable)"
    reduce.backend, reduce.capturable = "nccl", True  # as parallel/mesh.py::data_reduce marks an NCCL sum
    assert dispatch(cuda_ts, reduce=reduce) == dispatch(cuda_ts)
    reduce.backend, reduce.capturable = "gloo", False
    assert dispatch(cuda_ts, reduce=reduce).startswith("eager (ranks over gloo: ")
    with pytest.raises(ValueError, match="dispatch"):
        dispatch(cpu_ts, dispatch="graph")

"""Serving's predict functions and the eval functions as the port's CUDA
graphs take them, on the CPU: the captured path's buffers, run by the graph
helper's plain version (``utils/graphs.py``; ``dispatch="plain"``), give
bit for bit what the eager functions give.

- ``serve.make_predict_fns``: posterior and prior reconstruction and the
  classifier, a second request on other params at another seed, two batch
  shapes sharing the memo, a first request made in inference mode; and
  ``serve.main`` (two checkpoints, ``--classify``) through the plain graphs,
  bit for bit the eager CLI, which prints ``predict dispatch:`` once.
- ``svi.make_eval_fns``: the three functions at CVS, proc and challenge
  shapes; ``driver.eval_split``, ``training_challenge.multiple_samples`` and
  ``sweep.selection_prior_l1`` run through them; the seed reaching the
  graph as a 0-d int64 tensor (a ``(1,)`` seed would give the draws a member
  axis); the ``dispatch`` strings.
- At CVS, proc and challenge the plain graph path fed JAX's draws
  (``noise=``) against JAX's jitted ``make_predict_fns`` and ``make_eval_fns``
  on the JAX params carried across: recon outputs within 1e-5 abs + 1e-6
  relative and the continuous heads' loc likewise, labels exactly
  (``tests/test_torch_serve.py::test_served_workloads_match_jax``), the
  losses within 2e-6 relative (``tests/test_torch_slode_workloads.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from structured_latent_odes_tpu import serve as jax_serve
from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.train import checkpoint as jax_ckpt
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch import serve, sweep, training_challenge
from structured_latent_odes_tpu_torch.data.configs import LOADERS, load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.data.loader import full_batch, stacked_minibatches
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.prob import fold_seed, seed_tensor
from structured_latent_odes_tpu_torch.train import driver, svi
from structured_latent_odes_tpu_torch.utils.graphs import GRAPHS, graphs_of
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_slode_workloads import _SPLITS, N_TIME, _draws, _jax_params, _port, _rows, _specs

RECON_ATOL, RECON_RTOL = 1e-5, 1e-6
LOSS_RTOL = 2e-6
WORKLOADS = ("cvs", "proc", "challenge")
CVS_T = 86


def _workload(wl):
    """(JAX spec, port spec, times) of a workload at its full widths."""
    if wl == "cvs":
        return jax_cvs_spec(jax_cvs_config(), n_time=CVS_T), cvs_spec(load_cvs_config(), n_time=CVS_T), \
            np.arange(float(CVS_T), dtype=np.float32)
    jspec, pspec = _specs(wl)
    return jspec, pspec, np.arange(float(N_TIME[wl]), dtype=np.float32)


def _cvs_split(n, seed):
    r = np.random.RandomState(seed)
    return {"observations": r.rand(n, 3, CVS_T).astype(np.float32),
            "iext": (r.rand(n, 1) > 0.5).astype(np.float32), "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32)}


def _split(wl, n=6):
    """``n`` rows of the workload: CVS made from a seed, proc and challenge
    the first rows of their train folds."""
    if wl == "cvs":
        return _cvs_split(n, 1)
    _rows(wl)  # loads the fold once a process
    return {k: v[:n] for k, v in _SPLITS[wl].items()}


def _batch(split, size=None):
    """The split as one padded batch with the loader's sample ids and mask."""
    n = split["observations"].shape[0]
    return driver.device_batch(full_batch(split, pad_to_size=size or n), "cpu")


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(autouse=True)
def fresh_memo():
    GRAPHS.clear()
    yield
    GRAPHS.clear()


def test_predict_fns_plain_graphs_equal_eager():
    """Posterior, prior and classifier requests through the plain graphs
    (three calls each: the graph's warm-up, its capture, a replay on the
    card) bit for bit the eager requests; a second request on other params
    at another seed; a second batch shape gets graphs of its own beside the
    first's, and the first's still serve."""
    _, spec, times = _workload("cvs")
    eager = serve.make_predict_fns(spec, times, device="cpu", dispatch="eager")
    plain = serve.make_predict_fns(spec, times, device="cpu", dispatch="plain")
    assert [f.dispatch for f in eager] == ["eager", "eager"] and [f.dispatch for f in plain] == ["plain", "plain"]
    small, big = _batch(_cvs_split(5, 2)), _batch(_cvs_split(7, 3), size=8)
    for params, seed in ((init_params(spec, 0, device="cpu"), 3), (init_params(spec, 1, device="cpu"), 11)):
        for batch in (small, big):
            for _ in range(3):
                for is_post in (True, False):
                    want = eager[0](params, seed, batch, is_post)
                    assert _equal(plain[0](params, seed, batch, is_post), want), (seed, is_post)
                assert _equal(plain[1](params, seed, batch["observations"]),
                              eager[1](params, seed, batch["observations"]))
    assert len(graphs_of("eval_fns")) == 6  # (post, prior, classify) x two shapes


def test_predict_fns_first_request_in_inference_mode():
    """A first request made in inference mode builds the graph's buffers as
    plain tensors: a second request outside it copies into them."""
    _, spec, times = _workload("cvs")
    eager = serve.make_predict_fns(spec, times, device="cpu", dispatch="eager")
    plain = serve.make_predict_fns(spec, times, device="cpu", dispatch="plain")
    batch = _batch(_cvs_split(4, 5))
    p0, p1 = init_params(spec, 0, device="cpu"), init_params(spec, 1, device="cpu")
    with torch.inference_mode():
        first = plain[0](p0, 2, batch, True)
        labels = plain[1](p0, 2, batch["observations"])
    assert _equal(first, eager[0](p0, 2, batch, True))
    assert _equal(labels, eager[1](p0, 2, batch["observations"]))
    assert _equal(plain[0](p1, 4, batch, True), eager[0](p1, 4, batch, True))
    assert _equal(plain[1](p1, 4, batch["observations"]), eager[1](p1, 4, batch["observations"]))


@pytest.mark.parametrize("wl", WORKLOADS)
def test_eval_fns_plain_graphs_equal_eager(wl):
    """evaluate_losses, classify and reconstruct (posterior and prior)
    through the plain graphs, bit for bit eager, at int seeds (the drivers'
    eval_seeds, a fold_seed, a seed past 2**63) and at a 0-d int64 seed
    tensor; the seed buffer of every graph is 0-d int64."""
    _, spec, times = _workload(wl)
    ts = torch.from_numpy(times)
    eager, plain = svi.make_eval_fns(spec, ts, dispatch="eager"), svi.make_eval_fns(spec, ts, dispatch="plain")
    params = init_params(spec, 0, device="cpu")
    batch = _batch(_split(wl, 5), size=6)
    for seed in (*svi.eval_seeds(9), fold_seed(4, "test"), (1 << 64) - 5):
        for call in (seed, seed_tensor([seed])[0]):
            assert _equal(plain[0](params, call, batch), eager[0](params, seed, batch))
            assert _equal(plain[1](params, call, batch), eager[1](params, seed, batch))
            for is_post in (True, False):
                assert _equal(plain[2](params, call, batch, is_post), eager[2](params, seed, batch, is_post))
    graphs = list(graphs_of("eval_fns").values())
    assert len(graphs) == 4 and all(g.inputs["seed"].shape == () and g.inputs["seed"].dtype == torch.int64
                                    for g in graphs)


@pytest.mark.parametrize("wl", WORKLOADS)
def test_eval_callers_run_through_plain_graphs(wl):
    """eval_split (posterior and prior, two padded batches), the sample
    bands' multiple_samples and the sweep's selection_prior_l1, each given
    the plain graphs' functions, bit for bit what each gives with eager."""
    _, spec, times = _workload(wl)
    ts = torch.from_numpy(times)
    fns = {d: svi.make_eval_fns(spec, ts, dispatch=d) for d in ("eager", "plain")}
    params = init_params(spec, 0, device="cpu")
    split = _split(wl, 7)
    stats = {d: [driver.eval_split(spec, params, 5, split, f, 4, is_post=p) for p in (True, False)]
             for d, f in fns.items()}
    for got, want in zip(stats["plain"], stats["eager"]):
        assert got.elbo == want.elbo and got.l1 == want.l1 and got.label_metrics == want.label_metrics
        for k in want.recon:
            np.testing.assert_array_equal(got.recon[k], want.recon[k])
    batch = _batch(split)
    for is_post in (True, False):
        bands = {d: training_challenge.multiple_samples(f[2], params, 8, batch, 3, is_post) for d, f in fns.items()}
        for k in bands["eager"]:
            np.testing.assert_array_equal(bands["plain"][k], bands["eager"][k])
    member = {"val_stack": stacked_minibatches(split, 4, shuffle=False), "splits": {"train": split},
              "config": LOADERS[wl](), "eval_seed": 6}
    l1 = {d: sweep.selection_prior_l1(member, params, f[2]) for d, f in fns.items()}
    assert l1["plain"] == l1["eager"] and np.isfinite(l1["eager"])


def test_dispatch_strings(monkeypatch):
    """None picks the CUDA graph only on a CUDA device, for a capturable
    backend: eager, with its reason, on the CPU, for the eval and the
    predict functions alike, and on an adaptive backend on the card."""
    _, spec, times = _workload("cvs")
    reason = "eager (on cpu: a CUDA graph needs a CUDA device)"
    assert {f.dispatch for f in svi.make_eval_fns(spec, torch.from_numpy(times))} == {reason}
    assert {f.dispatch for f in serve.make_predict_fns(spec, times, device="cpu")} == {reason}
    with FakeTensorMode():
        cuda_ts = torch.arange(float(CVS_T), device="cuda")
    monkeypatch.setattr(svi, "_ts_key", lambda ts: ())  # a fake tensor has no values to key on
    assert {f.dispatch for f in svi.make_eval_fns(spec, cuda_ts)} == {"cuda graph"}
    cfg = load_cvs_config()
    cfg.ode_backend = "adaptive"
    adaptive = cvs_spec(cfg, n_time=CVS_T)
    assert {f.dispatch for f in svi.make_eval_fns(adaptive, cuda_ts)} == \
        {f"eager (adaptive: {svi.NOT_CAPTURABLE['adaptive']})"}
    with pytest.raises(ValueError, match="dispatch"):
        svi.make_eval_fns(spec, torch.from_numpy(times), dispatch="graph")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny CVS dataset and two JAX checkpoints of its spec."""
    root = tmp_path_factory.mktemp("served")
    cfg = load_cvs_config()
    cfg.data_path, cfg.data_size = str(root / "cvs"), 30
    make_dataset(cfg.data_path, data_size=30, seed=0, device="cpu")
    spec = jax_cvs_spec(jax_cvs_config())
    ckpts = []
    for seed in (0, 1):
        ckpts.append(str(root / f"member{seed}.npz"))
        jax_ckpt.save(ckpts[-1], jax_init(jax.random.key(seed), spec))
    return cfg, ckpts, root


@pytest.mark.parametrize("prior", [False, True], ids=["posterior", "prior"])
def test_serve_main_through_plain_graphs(served, prior, monkeypatch, capsys):
    """serve.main on two checkpoints with --classify: eager on the CPU, and
    through the plain graphs (the predict functions' dispatch forced), every
    written array bit for bit equal; each run prints its dispatch once."""
    cfg, ckpts, root = served
    argv = ["--dataset", "cvs", "--checkpoint", *ckpts, "--classify", "--device", "cpu", "--seed", "4"]
    argv += ["--prior"] if prior else []
    eager = serve.main(argv + ["--output", str(root / "eager.npz")], config=cfg)
    out = capsys.readouterr().out
    assert out.count("predict dispatch: ") == 1 and "predict dispatch: eager (on cpu" in out
    monkeypatch.setattr(svi, "epoch_dispatch", lambda spec, device, reduce=None: "plain")
    plain = serve.main(argv + ["--output", str(root / "plain.npz")], config=cfg)
    assert capsys.readouterr().out.count("predict dispatch: plain") == 1
    assert sorted(plain) == sorted(eager)
    for k in eager:
        np.testing.assert_array_equal(plain[k], eager[k], err_msg=k)


def _sites(jspec, blocks):
    return [(b.name, b.dim) for b in blocks]


def _prior_sites(jspec):
    """sample_prior_z's draws: the joint prior's z_u then epsilon, or one a
    labeled block then epsilon."""
    if jspec.prior == "joint":
        return [("z_u", jspec.z_u_dim), (jspec.epsilon_block.name, jspec.epsilon_block.dim)]
    return _sites(jspec, jspec.blocks)


@pytest.mark.parametrize("wl", WORKLOADS)
def test_plain_graphs_match_jax(wl):
    """The predict and eval functions' plain graphs, fed JAX's draws, against
    JAX's jitted make_predict_fns and make_eval_fns on JAX's params carried
    across: posterior and prior recon, the classifier and the two losses."""
    jspec, spec, times = _workload(wl)
    jparams = _jax_params(jspec)
    params = _port(jparams)
    split = _split(wl, 5)
    jb = full_batch(split, pad_to_size=6)
    batch = driver.device_batch(jb, "cpu")
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    sids = jnp.asarray(jb["sample_id"])
    recon_fn, classify_fn = serve.make_predict_fns(spec, times, device="cpu", dispatch="plain")
    jrecon_fn, jclassify_fn = jax_serve.make_predict_fns(jspec, times)
    losses, _, reconstruct = svi.make_eval_fns(spec, torch.from_numpy(times), dispatch="plain")
    jlosses, _, jreconstruct = jsvi.make_eval_fns(jspec, jnp.asarray(times))
    key = jax.random.key(3)
    for is_post in (True, False):
        if is_post:
            noise = _draws(key, sids, [("z", jspec.latent_dim)])
        else:
            noise = _draws(jax.random.split(key)[1], sids, _prior_sites(jspec))
        for ours_fn, ref in ((recon_fn, jrecon_fn(jparams, key, jbatch, is_post)),
                             (reconstruct, jreconstruct(jparams, key, jbatch, is_post=is_post))):
            for _ in range(2):
                ours = ours_fn(params, 0, batch, is_post, noise=noise)
                assert set(ours) == set(ref)
                for k in ref:
                    np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=RECON_RTOL,
                                               atol=RECON_ATOL, err_msg=f"{wl} {is_post} {k}")
    dims = {b.name: b.dim for b in jspec.blocks}
    obs = batch["observations"]
    noise = _draws(key, jnp.arange(obs.shape[0]), [(label.name, dims[label.block]) for label in jspec.labels])
    ref = jclassify_fn(jparams, key, jnp.asarray(jb["observations"]))
    for _ in range(2):
        ours = classify_fn(params, 0, obs, noise=noise)
        for label in jspec.labels:
            if label.kind == "continuous":
                np.testing.assert_allclose(ours[label.name].numpy(), np.asarray(ref[label.name]),
                                           rtol=RECON_RTOL, atol=RECON_ATOL)
            else:
                np.testing.assert_array_equal(ours[label.name].numpy(), np.asarray(ref[label.name]))
    k1, k2 = jax.random.split(key)
    main_sites = _prior_sites(jspec) if jspec.prior == "joint" else _sites(jspec, jspec.blocks)
    noise = {"main": _draws(k1, sids, main_sites), "aux": _draws(k2, sids, _sites(jspec, jspec.labeled_blocks))}
    ref = jlosses(jparams, key, jbatch)
    for _ in range(2):
        ours = losses(params, 0, batch, noise=noise)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(float(o), float(r), rtol=LOSS_RTOL)

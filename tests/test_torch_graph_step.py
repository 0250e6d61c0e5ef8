"""The training step and eval epoch as the port's CUDA graphs take them, on
the CPU: every number that changes from step to step reaches the step as a
tensor, and the captured path's buffers, run by the graph helper's plain
version (``utils/graphs.py``), train exactly as the eager path.

- One and two dual steps fed their :func:`svi.epoch_scalars` rows (the
  draws' seeds and Adam's bias corrections as tensors) against JAX's dual
  steps at equal draws, in the shared and split optimizers, at
  ``tests/test_torch_svi.py``'s tolerances.
- The draws at a 0-d int64 seed tensor, bit for bit those at the int seed.
- The step counts that the host advances by the masks' rule, equal to the
  counts that the steps leave and to a hand count, and the bias
  corrections equal to ``1 - b**count`` at those counts.
- ``run_training_epochs`` over three epochs on the graph path's plain
  version, bit for bit the eager run (best params, which are a copy, and the
  final state), and a ``training_cvs`` run resumed on it, bit for bit the
  uninterrupted eager run.
- :func:`svi.epoch_dispatch` for every backend, with and without ranks, on
  the CPU and on a CUDA device; a capture on the CPU raises; a graph evicted
  from its memo is freed at once, without the garbage collector.
- A kernel wrapper registered with ``utils/graphs.py::counted`` keeps its
  counts through a graph's plain version (``tests/test_torch_gpu.py``: a
  replay on the card).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.models import cvs_spec, elbo_main, init_params, param_masks, recon
from structured_latent_odes_tpu_torch.nn.ode_model import solve_is_capturable
from structured_latent_odes_tpu_torch.prob import fold_seed, seed_tensor, standard_normal_ps
from structured_latent_odes_tpu_torch.train import driver, svi
from structured_latent_odes_tpu_torch.utils import graphs
from structured_latent_odes_tpu_torch.utils.graphs import GRAPHS, Graph, graphs_of
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_svi import LR, T, _assert_state_close, _port, _specs, _split, _step_noise

BACKENDS = ("semilinear", "semilinear_pallas", "semilinear_seq", "semilinear_fused", "semilinear_auto",
            "semilinear_timepar", "generic", "adjoint", "adaptive", "adaptive_per_sample")
NOT_CAPTURED = ("semilinear_timepar", "adaptive", "adaptive_per_sample")


@pytest.mark.parametrize("optimizer", ["shared", "split"])
def test_dual_steps_fed_step_scalars_match_jax(optimizer):
    """Two dual steps (the second batch padded and masked), each fed its
    row of epoch_scalars, against JAX's make_dual_step at JAX's draws."""
    jspec, pspec = _specs()
    params = jax_init(jax.random.key(0), jspec)
    stack = _stack(7)
    batches = [{k: v[i] for k, v in stack.items()} for i in range(2)]
    ts = np.arange(float(T), dtype=np.float32)
    joptim = jsvi.make_dual_optimizer(jspec, params, LR, optimizer)
    jstep = jsvi.make_dual_step(jspec, jnp.asarray(ts), joptim)
    jstate = jsvi.SVIState(params, joptim.init(params), jax.random.key(5))
    optim = svi.make_dual_optimizer(pspec, _port(params), LR, optimizer)
    pstep = svi.make_dual_step(pspec, torch.from_numpy(ts), optim)
    pstate = svi.SVIState(_port(params), optim.init(_port(params)), 0, 0)
    seeds, corrections, _ = svi.epoch_scalars(optim, pstate, 2)
    assert seeds.dtype == torch.int64 and seeds.shape == (2, 2, 1)
    assert corrections.dtype == torch.float32 and corrections.shape == (2, 2, 2, len(tree_leaves(pstate.params)))
    for i, batch in enumerate(batches):
        noise = _step_noise(jspec, jstate.key, batch, 1)
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pmets = pstep(pstate, driver.device_batch(batch, "cpu"), noise=noise,
                              scalars=(seeds[i], corrections[i]))
        for k in ("loss_main", "loss_aux", "l1"):
            np.testing.assert_allclose(float(pmets[k]), float(jmets[k]), rtol=2e-6, err_msg=f"{k} step {i}")
        _assert_state_close(pspec, pstate, jstate, optimizer == "split", f"{optimizer} step {i}")


def _stack(n, batch_size=4, seed=1):
    from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches

    return stacked_minibatches(_split(n, seed), batch_size, shuffle=False)


@pytest.mark.parametrize("seed", [0, 12, fold_seed(3, "train"), (1 << 64) - 5])
def test_tensor_seeded_draws_equal_int_seeded(seed):
    """A 0-d int64 seed tensor (a row of epoch_scalars, the eval seeds)
    draws bit for bit what its int draws: the sampler, a step's seeds
    folded on the device, the main ELBO and a reconstruction."""
    tseed = seed_tensor([seed])[0]
    sids = torch.arange(5) * 7 + 3
    assert torch.equal(standard_normal_ps(seed, "main/z", sids, (4,)), standard_normal_ps(tseed, "main/z", sids, (4,)))
    assert int(fold_seed(tseed, "main")) & ((1 << 64) - 1) == fold_seed(seed, "main")
    _, pspec = _specs()
    params = init_params(pspec, 0, device="cpu")
    batch = driver.device_batch({k: v[0] for k, v in _stack(6).items()}, "cpu")
    ts = torch.arange(float(T))
    with torch.no_grad():
        a, b = elbo_main(pspec, params, seed, batch, ts)[0], elbo_main(pspec, params, tseed, batch, ts)[0]
        assert torch.equal(a, b)
        for is_post in (True, False):
            r_int, r_t = recon(pspec, params, seed, batch, ts, is_post), recon(pspec, params, tseed, batch, ts, is_post)
            for k in ("mu_50", "z"):
                assert torch.equal(r_int[k], r_t[k]), (k, is_post)


@pytest.mark.parametrize("optimizer", ["shared", "split"])
def test_host_counts_follow_the_masks(optimizer):
    """Three steps: the counts that epoch_scalars advances on the host equal
    those the steps leave and a hand count from the masks (shared: one a
    masked update, two on the leaves both losses reach; split: one a step in
    each loss's own slots), and each correction is 1 - b**count in float32
    at the count of its update (1 on a leaf the update leaves)."""
    _, pspec = _specs()
    params = init_params(pspec, 0, device="cpu")
    optim = svi.make_dual_optimizer(pspec, params, LR, optimizer)
    step = svi.make_dual_step(pspec, torch.arange(float(T)), optim)
    state = svi.SVIState(params, optim.init(params), 3, 0)
    seeds, corrections, opt = svi.epoch_scalars(optim, state, 3)
    stack = driver.device_batch(_stack(12), "cpu")
    for i in range(3):
        state, _ = step(state, {k: v[i] for k, v in stack.items()}, scalars=(seeds[i], corrections[i]))
    main, aux = (tree_leaves(m) for m in param_masks(pspec, params))
    slots = [opt] if optimizer == "shared" else list(opt)
    stepped = [svi._slots(state.opt)[j].count for j in range(len(slots))]
    assert [s.count for s in slots] == stepped
    if optimizer == "shared":
        assert tree_leaves(opt.count) == [3 * (a + b) for a, b in zip(main, aux)]
    else:
        assert [tree_leaves(s.count) for s in opt] == [[3 * a for a in main], [3 * b for b in aux]]
    f32 = np.float32
    for i in range(3):
        for u, mask in enumerate((main, aux)):
            for leaf, on in enumerate(mask):
                if optimizer == "shared":
                    count = i * (main[leaf] + aux[leaf]) + (main[leaf] if u else 0) + 1
                else:
                    count = i + 1
                for r, b in enumerate((0.9, 0.999)):
                    want = f32(1.0) - np.power(f32(b), f32(count)) if on else f32(1.0)
                    assert corrections[i, u, r, leaf].item() == want, (i, u, r, leaf)


def _tiny(num_epochs):
    cfg = load_cvs_config()
    cfg.seq_len, cfg.mini_batch_size, cfg.num_epochs = T, 4, num_epochs
    splits = {"train": _split(10, 0), "val": _split(6, 1), "test": _split(6, 2)}
    return cfg, splits, cvs_spec(cfg, n_time=T)


def _assert_states_equal(a, b):
    assert (a.seed, a.step) == (b.seed, b.step)
    assert [s.count for s in svi._slots(a.opt)] == [s.count for s in svi._slots(b.opt)]
    ta, tb = svi._tensors(a), svi._tensors(b)
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("optimizer", ["shared", "split"])
def test_plain_graphs_drive_the_epoch_loop_as_eager(optimizer):
    """run_training_epochs over epochs 0-3 on the graph path's buffers (the
    plain version) and eagerly: the best params (epoch 1's, kept while later
    epochs overwrite the buffers in place) and the final state bit for bit
    equal, and the same statistics each epoch."""
    cfg, splits, spec = _tiny(3)
    params = init_params(spec, 0, device="cpu")
    ts = torch.arange(float(T))
    runs = {}
    for dispatch in ("eager", "plain"):
        init_state, _, epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, optimizer=optimizer,
                                                   dispatch=dispatch)
        assert epoch.dispatch == dispatch
        seen = []

        def select_best(epoch_i, val, train_s, best, params_now, losses):
            seen.append((val["post"].elbo, train_s["prior"].l1, losses))
            return {"params": params_now, "epoch": epoch_i, "criterion": 0.0} if epoch_i == 1 else best

        state, best = driver.run_training_epochs(
            spec=spec, state=init_state(params, 1), train_epoch=epoch,
            eval_epoch=svi.make_eval_epoch(spec, ts, dispatch=dispatch), splits=splits, config=cfg,
            rng=np.random.RandomState(3), eval_seed=4, select_best=select_best)
        runs[dispatch] = state, best, seen
    (s_e, b_e, seen_e), (s_p, b_p, seen_p) = runs["eager"], runs["plain"]
    assert seen_e == seen_p and b_e["epoch"] == b_p["epoch"] == 1
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(b_e["params"]), tree_leaves(b_p["params"])))
    _assert_states_equal(s_e, s_p)
    assert not any(torch.equal(x, y) for x, y in zip(tree_leaves(b_p["params"]), tree_leaves(s_p.params))
                   if x.numel() > 1)  # the best epoch's params, not the last's


@pytest.fixture(scope="module")
def cvs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs"))
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


def test_plain_graphs_resume_as_eager(cvs_dir, tmp_path, monkeypatch, capsys):
    """training_cvs on the graph path's plain version, epochs 0-1 then
    --resume to epoch 3, bit for bit the uninterrupted eager run: the final
    state, the best params and epoch. Each run prints its epoch dispatch."""
    args = ["--data-path", cvs_dir, "--mini-batch-size", "8", "--no-plot", "--no-eval-train", "--device", "cpu",
            "--checkpoint-every", "1"]
    full = training_cvs.main(args + ["--num-epochs", "3", "--results-root", str(tmp_path / "full")])
    assert "epoch dispatch: eager (on cpu" in capsys.readouterr().out
    monkeypatch.setattr(svi, "epoch_dispatch", lambda spec, device, reduce=None: "plain")
    part = ["--results-root", str(tmp_path / "part")]
    training_cvs.main(args + ["--num-epochs", "1"] + part)
    resumed = training_cvs.main(args + ["--num-epochs", "3", "--resume"] + part)
    out = capsys.readouterr().out
    assert out.count("epoch dispatch: plain") == 2 and "resumed from" in out
    _assert_states_equal(full["state"], resumed["state"])
    assert full["best"]["epoch"] == resumed["best"]["epoch"]
    for a, b in zip(tree_leaves(full["best"]["params"]), tree_leaves(resumed["best"]["params"])):
        assert torch.equal(a, b)


def test_evicted_graphs_are_freed_at_once():
    """A graph dropped from its memo is freed by its reference count alone,
    with its buffers (and on the card its pool): no reference cycle waits for
    the garbage collector, which must not run inside another capture."""
    cfg, splits, spec = _tiny(1)
    params = init_params(spec, 0, device="cpu")
    ts = torch.arange(float(T))
    init_state, _, epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch="plain")
    eval_epoch = svi.make_eval_epoch(spec, ts, dispatch="plain")
    epoch(init_state(params, 1), driver.device_batch(_stack(8), "cpu"))
    eval_epoch(params, 2, driver.device_batch(_stack(6), "cpu"), True)
    refs = [weakref.ref(g) for path in ("train", "eval_epoch") for g in graphs_of(path).values()]
    assert len(refs) >= 2
    collecting = gc.isenabled()
    gc.disable()
    try:
        GRAPHS.clear()
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("backend", BACKENDS)
def test_epoch_dispatch_predicate(backend):
    """A CUDA graph for every fixed-step backend on a CUDA device without
    ranks; eager, with its reason, on the CPU, with ranks whose reduce is
    not marked capturable, and on the adaptive backends and
    semilinear_timepar (ranks over NCCL and gloo:
    tests/test_torch_graph_ranks.py)."""
    cfg = load_cvs_config()
    cfg.ode_backend = backend
    spec = cvs_spec(cfg, n_time=T)
    capturable = backend not in NOT_CAPTURED
    assert solve_is_capturable(spec.decoder.ode) == capturable
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert svi.epoch_dispatch(spec, cuda) == ("cuda graph" if capturable else
                                              f"eager ({backend}: {svi.NOT_CAPTURABLE[backend]})")
    assert svi.epoch_dispatch(spec, "cuda:1") == svi.epoch_dispatch(spec, cuda)
    assert svi.epoch_dispatch(spec, cpu) == "eager (on cpu: a CUDA graph needs a CUDA device)"
    assert svi.epoch_dispatch(spec, cuda, reduce=lambda tree: tree) == \
        "eager (ranks: the reduce is not marked capturable)"


def test_capture_on_the_cpu_raises():
    """The graph helper refuses a CPU device; its plain version runs the
    body on any device; an unknown dispatch is refused."""
    buf = torch.zeros(3)

    def body():
        buf.add_(1.0)
        return {"sum": buf.sum()}

    with pytest.raises(ValueError, match="CUDA device"):
        Graph(body, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        Graph(body, torch.device("cpu"), warm=0)
    plain = Graph(body, "cpu", plain=True)
    assert [float(plain()["sum"]) for _ in range(3)] == [3.0, 6.0, 9.0]
    _, pspec = _specs()
    with pytest.raises(ValueError, match="dispatch"):
        svi.make_train_step(pspec, torch.arange(float(T)), LR, init_params(pspec, 0, device="cpu"), dispatch="graph")


def test_counted_wrapper_keeps_its_counts_on_the_plain_graph():
    """A wrapper registered with ``counted`` starts its counters at zero and
    is among those a capture reads; called inside a graph's plain version
    (a :class:`graphs.Replayed` over buffers), its launches and variants
    count each call, as an eager call does."""
    def wrapper(x, variant):
        graphs.count(wrapper, variant)
        wrapper.leaves += x.numel()
        return x + 1.0

    assert graphs.counted(wrapper, ints=("launches", "leaves"), variants=True) is wrapper
    assert wrapper.launches == wrapper.leaves == 0 and not wrapper.variants
    run = graphs.Replayed(lambda x: {"y": wrapper(x["x"], ("a", 3))}, {"x": torch.zeros(3)}, "cpu", plain=True)
    for i in range(3):
        assert torch.equal(run({"x": torch.full((3,), float(i))})["y"], torch.full((3,), i + 1.0))
    wrapper(torch.zeros(2), ("b", 2))
    assert (wrapper.launches, wrapper.leaves, dict(wrapper.variants)) == (4, 11, {("a", 3): 3, ("b", 2): 1})
    counts = graphs._counts()
    assert counts[wrapper, "launches"] == 4 and counts[wrapper, "leaves"] == 11
    assert counts[wrapper, "variants", ("a", 3)] == 3

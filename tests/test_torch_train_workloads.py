"""End to end on the CPU: the PyTorch port's proc and challenge training
drivers (``training_proc.main``, ``training_challenge.main``, ``--device cpu
--num-epochs 1 --no-plot --no-eval-train --num-samples 2``) on the datasets in
``datasets/``. Each run writes the JAX package's ``.npy`` artifact contract
(the sample dump included), which the JAX package's eval CLI scores
unchanged, and a ``best_model.npz`` that both packages' ``serve.load_model``
restore. The selection policies hold: proc keeps the lowest val ELBO and
records ``epoch + 1`` (under ``--heldout`` the last epoch), challenge keeps
the lowest mean train loss; challenge's minibatch is clamped to 32 for its 28
train subjects. The options that are not ported yet raise, naming their
ROADMAP item.
"""

import os

import jax
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch import serve as port_serve
from structured_latent_odes_tpu_torch import training_challenge, training_proc
from structured_latent_odes_tpu_torch.data.configs import LOADERS
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

ARGS = ["--num-epochs", "1", "--no-plot", "--no-eval-train", "--num-samples", "2", "--device", "cpu"]
DRIVERS = {"proc": training_proc, "challenge": training_challenge}
# the test (val) fold, channels, time points, ODE state, latent
SHAPES = {"proc": (78, 4, 100, 8, 50), "challenge": (7, 4, 142, 5, 15)}
LABEL_FILES = {"proc": {"treatments.npy": (2,), "devices.npy": (7,)},
               "challenge": {"shedding.npy": (), "symptoms.npy": ()}}


def _run(dataset, root, extra=()):
    """One training run, recording each epoch's selection: (epoch, val ELBO
    sum, mean train loss, the best after it), and the config it ran with."""
    module = DRIVERS[dataset]
    orig = module.run_training_epochs
    calls, seen = [], {}

    def recording(**kw):
        select = kw["select_best"]
        seen["config"] = kw["config"]

        def select_best(epoch, val, train_s, best, params, losses):
            new = select(epoch, val, train_s, best, params, losses)
            calls.append((epoch, float(np.sum(val["post"].elbo)), float(np.mean(losses)), new))
            return new

        return orig(**{**kw, "select_best": select_best})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "run_training_epochs", recording)
        out = module.main(["--results-root", str(root)] + ARGS + list(extra))
    return out, calls, seen["config"]


@pytest.fixture(scope="module", params=["proc", "challenge"])
def trained(request, tmp_path_factory):
    dataset = request.param
    out, calls, config = _run(dataset, tmp_path_factory.mktemp(dataset))
    return dataset, out, calls, config


def test_training_writes_the_artifact_contract(trained):
    dataset, out, _, _ = trained
    rd = out["out_dir"]
    n, k, t, d, latent = SHAPES[dataset]
    shapes = {"observations.npy": (n, k, t), "times.npy": (t,), "best_model.npz": None,
              "best_model.npz.json": None, "model.log": None,
              **{name: (n,) + s for name, s in LABEL_FILES[dataset].items()}}
    for tag in ("post", "prior"):
        shapes.update({f"{q}_{tag}.npy": (n, k, t) for q in ("mu_25", "mu_50", "mu_75")})
        shapes.update({f"{q}_{tag}_sample.npy": (n, k, t, 2) for q in ("mu_25", "mu_50", "mu_75")})
        shapes[f"solution_xt_{tag}.npy"] = (n, t, d)
        shapes[f"z_{tag}.npy"] = (n, latent)
    for name, shape in shapes.items():
        path = os.path.join(rd, name)
        assert os.path.exists(path), name
        if shape is not None:
            arr = np.load(path)
            assert arr.shape == shape and np.isfinite(arr).all(), (name, arr.shape, shape)
    with open(os.path.join(rd, "model.log")) as f:
        log = f.read()
    assert log.count("[Epoch ") == 2 and "FINAL TEST:" in log
    # the two sample draws differ: each has its own seed
    bands = np.load(os.path.join(rd, "mu_50_prior_sample.npy"))
    assert not np.array_equal(bands[..., 0], bands[..., 1])


def test_jax_eval_scores_the_artifacts(trained):
    from structured_latent_odes_tpu.eval.__main__ import main as jax_eval

    dataset, out, _, _ = trained
    scores = jax_eval([dataset, out["out_dir"]])
    for tag in ("post", "prior"):
        assert scores[tag] is not None and np.isfinite(scores[tag]) and scores[tag] > 0


def test_checkpoint_restores_in_both_packages(trained):
    from structured_latent_odes_tpu.data.configs import LOADERS as JAX_LOADERS
    from structured_latent_odes_tpu.serve import load_model as jax_load_model

    dataset, out, _, _ = trained
    path = os.path.join(out["out_dir"], "best_model.npz")
    _, jparams, _, _ = jax_load_model(dataset, path, JAX_LOADERS[dataset]())
    _, params, _, splits = port_serve.load_model(dataset, path, LOADERS[dataset](), device="cpu")
    best = jax.tree.leaves(params_to_jax(out["best"]["params"]))
    for a, b, c in zip(jax.tree.leaves(jparams), jax.tree.leaves(params_to_jax(params)), best):
        np.testing.assert_array_equal(np.asarray(a), c)
        np.testing.assert_array_equal(b, c)
    assert splits["val"]["observations"].shape[0] == SHAPES[dataset][0]


def test_selection_policy(trained):
    dataset, out, calls, config = trained
    best = out["best"]
    assert [c[0] for c in calls] == [0, 1]
    if dataset == "proc":  # the lowest val ELBO, recorded as epoch + 1
        i = int(np.argmin([c[1] for c in calls]))
        assert best["epoch"] == i + 1 and best["criterion"] == calls[i][1]
    else:  # the lowest mean train loss, recorded as the epoch
        i = int(np.argmin([c[2] for c in calls]))
        assert best["epoch"] == i and best["criterion"] == calls[i][2]
        assert config.mini_batch_size == 32  # 28 train subjects, padded to a multiple of 8
    assert best["params"] is calls[i][3]["params"]


def test_test_l1_counts_only_real_rows(trained):
    """The padding rows of the test batches reach no statistic: proc's 78 val
    rows go in batches of 36 (the last holds 6 rows and 30 padding rows),
    challenge's 7 in one batch of 32. The test L1 is the sum of the batches'
    masked means over the fold's size, as in the JAX driver."""
    dataset, out, _, config = trained
    rd = out["out_dir"]
    err = np.abs(np.load(os.path.join(rd, "mu_50_post.npy")) - np.load(os.path.join(rd, "observations.npy")))
    n = len(err)
    bs = max(config.mini_batch_size, n) if dataset == "challenge" else config.mini_batch_size
    assert (n, bs) == {"proc": (78, 36), "challenge": (7, 32)}[dataset]
    expected = sum(err[i:i + bs].mean() for i in range(0, n, bs)) / n
    np.testing.assert_allclose(out["test_post"].l1, expected, rtol=1e-5)


def test_proc_heldout_overwrites_every_epoch(tmp_path):
    out, calls, _ = _run("proc", tmp_path, ["--heldout", "R33S34_Y81C76"])
    assert out["best"]["epoch"] == 2 and out["best"]["criterion"] == calls[-1][1]
    assert np.load(os.path.join(out["out_dir"], "devices.npy")).shape == (48, 7)


UNPORTED = [
    (["--num-epochs", "1", "--device", "cpu"], "A11"),  # plotting on
    (ARGS + ["--checkpoint-every", "1"], "A10-rest"),
    (ARGS + ["--resume"], "A10-rest"),
    (ARGS + ["--profile-dir", "prof"], "A17"),
    (ARGS + ["--data-parallel", "2"], "A17"),
    (ARGS + ["--time-parallel", "2"], "A17"),
    (ARGS + ["--prior-refit-epochs", "2"], None),  # ported: runs (tests/test_torch_ensemble.py holds its numbers)
    (ARGS + ["--ode-backend", "generic"], "A14"),
    (ARGS + ["--ode-backend", "semilinear_auto"], "A19"),
]
UNPORTED_IDS = ["plot", "checkpoint-every", "resume", "profile-dir", "data-parallel", "time-parallel",
                "prior-refit", "generic", "semilinear_auto"]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=UNPORTED_IDS)
@pytest.mark.parametrize("dataset", ["proc", "challenge"])
def test_unported_options_raise(dataset, tmp_path, argv, item):
    """Each option not ported yet raises, naming its ROADMAP item; an option
    ported since (item None) runs to the end instead."""
    argv = ["--results-root", str(tmp_path)] + argv
    if item is None:
        out = DRIVERS[dataset].main(argv)
        assert all(torch.isfinite(p).all() for p in tree_leaves(out["best"]["params"]))
        return
    with pytest.raises(NotImplementedError, match=item):
        DRIVERS[dataset].main(argv)

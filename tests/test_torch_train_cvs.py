"""End to end on the CPU: the PyTorch port's CVS training driver
(training_cvs.main, ``--device cpu``) on a tiny generated dataset writes the
JAX package's ``.npy`` artifact contract, which the JAX package's eval scores
unchanged, and a ``best_model.npz`` that both packages' ``serve.load_model``
restore. The options that are not ported yet raise, naming their ROADMAP
item; those ported since run.
"""

import os

import jax  # noqa: F401  (the JAX package's eval and serve run here on the CPU)
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch import serve as port_serve
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.interop import params_to_jax
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_reference_pickles import write_reference_pickles

# the artifact files of tests/test_e2e_cvs.py, plus the rest of the contract
ARTIFACTS = (
    "observations.npy", "iext.npy", "rtpr.npy", "times.npy",
    "mu_50_post.npy", "mu_50_prior.npy", "solution_xt_post.npy",
    "z_post.npy", "best_model.npz", "model.log",
    "mu_25_post.npy", "mu_75_post.npy", "mu_25_prior.npy", "mu_75_prior.npy",
    "solution_xt_prior.npy", "z_prior.npy", "best_model.npz.json",
)
ARGS = ["--num-epochs", "1", "--mini-batch-size", "16", "--no-plot", "--no-eval-train", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=30, seed=0, device="cpu")
    return d


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("results"))
    out = training_cvs.main(["--data-path", data_dir, "--results-root", root] + ARGS)
    return out, os.path.join(root, "results_Mechanistic")


def _config(data_dir):
    from structured_latent_odes_tpu_torch.data.configs import load_cvs_config

    cfg = load_cvs_config()
    cfg.data_path = data_dir
    return cfg


def test_training_writes_the_artifact_contract(trained):
    out, rd = trained
    assert out["out_dir"] == rd
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(rd, name)), name
    n_test = 3  # 30 trajectories: 27 train+val, 3 test
    assert np.load(os.path.join(rd, "mu_50_post.npy")).shape == (n_test, 3, 86)
    assert np.load(os.path.join(rd, "solution_xt_prior.npy")).shape == (n_test, 86, 5)
    assert np.load(os.path.join(rd, "z_post.npy")).shape == (n_test, 15)
    assert np.load(os.path.join(rd, "iext.npy")).shape == (n_test,)
    assert np.isfinite(out["test_post"].l1) and all(np.isfinite(out["test_prior"].elbo))
    with open(os.path.join(rd, "model.log")) as f:
        log = f.read()
    assert log.count("[Epoch ") == 2 and "FINAL TEST:" in log and "ELBO: best_epoch:" in log


def test_jax_eval_scores_the_artifacts(trained):
    from structured_latent_odes_tpu.eval import cvs_class_averaged_l1

    _, rd = trained
    for tag in ("post", "prior"):
        l1 = cvs_class_averaged_l1(rd, tag)
        assert np.isfinite(l1) and l1 > 0


def test_checkpoint_restores_in_both_packages(trained, data_dir):
    from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
    from structured_latent_odes_tpu.serve import load_model as jax_load_model

    out, rd = trained
    path = os.path.join(rd, "best_model.npz")
    jcfg = jax_cvs_config()
    jcfg.data_path = data_dir
    _, jparams, _, _ = jax_load_model("cvs", path, jcfg)
    spec, params, times, splits = port_serve.load_model("cvs", path, _config(data_dir), device="cpu")
    # the restored leaves are the best params the run selected
    best = out["best"]["params"]
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params_to_jax(best))):
        np.testing.assert_array_equal(np.asarray(a), b)
    recon_fn, _ = port_serve.make_predict_fns(spec, times, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in splits["test"].items()}
    r = recon_fn(params, 0, batch, True)
    assert r["mu_50"].shape == batch["observations"].shape and torch.isfinite(r["mu_50"]).all()


@pytest.mark.parametrize("argv,item", [
    (["--num-epochs", "1", "--device", "cpu"], None),  # plotting on: ported, runs and draws
    (ARGS + ["--checkpoint-every", "1"], None),  # ported: runs (tests/test_torch_resume.py holds resume)
    (ARGS + ["--resume"], None),  # ported: no train_state.npz, so a fresh run
    (ARGS + ["--profile-dir", "prof"], None),  # ported: runs (tests/test_torch_profiling.py)
    (ARGS + ["--data-parallel", "2"], None),  # ported (A17): two ranks over gloo (tests/test_torch_parallel.py)
    (ARGS + ["--prior-refit-epochs", "2"], None),  # ported: runs (tests/test_torch_ensemble.py holds its numbers)
    (ARGS + ["--reference-data-dir", "ref"], None),  # ported: reads pickles (tests/test_torch_cvs_pickles.py)
], ids=["plot", "checkpoint-every", "resume", "profile-dir", "data-parallel", "prior-refit", "reference-data"])
def test_unported_options_raise(data_dir, tmp_path, argv, item):
    """Each option not ported yet raises, naming its ROADMAP item; an option
    ported since (item None) runs to the end instead, and writes what it is
    for. Relative paths in ``argv`` name directories under ``tmp_path``; the
    reference pickles are written there from ``data_dir``'s ``cvs.npz``."""
    argv = [str(tmp_path / a) if a in ("prof", "ref") else a for a in argv]
    if "--reference-data-dir" in argv:
        write_reference_pickles(os.path.join(data_dir, "cvs.npz"), str(tmp_path / "ref"))
    argv = ["--data-path", data_dir, "--results-root", str(tmp_path)] + argv
    if item is None:
        out = training_cvs.main(argv)
        assert all(torch.isfinite(p).all() for p in jax.tree.leaves(out["best"]["params"]))
        rd = out["out_dir"]
        if "--checkpoint-every" in argv:
            assert os.path.exists(os.path.join(rd, "train_state.npz"))
        if "--profile-dir" in argv:
            assert len(os.listdir(tmp_path / "prof")) == 1
        if "--no-plot" not in argv:
            assert {"val_0_post.png", "z_TSNE_0.png", f"test_{out['best']['epoch']}_post.png"} <= set(os.listdir(rd))
        return
    with pytest.raises(NotImplementedError, match=item):
        training_cvs.main(argv)


def test_cuda_device_without_a_card_fails_loudly(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        training_cvs.main(["--data-path", data_dir, "--results-root", str(tmp_path)] + ARGS[:-2])

"""The PyTorch port's plots and figures (``utils/plotting.py``,
``eval/figures.py``, ``eval --figures``, the training CLIs' plot epochs)
against the JAX package's, on the CPU.

From one artifacts directory per dataset both packages' ``eval --figures``
write the same files, pixel for pixel (``matplotlib.image.imread``); each
plotting function, given the same arrays, writes the same file names as
JAX's, pixel for pixel (``visualize_latent`` at the same ``random_state``). A
tiny CVS run with ``plot_epoch = 1`` writes the JAX CLI's set of file names.
Without matplotlib (or scikit-learn, for the latent t-SNE) a run with
plotting on raises naming the package and ``--no-plot`` before it loads any
data; with ``--no-plot`` it runs.
"""

import contextlib
import io
import os
import sys

import matplotlib.image
import numpy as np
import pytest

from structured_latent_odes_tpu.eval import __main__ as jax_eval_cli
from structured_latent_odes_tpu.utils import plotting as jax_plotting
from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.eval import __main__ as eval_cli
from structured_latent_odes_tpu_torch.utils import plotting
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

N, T, D, L = 6, 12, 5, 15
K = {"cvs": 3, "challenge": 4, "proc": 4}


def _artifacts(d, dataset, seed=0):
    """An artifacts directory with the contract's names and layouts."""
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(seed)
    obs = r.rand(N, K[dataset], T).astype(np.float32)
    np.save(os.path.join(d, "observations.npy"), obs)
    np.save(os.path.join(d, "times.npy"), np.arange(T, dtype=np.float32))
    if dataset == "proc":
        devices = np.zeros((N, 7), np.float32)
        devices[np.arange(N), r.randint(0, 3, N)] = 1.0
        labels = {"treatments": np.log1p(r.choice([0.0, 5.0, 25.0], size=(N, 2))).astype(np.float32),
                  "devices": devices}
    else:
        names = ("iext", "rtpr") if dataset == "cvs" else ("shedding", "symptoms")
        labels = {n: r.randint(0, 2, N).astype(np.float32) for n in names}
    for name, arr in labels.items():
        np.save(os.path.join(d, name + ".npy"), arr)
    for tag in ("post", "prior"):
        for q in ("mu_25", "mu_50", "mu_75"):
            np.save(os.path.join(d, f"{q}_{tag}.npy"), (obs + 0.1 * r.randn(*obs.shape)).astype(np.float32))
        np.save(os.path.join(d, f"solution_xt_{tag}.npy"), r.randn(N, T, D).astype(np.float32))
        np.save(os.path.join(d, f"z_{tag}.npy"), r.randn(N, L).astype(np.float32))
    return d


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def _assert_same_pngs(ours, ref):
    names = _pngs(ref)
    assert names and _pngs(ours) == names
    for name in names:
        a, b = matplotlib.image.imread(os.path.join(ours, name)), matplotlib.image.imread(os.path.join(ref, name))
        assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("dataset", ["cvs", "challenge", "proc"])
def test_eval_figures_match_jax(tmp_path, dataset, capsys):
    ours, ref = _artifacts(str(tmp_path / "port"), dataset), _artifacts(str(tmp_path / "jax"), dataset)
    os.remove(os.path.join(ours, "z_prior.npy"))  # a missing artifact: the tag is skipped with a message
    os.remove(os.path.join(ref, "z_prior.npy"))
    eval_cli.main([dataset, ours, "--figures"])
    port_out = capsys.readouterr().out.replace(ours, "DIR")
    jax_eval_cli.main([dataset, ref, "--figures"])
    assert port_out == capsys.readouterr().out.replace(ref, "DIR")
    _assert_same_pngs(ours, ref)
    assert len(_pngs(ours)) == {"cvs": 4, "challenge": 6, "proc": 2}[dataset]


def test_eval_figures_skip_a_directory_without_artifacts(tmp_path, capsys):
    eval_cli.main(["cvs", str(tmp_path), "--figures"])
    skipped = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[skip figures")]
    assert len(skipped) == 2 and not _pngs(str(tmp_path))


def _plot_args(dataset):
    r = np.random.RandomState(3)
    obs = r.rand(N, K[dataset], T).astype(np.float32)
    recon = {q: (obs + 0.1 * r.randn(*obs.shape)).astype(np.float32) for q in ("mu_25", "mu_50", "mu_75")}
    return obs, recon, np.arange(T, dtype=np.float32), r


@pytest.mark.parametrize("fn", ["plot_label_grid", "plot_by_device", "visualize_latent"])
def test_plotting_functions_match_jax(tmp_path, fn):
    outs = []
    for name, module in (("port", plotting), ("jax", jax_plotting)):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs, recon, times, r = _plot_args("proc" if fn == "plot_by_device" else "cvs")
        if fn == "plot_label_grid":
            labels = {"iext": r.randint(0, 2, (N, 1)).astype(np.float32),
                      "rtpr": r.randint(0, 2, (N, 1)).astype(np.float32)}
            module.plot_label_grid(d, "val_0_post", obs, recon, times, labels, ("Pa", "Pv", "fHR"))
        elif fn == "plot_by_device":
            devices = np.zeros((N, 7), np.float32)
            devices[np.arange(N), r.randint(0, 2, N)] = 1.0
            treatments = np.log1p(r.choice([0.0, 5.0, 25.0], size=(N, 2))).astype(np.float32)
            module.plot_by_device(d, "val_0_post", obs, recon, times, devices, treatments,
                                  ("OD", "mRFP1", "EYFP", "ECFP"))
        else:
            module.visualize_latent(d, r.randn(N, L).astype(np.float32), r.randn(N, L).astype(np.float32), 3, 7)
        outs.append(d)
    _assert_same_pngs(*outs)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=20, seed=0, device="cpu")
    return d


def test_plot_epochs_write_the_jax_cli_file_names(data_dir, tmp_path):
    args = training_cvs.parse_args(["--data-path", data_dir, "--results-root", str(tmp_path), "--num-epochs", "2",
                                    "--mini-batch-size", "8", "--no-eval-train", "--device", "cpu"])
    config = load_cvs_config()
    training_cvs.configure(config, args)
    config.plot_epoch = 1
    with contextlib.redirect_stdout(io.StringIO()):
        out = training_cvs.train(config, device="cpu")
    # the JAX CLI's names: on_epoch's grid and t-SNE each plot epoch, and the
    # test split's grids at the best epoch
    best = out["best"]["epoch"]
    expected = {f"val_{e}_post.png" for e in range(3)} | {f"z_TSNE_{e}.png" for e in range(3)}
    expected |= {f"test_{best}_post.png", f"test_{best}_prior.png"}
    assert set(_pngs(out["out_dir"])) == expected


@pytest.mark.parametrize("missing,package", [("matplotlib", "matplotlib"), ("sklearn", "scikit-learn")])
def test_missing_plot_package_raises_before_training(data_dir, tmp_path, monkeypatch, capsys, missing, package):
    monkeypatch.setitem(sys.modules, missing, None)
    argv = ["--data-path", data_dir, "--results-root", str(tmp_path), "--num-epochs", "1", "--device", "cpu"]
    with pytest.raises(ImportError, match=f"{package} .*--no-plot"):
        training_cvs.main(argv)
    out = capsys.readouterr().out
    assert "TRAIN obs=" not in out and "[Epoch" not in out
    out = training_cvs.main(argv + ["--no-plot", "--mini-batch-size", "8"])  # no plots: it runs
    assert not _pngs(out["out_dir"])

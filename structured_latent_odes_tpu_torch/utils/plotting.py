"""Plotting (the JAX package's ``utils/plotting.py``): per-sample trajectory
grids with quantile bands grouped by label combination (CVS, challenge),
per-device dose panels (proc), and a t-SNE of prior against posterior
latents. Every function consumes numpy arrays and saves PNGs into the results
directory.

matplotlib (with the Agg backend) and scikit-learn are imported inside the
functions, so importing this module needs neither; :func:`require` checks
for them before a run starts.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, Sequence

import numpy as np

# the packages plotting imports, by import name, with their distribution name
PACKAGES = {"matplotlib": "matplotlib", "sklearn": "scikit-learn"}


def require(latent: bool = True) -> None:
    """Raise an ImportError naming the package and ``--no-plot`` when
    matplotlib, or scikit-learn for the latent t-SNE, cannot be imported."""
    for name in ("matplotlib", "sklearn") if latent else ("matplotlib",):
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(
                f"plotting needs {PACKAGES[name]} ({name}), which cannot be imported ({e}); "
                "pass --no-plot to run without plots"
            ) from None


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _band_grid(
    path: str,
    observations: np.ndarray,  # (N, K, T)
    mu_50: np.ndarray,
    mu_75: np.ndarray,
    mu_25: np.ndarray,
    times: np.ndarray,
    row_idx: Sequence[int],
    row_titles: Sequence[str],
    col_titles: Sequence[str],
) -> None:
    plt = pyplot()
    n_rows, n_cols = len(row_idx), observations.shape[1]
    fig, axs = plt.subplots(
        n_rows, n_cols, sharex=True, sharey=True, figsize=(3 * n_cols, 1.8 * n_rows), squeeze=False
    )
    for r, loc in enumerate(row_idx):
        for c in range(n_cols):
            ax = axs[r][c]
            ax.plot(times, observations[loc, c], "k.", markersize=2)
            ax.plot(times, mu_50[loc, c], "-", lw=1.5, alpha=0.8)
            ax.plot(times, mu_75[loc, c], "--", lw=1, alpha=0.7)
            ax.plot(times, mu_25[loc, c], "--", lw=1, alpha=0.7)
            if r == 0:
                ax.set_title(col_titles[c])
        axs[r][0].set_ylabel(row_titles[r], fontsize=8)
    fig.supxlabel("Time")
    fig.supylabel("Normalized output")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_label_grid(
    out_dir: str,
    name: str,
    observations: np.ndarray,
    recon: Dict[str, np.ndarray],
    times: np.ndarray,
    label_rows: Dict[str, np.ndarray],  # binary labels, e.g. {iext, rtpr}
    channel_names: Sequence[str],
    max_per_combo: int = 3,
) -> None:
    """One row per sample, grouped by binary-label combination (the CVS /
    challenge per-sample grids)."""
    keys = list(label_rows)
    lab = np.stack([np.asarray(label_rows[k]).reshape(-1) for k in keys], axis=1)
    row_idx, row_titles = [], []
    for combo in np.unique(lab, axis=0):
        locs = np.where(np.all(lab == combo, axis=1))[0][:max_per_combo]
        row_idx.extend(locs.tolist())
        row_titles.extend(
            ["{}={}".format(",".join(keys), ",".join(str(int(v)) for v in combo))] * len(locs)
        )
    if not row_idx:
        return
    _band_grid(
        os.path.join(out_dir, name),
        observations,
        recon["mu_50"],
        recon["mu_75"],
        recon["mu_25"],
        times,
        row_idx,
        row_titles,
        channel_names,
    )


def plot_by_device(
    out_dir: str,
    name: str,
    observations: np.ndarray,  # (N, K, T)
    recon: Dict[str, np.ndarray],
    times: np.ndarray,
    devices_onehot: np.ndarray,  # (N, depth) cassette encodings
    treatments: np.ndarray,  # (N, 2) log1p inputs [C12, C6]
    channel_names: Sequence[str],
    max_treatments: int = 6,
) -> None:
    """Per-device panels ordered by treatment dose (the proc plots)."""
    for device in np.unique(devices_onehot, axis=0):
        sel = np.all(devices_onehot == device, axis=1)
        locs = np.where(sel & (treatments.max(axis=1) > 0))[0]
        if len(locs) == 0:
            continue
        order = np.argsort(treatments[locs].max(axis=1))
        locs = locs[order][:max_treatments]
        titles = [
            "C12=%.1f C6=%.1f" % (np.expm1(treatments[l, 0]), np.expm1(treatments[l, 1]))
            for l in locs
        ]
        dev_tag = "_".join(str(int(v)) for v in device)
        _band_grid(
            os.path.join(out_dir, f"{name}_dev_{dev_tag}"),
            observations,
            recon["mu_50"],
            recon["mu_75"],
            recon["mu_25"],
            times,
            locs,
            titles,
            channel_names,
        )


def visualize_latent(
    out_dir: str, z_post: np.ndarray, z_prior: np.ndarray, epoch: int, seed: int = 0
) -> None:
    """t-SNE of posterior vs prior latent samples (the reference's
    ``visualize_latent``)."""
    from sklearn.manifold import TSNE

    z_all = np.concatenate([z_post, z_prior], axis=0)
    perplexity = min(10, max(2, len(z_all) // 4))
    emb = TSNE(
        random_state=seed, perplexity=perplexity, n_components=2, init="pca"
    ).fit_transform(z_all)
    n = len(z_post)
    plt = pyplot()
    fig = plt.figure(figsize=(5, 4))
    plt.scatter(emb[:n, 0], emb[:n, 1], facecolors="none", edgecolors="tab:blue", label="Z_post")
    plt.scatter(emb[n:, 0], emb[n:, 1], facecolors="none", edgecolors="tab:red", label="Z_prior")
    plt.legend()
    plt.tight_layout()
    fig.savefig(os.path.join(out_dir, f"z_TSNE_{epoch}"), dpi=100)
    plt.close(fig)

"""Aggregate evaluation figures (the JAX package's ``eval/figures.py``; the
reference notebooks' plots): class- and outcome-averaged trajectory bands,
the synbio end-point dose response, the latent ODE state panels and the
per-subject trajectories, rendered from the ``.npy`` artifacts.

matplotlib is imported inside the functions (``utils/plotting.pyplot``), so
importing this module does not need it.
"""

from __future__ import annotations

import os

import numpy as np

from structured_latent_odes_tpu_torch.eval.metrics import load_artifacts
from structured_latent_odes_tpu_torch.utils.plotting import pyplot


def class_averaged_bands(
    results_dir: str, tag: str, label_names, channel_names, out_name: str
) -> str:
    """Rows = label columns, cols = channels; one averaged band per label
    value (cvs_eval_final / challenge_eval_folds style)."""
    a = load_artifacts(results_dir, tag)
    plt = pyplot()
    labels = np.stack([a[n].reshape(-1) for n in label_names], axis=1)
    K = a["y"].shape[1]
    fig, axs = plt.subplots(
        len(label_names), K, sharex=True, sharey=True, figsize=(3 * K, 2.2 * len(label_names)),
        squeeze=False,
    )
    colors = ("tab:blue", "tab:red")
    for r, lname in enumerate(label_names):
        for v, color in zip((0.0, 1.0), colors):
            idx = labels[:, r] == v
            if idx.sum() == 0:
                continue
            y_av = a["y"][idx].mean(0)
            mu_av = a["mu_50"][idx].mean(0)
            lo_av = a["mu_25"][idx].mean(0)
            hi_av = a["mu_75"][idx].mean(0)
            for c in range(K):
                ax = axs[r][c]
                ax.plot(a["times"], y_av[c], ".", ms=2, color=color,
                        label=f"{lname}={int(v)}" if c == 0 else None)
                ax.plot(a["times"], mu_av[c], "-", lw=1.5, color=color, alpha=0.8)
                ax.fill_between(a["times"], lo_av[c], hi_av[c], color=color, alpha=0.12)
                if r == 0:
                    ax.set_title(channel_names[c])
        axs[r][0].set_ylabel(lname)
        axs[r][0].legend(fontsize=7)
    fig.supxlabel("Time")
    fig.supylabel("Normalized output")
    fig.tight_layout()
    path = os.path.join(results_dir, out_name)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def synbio_dose_response(results_dir: str, tag: str, channel_names, out_name: str) -> str:
    """End-point value vs dose per device/condition (sbio notebook cells 5-7)."""
    a = load_artifacts(results_dir, tag)
    plt = pyplot()
    treatment, devices = a["treatments"], a["devices"]
    unique_devices = np.unique(devices, axis=0)
    K = a["y"].shape[1]
    fig, axs = plt.subplots(
        len(unique_devices), K, sharex=True, sharey=True,
        figsize=(2.6 * K, 2.0 * len(unique_devices)), squeeze=False,
    )
    cond_colors = ("tab:green", "tab:purple")
    for r, device in enumerate(unique_devices):
        sel_device = np.all(devices == device, axis=1)
        for ci, color in enumerate(cond_colors):
            for treat in np.unique(treatment):
                idx = (treatment[:, ci] == treat) & sel_device
                if idx.sum() == 0:
                    continue
                y_end = a["y"][idx].mean(0)[:, -1]
                mu_end = a["mu_50"][idx].mean(0)[:, -1]
                for c in range(K):
                    axs[r][c].scatter(treat, y_end[c], marker="x", s=14, color=color)
                    axs[r][c].scatter(treat, mu_end[c], marker="o", s=14,
                                      facecolors="none", edgecolors=color)
        for c in range(K):
            if r == 0:
                axs[r][c].set_title(channel_names[c])
        axs[r][0].set_ylabel("dev " + "".join(str(int(x)) for x in device), fontsize=7)
    fig.supxlabel("log1p dose (x=data, o=model)")
    fig.supylabel("End-point output")
    fig.tight_layout()
    path = os.path.join(results_dir, out_name)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def latent_dynamics_panels(
    results_dir: str, tag: str, label_names, out_name: str
) -> str:
    """Class-averaged ODE state trajectories: rows = label combinations,
    cols = latent ODE state dims (cvs_eval_final.ipynb cells 13-14 — the
    ``solution_xt`` panels next to the observation bands)."""
    a = load_artifacts(results_dir, tag)
    plt = pyplot()
    x = np.load(os.path.join(results_dir, f"solution_xt_{tag}.npy"))  # (N, T, D)
    labels = np.stack([a[n].reshape(-1) for n in label_names], axis=1)
    combos = np.unique(labels, axis=0)
    D = x.shape[2]
    fig, axs = plt.subplots(
        len(combos), D, sharex=True, sharey=True,
        figsize=(2.2 * D, 1.9 * len(combos)), squeeze=False,
    )
    colors = ("tab:gray", "r", "y", "c", "green", "tab:blue", "tab:purple", "tab:olive")
    for r, combo in enumerate(combos):
        loc = np.all(labels == combo, axis=1)
        x_av = x[loc].mean(0)  # (T, D)
        for c in range(D):
            axs[r][c].plot(a["times"], x_av[:, c], "-", lw=2, alpha=0.75,
                           color=colors[c % len(colors)])
            if r == 0:
                axs[r][c].set_title(f"x_{c}")
        axs[r][0].set_ylabel(
            ",".join(f"{n}={int(v)}" for n, v in zip(label_names, combo)), fontsize=7
        )
    fig.supxlabel("Time")
    fig.supylabel("ODE state")
    fig.tight_layout()
    path = os.path.join(results_dir, out_name)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def per_subject_trajectories(
    results_dir: str, tag: str, label_names, channel_names, out_name: str,
    max_subjects: int = 0,
) -> str:
    """Per-subject renormalized trajectory grid
    (challenge_eval_folds_subject_final.ipynb cells 3-6): every channel is
    re-min-max-normalized to [0, 1] using norm params computed over the dumped
    test observations (the notebook's ``re_normalize``), then each subject
    gets a column of per-channel panels — median prediction, quantile band,
    and the data dots."""
    from structured_latent_odes_tpu_torch.data.transforms import find_norm_params

    a = load_artifacts(results_dir, tag)
    plt = pyplot()
    # norm params over channels-last data, exactly as the notebook (cell 3)
    p = find_norm_params(np.swapaxes(a["y"], 1, 2))
    span = np.where(p["max"] > p["min"], p["max"] - p["min"], 1.0)

    def renorm(data):  # (N, K, T) -> [0, 1] per channel
        return (data - p["min"][None, :, None]) / span[None, :, None]

    y = renorm(a["y"])
    mu_50, mu_25, mu_75 = renorm(a["mu_50"]), renorm(a["mu_25"]), renorm(a["mu_75"])
    labels = np.stack([a[n].reshape(-1) for n in label_names], axis=1)

    n = y.shape[0] if not max_subjects else min(max_subjects, y.shape[0])
    K = y.shape[1]
    fig, axs = plt.subplots(
        K, n, sharex=True, sharey=True, figsize=(2.2 * n, 1.8 * K), squeeze=False
    )
    colors = [plt.cm.rainbow(v) for v in np.linspace(0, 1, K)]
    for pid in range(n):
        for r in range(K):
            ax = axs[r][pid]
            ax.plot(a["times"], mu_50[pid, r], "-", color=colors[r], lw=2, alpha=0.75)
            ax.fill_between(a["times"], mu_25[pid, r], mu_75[pid, r],
                            color=colors[r], alpha=0.15)
            ax.plot(a["times"], y[pid, r], ".", color=colors[r], ms=2)
            ax.set_ylim(-0.05, 1.05)
            if pid == 0:
                ax.set_ylabel(channel_names[r], fontsize=8)
        axs[0][pid].set_title(
            ", ".join(f"{nm[:2]}={int(v)}" for nm, v in zip(label_names, labels[pid])),
            fontsize=7,
        )
    fig.supxlabel("Time (hrs)")
    fig.supylabel("Normalized output")
    fig.tight_layout()
    path = os.path.join(results_dir, out_name)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path

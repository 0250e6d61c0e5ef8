"""Aggregate evaluation metrics (the JAX package's ``eval/metrics.py``, the
port's own copy: numpy only) — faithful implementations of the headline
numbers computed by the reference's six evaluation notebooks (SURVEY.md §6 /
BASELINE.md), consuming the ``.npy`` artifact contract:

- CVS class-averaged L1            (cvs_eval_final.ipynb cells 6/7: 0.522/0.520)
- challenge outcome-averaged L1    (challenge_eval_folds.ipynb cells 4/5:
                                    post 38.620 / prior 38.969 on fold 5)
- synbio device-averaged L1        (sbio_eval_folds_final.ipynb cells 5/6:
                                    prior 16.524 / post 6.019 on split 1)
- synbio heldout zero-shot L1      (sbio_eval_heldout_final.ipynb cell 7:
                                    5.874 on device h22, 200-sample mean)
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def _load(results_dir: str, name: str) -> np.ndarray:
    return np.load(os.path.join(results_dir, name + ".npy"))


def load_artifacts(results_dir: str, tag: str) -> Dict[str, np.ndarray]:
    out = {
        "y": _load(results_dir, "observations"),
        "times": _load(results_dir, "times"),
        "mu_50": _load(results_dir, f"mu_50_{tag}"),
        "mu_25": _load(results_dir, f"mu_25_{tag}"),
        "mu_75": _load(results_dir, f"mu_75_{tag}"),
    }
    for opt in ("iext", "rtpr", "shedding", "symptoms", "treatments", "devices"):
        path = os.path.join(results_dir, opt + ".npy")
        if os.path.exists(path):
            out[opt] = np.load(path)
    return out


def _class_averaged_l1(pred: np.ndarray, target: np.ndarray, labels: np.ndarray) -> float:
    """Mean over label combos x channels of the summed |avg trajectory error|
    (the cvs_eval_final.ipynb cells 6/7 accumulation)."""
    combos = np.unique(labels, axis=0)
    K = target.shape[1]
    l1 = 0.0
    for combo in combos:
        loc = np.all(labels == combo, axis=1)
        for c in range(K):
            l1 += np.abs(pred[loc].mean(0)[c] - target[loc].mean(0)[c]).sum()
    return float(l1 / (K * len(combos)))


def cvs_class_averaged_l1(results_dir: str, tag: str) -> float:
    """Mean over (iext, rtpr) class combos x channels of the summed |avg
    trajectory error| (cvs_eval_final.ipynb cells 6/7)."""
    a = load_artifacts(results_dir, tag)
    labels = np.stack([a["iext"].reshape(-1), a["rtpr"].reshape(-1)], axis=1)
    return _class_averaged_l1(a["mu_50"], a["y"], labels)


def challenge_outcome_averaged_l1(results_dir: str, tag: str) -> float:
    """Mean over outcome columns x outcome values of sum|avg(mu50)-avg(y)|
    over all channels/timepoints (challenge_eval_folds.ipynb cells 4/5)."""
    a = load_artifacts(results_dir, tag)
    outcomes = np.stack([a["shedding"].reshape(-1), a["symptoms"].reshape(-1)], axis=1)
    errs = []
    for out_val in (0.0, 1.0):
        for t in range(outcomes.shape[1]):
            idx = outcomes[:, t] == out_val
            if idx.sum() == 0:
                continue
            errs.append(np.abs(a["mu_50"][idx].mean(0) - a["y"][idx].mean(0)).sum())
    return float(np.mean(errs))


def synbio_device_averaged_l1(results_dir: str, tag: str) -> float:
    """Per (device, treatment, condition) summed |avg error|, normalized by
    (n_treatments * n_channels * cassette depth)
    (sbio_eval_folds_final.ipynb cells 5/6)."""
    a = load_artifacts(results_dir, tag)
    treatment, devices = a["treatments"], a["devices"]
    unique_treat = np.unique(treatment)
    unique_devices = np.unique(devices, axis=0)
    K = a["y"].shape[1]
    l1 = 0.0
    for device in unique_devices:
        sel_device = np.all(devices == device, axis=1)
        for treat in unique_treat:
            for ci in range(treatment.shape[1]):
                idx = (treatment[:, ci] == treat) & sel_device
                if idx.sum() == 0:
                    continue
                err = np.abs(a["y"][idx].mean(0) - a["mu_50"][idx].mean(0)).sum()
                l1 += K * err  # notebook accumulates once per channel loop
    return float(l1 / (len(unique_treat) * K * devices.shape[1]))


def synbio_heldout_l1(results_dir: str, tag: str) -> float:
    """Zero-shot heldout-device L1 from the 200-draw sample dump: negative
    predictions clipped to 0, mean over draws, per-(treatment, condition)
    summed |avg error| with the folds normalization
    (sbio_eval_heldout_final.ipynb cell 7)."""
    a = load_artifacts(results_dir, tag)
    mu_50 = np.load(os.path.join(results_dir, f"mu_50_{tag}_sample.npy"))
    mu_50 = np.clip(mu_50, 0.0, None)
    treatment, devices = a["treatments"], a["devices"]
    device_id = devices[0]
    sel_device = np.all(devices == device_id, axis=1)
    unique_treat = np.unique(treatment)
    K = a["y"].shape[1]
    l1 = 0.0
    for treat in unique_treat:
        for ci in range(treatment.shape[1]):
            idx = (treatment[:, ci] == treat) & sel_device & (treatment[:, ci] > 0)
            if idx.sum() == 0:
                continue
            mu_av = mu_50[idx].mean(0).mean(2)  # (K, T): mean over samples+draws
            y_av = a["y"][idx].mean(0)
            l1 += K * np.abs(y_av - mu_av).sum()
    return float(l1 / (len(unique_treat) * K * devices.shape[1]))


def synbio_heldout_l1_per_condition(
    results_dir: str, tag: str, base: Optional[float] = None
) -> float:
    """The heldout notebook's ALTERNATE aggregation (sbio_eval_heldout_final
    .ipynb cell 8 output: 11.747): identical error accumulation to cell 7 but
    normalized by the 2 input conditions (C6/C12) instead of the 4 output
    channels — exactly ``cell7 * K / 2``.

    ``base`` is an already-computed :func:`synbio_heldout_l1` value; passing
    it skips re-reading the large 200-draw sample dump. K is read from the
    observations header via mmap (no full load)."""
    K = np.load(
        os.path.join(results_dir, "observations.npy"), mmap_mode="r"
    ).shape[1]
    if base is None:
        base = synbio_heldout_l1(results_dir, tag)
    return base * K / 2.0


def cvs_ground_truth_l1(results_dir: str, tag: str, dataset_npz: str) -> float:
    """Class-averaged L1 of predictions vs the NOISE-FREE ground-truth test
    observations.

    The reference generator persists ``gt_test_data.pkl`` explicitly for
    exact-recovery checks but no script in the reference ever consumes it
    (SURVEY.md §4.3); this closes that loop. ``dataset_npz`` is our
    generator's ``cvs.npz`` (fields ``gt_test_obs`` + ``norm_*``); the
    ground truth is normalized with the dataset's own saved params — the
    same transform the dumped predictions live in.
    """
    from structured_latent_odes_tpu_torch.data.transforms import NormalizeToUnitSegment

    a = load_artifacts(results_dir, tag)
    z = np.load(dataset_npz)
    norm = NormalizeToUnitSegment({k[len("norm_"):]: z[k] for k in z.files if k.startswith("norm_")})
    gt = norm(z["gt_test_obs"])  # (N, T, K) -> normalized
    gt = np.swapaxes(gt, 1, 2)  # model layout (N, K, T)
    if gt.shape != a["mu_50"].shape:
        raise ValueError(f"gt shape {gt.shape} != predictions {a['mu_50'].shape}")
    # Row-alignment fingerprint: the dumped observations.npy must BE this
    # npz's normalized noisy test set (same rows, same order). Shapes alone
    # can't catch e.g. scoring a --reference-data-dir run against our own
    # generator's ground truth (both test sets are (100, 3, 86)).
    noisy = np.swapaxes(norm(z["test_obs"]), 1, 2)
    if not np.allclose(noisy, a["y"], atol=1e-5):
        raise ValueError(
            "observations.npy does not match the noisy test set in "
            f"{dataset_npz}: the run was trained on different data (e.g. the "
            "upstream reference pickles) — its rows do not align with this "
            "npz's ground truth, so the exact-recovery metric is undefined"
        )
    labels = np.stack([a["iext"].reshape(-1), a["rtpr"].reshape(-1)], axis=1)
    return _class_averaged_l1(a["mu_50"], gt, labels)

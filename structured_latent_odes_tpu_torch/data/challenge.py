"""Human viral challenge wearable dataset (35 subjects x 142 t x 4 channels:
HR, TEMP, EDA, ACC, with binary shedding and symptoms outcomes), copied from
the JAX package's ``data/challenge.py``: a 5-fold subject split by a seeded
permutation, with the normalization parameters taken from the train fold's
observations only.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from structured_latent_odes_tpu_torch.data.transforms import find_norm_params


def load_raw(data_path: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(data_path, "data.pkl"), "rb") as f:
        d = pickle.load(f)
    return {
        "observations": np.asarray(d["observations"], dtype=np.float32),  # (N, T, K)
        "shedding": np.asarray(d["shedding"], dtype=np.float32).reshape(-1, 1),
        "symptoms": np.asarray(d["symptoms"], dtype=np.float32).reshape(-1, 1),
        "n_time": int(d["n_time"]),
    }


def fold_indices(n: int, folds: int, split: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded permutation cut into ``folds`` chunks; fold ``split``
    (1-based) is validation, the rest train."""
    if not 1 <= split <= folds:
        raise ValueError(f"--split must be in [1, {folds}] (got {split})")
    rng = np.random.RandomState(seed)
    indices = rng.permutation(n)
    chunks = np.array_split(indices, folds)
    val_ids = np.sort(chunks[split - 1])
    train_ids = np.setdiff1d(np.arange(n, dtype=int), val_ids)
    return train_ids, val_ids


def build_datasets(config):
    """Returns (splits, norm_params, times). Splits: train/val dicts with
    (N, T, K) observations and (N, 1) labels; 'val' doubles as the test fold."""
    raw = load_raw(config.data_path)
    n = raw["observations"].shape[0]
    # --data-seed pins the fold while the training seed varies
    split_seed = config.get("data_seed")
    if split_seed is None:
        split_seed = config.seed
    train_ids, val_ids = fold_indices(n, config.folds, config.split, split_seed)

    def pack(ids):
        return {
            "observations": raw["observations"][ids],
            "shedding": raw["shedding"][ids],
            "symptoms": raw["symptoms"][ids],
        }

    splits = {"train": pack(train_ids), "val": pack(val_ids)}
    norm_params = find_norm_params(splits["train"]["observations"])
    times = np.arange(raw["n_time"], dtype=np.float32)
    return splits, norm_params, times

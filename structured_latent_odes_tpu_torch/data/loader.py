"""Host-side split helpers copied from the JAX package's ``data/loader.py``:
the model layout permutation, normalization and static-size padding with a
per-sample ``mask``. The minibatch iterators belong to the training slice."""

from __future__ import annotations

from typing import Dict

import numpy as np

Split = Dict[str, np.ndarray]


def to_model_layout(split: Split) -> Split:
    """(N, T, K) observations -> (N, K, T); labels pass through."""
    out = dict(split)
    out["observations"] = np.ascontiguousarray(np.swapaxes(split["observations"], -1, -2))
    return out


def normalize_split(split: Split, transforms) -> Split:
    out = dict(split)
    obs = split["observations"]
    for t in transforms.values():
        obs = t(obs)
    out["observations"] = obs
    return out


def pad_to(split: Split, size: int) -> Split:
    """Pad every array's leading dim to ``size`` and attach a 0/1 mask."""
    n = split["observations"].shape[0]
    if n > size:
        raise ValueError(f"split has {n} samples, more than the pad size {size}")
    out = {}
    for k, v in split.items():
        if k == "mask":
            continue
        pad = np.zeros((size - n,) + v.shape[1:], dtype=v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    out["mask"] = mask
    return out

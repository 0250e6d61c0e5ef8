"""Normalization transforms (numpy, host-side): a copy of the JAX package's
``data/transforms.py``. Data layout is ``(N, T, K)`` before the loader permutes
it to the model's ``(B, K, T)``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def find_norm_params(data: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-feature mean/std/min/max over all samples and timesteps."""
    axes = tuple(range(data.ndim - 1))
    return {
        "mean": data.mean(axis=axes),
        "std": data.std(axis=axes),
        "max": data.max(axis=axes),
        "min": data.min(axis=axes),
    }


class NormalizeZScore:
    def __init__(self, norm_params: Dict[str, np.ndarray]) -> None:
        self.mean = np.asarray(norm_params["mean"], dtype=np.float32)
        self.std = np.asarray(norm_params["std"], dtype=np.float32)

    def __call__(self, sample: np.ndarray) -> np.ndarray:
        std = np.where(self.std > 0, self.std, 1.0)
        return ((sample - self.mean) / std).astype(np.float32)

    def denormalize(self, batch: np.ndarray) -> np.ndarray:
        return batch * self.std + self.mean


class NormalizeToUnitSegment:
    """Min-max scale each feature to [0, 1]."""

    def __init__(self, norm_params: Dict[str, np.ndarray]) -> None:
        self.min_val = np.asarray(norm_params["min"], dtype=np.float32)
        self.max_val = np.asarray(norm_params["max"], dtype=np.float32)

    def __call__(self, sample: np.ndarray) -> np.ndarray:
        return ((sample - self.min_val) / (self.max_val - self.min_val)).astype(np.float32)

    def denormalize(self, batch: np.ndarray) -> np.ndarray:
        return batch * (self.max_val - self.min_val) + self.min_val


def create_transforms(norm: str | None, norm_params: Dict[str, np.ndarray]):
    if norm is None:
        return {}
    if norm == "zscore":
        return {"normalize": NormalizeZScore(norm_params)}
    if norm == "zero_to_one":
        return {"normalize": NormalizeToUnitSegment(norm_params)}
    raise ValueError("Choose valid normalization function: zscore or zero_to_one")

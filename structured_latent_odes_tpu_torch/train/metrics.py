"""Evaluation metrics, copied from the JAX package's ``train/metrics.py``
(reference ``compute_accuracy``/``compute_mse``)."""

from __future__ import annotations

import numpy as np


def accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    """Fraction of samples where prediction equals target exactly (rows)."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.ndim == 1:
        pred, target = pred[:, None], target[:, None]
    return float(np.mean(np.all(pred == target, axis=-1)))


def onehot_accuracy(pred_onehot: np.ndarray, target_onehot: np.ndarray) -> float:
    return accuracy(np.argmax(pred_onehot, -1), np.argmax(target_onehot, -1))


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))

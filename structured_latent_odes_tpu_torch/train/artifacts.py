"""Test-time ``.npy`` artifact contract, copied from the JAX package's
``train/artifacts.py``: the same file names and array layouts, so the JAX
package's eval CLI (``python -m structured_latent_odes_tpu.eval``) and the
reference's notebooks read the port's results unchanged."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def results_dir(model_name: str, root: str = ".") -> str:
    d = os.path.join(root, f"results_{model_name}")
    os.makedirs(d, exist_ok=True)
    return d


def dump_common(out_dir: str, observations, times, labels: Dict[str, np.ndarray]) -> None:
    np.save(os.path.join(out_dir, "observations"), np.asarray(observations))
    np.save(os.path.join(out_dir, "times"), np.asarray(times))
    for name, arr in labels.items():
        np.save(os.path.join(out_dir, name), np.asarray(arr))


def dump_recon(out_dir: str, tag: str, results: Dict[str, np.ndarray]) -> None:
    """tag is 'post' or 'prior'."""
    for key in ("mu_50", "mu_75", "mu_25"):
        np.save(os.path.join(out_dir, f"{key}_{tag}"), np.asarray(results[key]))
    np.save(os.path.join(out_dir, f"solution_xt_{tag}"), np.asarray(results["solution_xt"]))
    np.save(os.path.join(out_dir, f"z_{tag}"), np.asarray(results["z"]))


def dump_sample_bands(out_dir: str, tag: str, mu_25, mu_50, mu_75) -> None:
    """The proc/challenge 200-draw sample dump: arrays stacked on a trailing
    sample axis, file names ``mu_{25,50,75}_{post,prior}_sample.npy``."""
    np.save(os.path.join(out_dir, f"mu_25_{tag}_sample"), np.asarray(mu_25))
    np.save(os.path.join(out_dir, f"mu_50_{tag}_sample"), np.asarray(mu_50))
    np.save(os.path.join(out_dir, f"mu_75_{tag}_sample"), np.asarray(mu_75))

"""Seeding (the JAX package's ``utils/rng.py``). The JAX package returns a
key and threads it by splitting (``KeyChain``); the port threads integer seeds
instead (``prob/distributions.py::fold_seed``), so it has no ``KeyChain``."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> int:
    """Seed numpy, ``random`` and torch (the host-side data pipeline and
    parameter init) and return ``seed``, which keys the model's draws."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)

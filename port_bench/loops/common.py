"""What the generators share: the configuration's data from the seed, the
program's config and spec, and moving the program's state out of the way
before the reference runs."""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench import harness


def splits(run, device) -> Tuple[Dict[str, Dict[str, np.ndarray]], np.ndarray]:
    """The configuration's splits as host arrays in the model layout, and
    the time grid, from its data source: ``port_bench/data/<dataset>.py``,
    by the configuration's ``dataset`` key, whose ``splits(run, device)``
    makes or reads them from the run's seed."""
    path = os.path.join(harness.BENCH_DIR, "data", f"{run.cfg['dataset']}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"configuration {run.cfg['name']!r}: no data source {path}")
    return harness.load_module(path, f"port_bench_data_{run.cfg['dataset']}").splits(run, device)


class WarmUp:
    """Decides when the window may open: the window's own loop runs, and
    :meth:`settled` is told at the end of each of its units (an epoch, a
    chunk) how many epochs it completed. The rate is taken over blocks of at
    least ``mix["warm_block_s"]`` seconds; it has settled once two blocks in
    a row agree to within ``mix["warm_agree"]`` (a share), or at the first
    block end past ``mix["warm_max_s"]`` seconds: the host's caches, the
    allocator and the driver's first epochs are behind the window."""

    def __init__(self, mix: Dict):
        self.block_s, self.agree, self.max_s = (float(mix[k]) for k in ("warm_block_s", "warm_agree", "warm_max_s"))
        self.start = self.block_start = time.perf_counter()
        self.units = 0
        self.rates: List[float] = []

    def settled(self, units: int) -> bool:
        now = time.perf_counter()
        self.units += units
        if now - self.block_start < self.block_s:
            return False
        self.rates.append(self.units / (now - self.block_start))
        self.units, self.block_start = 0, now
        r = self.rates
        return (len(r) >= 2 and abs(r[-1] - r[-2]) <= self.agree * r[-2]) or now - self.start >= self.max_s


def port_config(cfg: Dict):
    """The program's config: its dataset's defaults with every key of the
    configuration file's ``config`` section."""
    from structured_latent_odes_tpu_torch.data.configs import LOADERS

    config = LOADERS[cfg["dataset"]]()
    for k, v in cfg["config"].items():
        config[k] = v
    return config


def port_spec(cfg: Dict, config, n_time: int):
    from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, proc_spec

    return {"cvs": cvs_spec, "proc": proc_spec, "challenge": challenge_spec}[cfg["dataset"]](config, n_time)


def peak_and_free(device) -> int:
    """The peak device memory of the run so far (0 off the card); then the
    program's tensors, which the caller has dropped, and its graphs' pools
    are released before the reference runs."""
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    from structured_latent_odes_tpu_torch.utils.memo import clear_all

    clear_all()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return peak


def ode_shapes(cfg: Dict, n_time: int, batch: int, members: int = 1) -> Dict[str, int]:
    """The ODE kernels' shapes at a call over ``batch`` trajectories of each
    of ``members`` models."""
    from port_bench.reference.model import TABLEAUS

    c = cfg["config"]
    return {"B": batch * members, "T": n_time, "S": len(TABLEAUS[c["solver"]][0]), "H": int(c["ode_hidden_dim"]),
            "D": int(c["ode_state_dim"]), "members": members}

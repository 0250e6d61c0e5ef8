"""Profiling (the JAX package's ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes a Chrome-trace JSON into a directory: CPU activity always, and CUDA
  activity (the kernels' device events) when a card is present;
- :class:`StepTimer`: wall-clock step times that end in a synchronize of
  the step's output, with percentile statistics after a warm-up.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch

from structured_latent_odes_tpu_torch.utils.tree import tree_leaves


class Trace:
    """What :func:`trace` yields; ``path`` is the trace file once the block
    has ended."""

    path: str = ""


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/trace') as t: step(...)``, then
    ``t.path`` is the Chrome-trace JSON written into ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Trace()
    with torch.profiler.profile(activities=activities) as prof:
        yield out
    out.path = os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out.path)


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tree of them)."""
    devices = {x.device for x in tree_leaves(out) if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates synced step wall-clock times.

    Usage::

        timer = StepTimer(warmup=2)
        for batch in batches:
            with timer:
                out = step(state, batch)
            timer.sync(out)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 2) -> None:
        self.warmup = warmup
        self._times: List[float] = []
        self._t0 = 0.0
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, out) -> None:
        _sync(out)
        self._n += 1
        if self._n > self.warmup:
            self._times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "steps_per_sec": float(1.0 / t.mean()),
        }

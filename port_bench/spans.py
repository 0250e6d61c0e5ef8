"""The program's spans (``structured_latent_odes_tpu_torch/utils/profiling.py``:
each phase's self time on the host clock, recorded inside the program), as
the per-layer metrics read them: summed over the spans of a layer that ended
inside an interval of the run. ``run.t0`` and ``run.ticks`` are
``time.perf_counter`` readings, the spans' clock in seconds.

A program that records no spans (a commit before them) gives nothing, and so
does a ring that has dropped spans of the interval."""

from __future__ import annotations

from typing import Optional, Tuple


def self_ms(start_s: float, end_s: float, prefixes: Tuple[str, ...]) -> Optional[float]:
    """The summed self time, in ms, of the spans whose names start with one
    of ``prefixes`` and that ended in [``start_s``, ``end_s``]; None where
    the program recorded no span there."""
    try:
        from structured_latent_odes_tpu_torch.utils.profiling import SPANS, self_ns_by_name
    except ImportError:
        return None
    start, end = int(start_s * 1e9), int(end_s * 1e9)
    if len(SPANS) == SPANS.maxlen and SPANS[0][2] >= start:
        return None  # the ring no longer holds the interval's first spans
    by_name = self_ns_by_name(start, end)
    if not by_name:
        return None
    return sum(ns for name, (ns, _) in by_name.items() if name.startswith(prefixes)) / 1e6


def window_ms_per_epoch(run, prefixes: Tuple[str, ...]) -> Optional[float]:
    """:func:`self_ms` over the window (its first to its last tick), per
    epoch of the window."""
    epochs = run.work.get("epochs")
    if len(run.ticks) < 2 or not epochs:
        return None
    ms = self_ms(run.ticks[0], run.ticks[-1], prefixes)
    return None if ms is None else ms / epochs

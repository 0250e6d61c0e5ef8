"""The profiler's reader, frozen for the benchmark: a copy of
``chip_smoke.py:1994-2063`` (``LAUNCH_CALLS`` and ``_trace_epochs``: the
device's busy time as the *union* of its records' intervals, not their sum,
which counts overlapping records twice; the host's launching calls), made
into a summary that the per-layer readers share, with the top device
operations and the idle gaps named by what the host was doing.

The trace stays in memory: nothing is written.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

# the host's calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")


class Traced:
    """What a traced segment left: set by :func:`profiled` when it ends."""

    summary: Dict = None


@contextlib.contextmanager
def profiled(device):
    """torch.profiler over the block (CPU and CUDA records), ended by a
    synchronize; yields a :class:`Traced` whose ``summary`` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Traced()
    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        yield out
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out.summary = summarize(prof.events(), wall)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted intervals merged where they overlap."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events, wall_s: float) -> Dict:
    """The segment's numbers, times in seconds:

    - ``window_s``: its wall time on the host clock; ``busy_s``: the union of
      the device records' intervals;
    - ``kernels``: by device record name, [count, summed seconds];
    - ``host_calls``: the host's launching calls (:data:`LAUNCH_CALLS`);
    - ``device_ops``: the ten device operations that took most time;
    - ``idle_gaps``: the device's idle time inside the segment by the host
      operation running where each gap starts (the innermost one), the ten
      largest.
    """
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = union(spans)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    host_calls = sum(1 for e in host if e.name in LAUNCH_CALLS)
    gaps: Dict[str, float] = defaultdict(float)
    if busy:
        starts = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host), key=lambda x: x[0])
        keys = [s[0] for s in starts]
        for (_, b0), (a1, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(keys, b0)
            name = "python (no operation)"
            for s, e, n in reversed(starts[max(0, i - 200):i]):
                if e > b0:
                    name = n
                    break
            gaps[name] += (a1 - b0) / 1e6
    top = sorted(((n, k[1]) for n, k in kernels.items()), key=lambda x: -x[1])[:10]
    return {
        "window_s": wall_s,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {n: list(k) for n, k in kernels.items()},
        "host_calls": host_calls,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:10]],
    }

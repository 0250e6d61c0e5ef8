"""Profiling (the JAX package's ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes a Chrome-trace JSON into a directory: CPU activity always, and CUDA
  activity (the kernels' device events) when a card is present;
- :class:`span`: a phase of the program on the host clock
  (``time.perf_counter_ns``), nested as the program nests them, kept in a
  bounded ring in memory (:data:`SPANS`) and summed by name by
  :func:`self_ns_by_name`. While a profiler runs, a span is also a range
  in its trace, on its clock (``trace`` above, the CLIs' ``--profile-dir``,
  the benchmark's traced stretch), nested as the program nests them.

Spans are named ``<layer>.<phase>``: ``entry.*`` the training driver's and
the sweep's own work, ``dispatch.*`` an epoch's steps or evaluation as the
host puts them on the device, ``graph.*`` a CUDA graph's eager first call,
capture and replay (``utils/graphs.py``), ``wait.*`` the host waiting for
the device's results.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Tuple

import torch
import torch._C._profiler as _profiler_c
import torch.autograd.profiler as _autograd_profiler

# each closed span as (name, start_ns, end_ns, parent's name or None,
# self_ns), the newest 2**16; nothing is written to disk
SPANS: collections.deque = collections.deque(maxlen=1 << 16)


class _Open(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans, innermost last


_open = _Open()
_clock = time.perf_counter_ns


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


class span:
    """``with span('entry.epoch'): ...`` records the block's start and end
    (``time.perf_counter_ns``), its parent (the innermost span open in this
    thread when it began) and its self time: its duration less what the
    spans directly inside it took. Recording is always on and costs two
    clock reads and an append. Only while a profiler runs is the span also
    a profiler range: a function-scope ``RecordFunction``, a ``cpu_op`` in
    the trace. (``torch.profiler.record_function`` is user-scope, which a
    CUDA trace mirrors as a range on the device's timeline over the kernels
    launched inside it: device time that hides the card's idle gaps. It
    also costs some 10 us a call even with no profiler running.)"""

    __slots__ = ("name", "start", "inner", "stack", "parent", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.stack = stack = _open.stack
        self.parent = stack[-1] if stack else None
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _profiler_c._RecordFunctionFast(self.name)
            self.range.__enter__()
        stack.append(self)
        self.inner = 0
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        self.stack.pop()
        took, parent = end - self.start, self.parent
        if parent is not None:
            parent.inner += took
        SPANS.append((self.name, self.start, end, None if parent is None else parent.name, took - self.inner))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def self_ns_by_name(end_from_ns: int, end_to_ns: int) -> Dict[str, Tuple[int, int]]:
    """By span name, (summed self time in ns, count) of the spans in
    :data:`SPANS` that ended in ``[end_from_ns, end_to_ns]``."""
    out: Dict[str, list] = {}
    for name, _, end, _, own in list(SPANS):
        if end_from_ns <= end <= end_to_ns:
            acc = out.setdefault(name, [0, 0])
            acc[0] += own
            acc[1] += 1
    return {name: (ns, n) for name, (ns, n) in out.items()}

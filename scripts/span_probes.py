#!/usr/bin/env python3
"""Probes behind the port's spans (``utils/profiling.py::span``).

    python3 scripts/span_probes.py cost
    python3 scripts/span_probes.py annotation
    python3 scripts/span_probes.py replays --workload cvs_train --seed N --seconds 10

- ``cost``: a span's host cost with no profiler running (flat and nested)
  and under torch.profiler (CUDA activity too where there is a card),
  beside ``time.perf_counter_ns`` and ``torch.profiler.record_function``.
- ``annotation``: the device busy time that ``port_bench/trace.py`` reads of
  one stretch of kernels with host gaps between them: bare, inside
  ``record_function`` ranges, inside spans. A CUDA trace mirrors a
  user-scope range on the device's timeline over the kernels launched in
  it, which the busy union counts; a span's function-scope range it does
  not mirror. Needs a card.
- ``replays``: one run of a benchmark cell as ``port_bench/run.py`` runs it,
  with a CUDA event pair around every graph replay (the device's time from a
  replay's first operation to its last, the gaps between its kernels
  included); after the result line, the window's replay device time and
  spans' self time per epoch. Needs a card.

Each prints one JSON line. Imports nothing of JAX.
"""

import time

T0 = time.perf_counter()  # the process's start, for the benchmark's setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

# as port_bench/run.py: one process with few threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from structured_latent_odes_tpu_torch.utils.profiling import SPANS, span  # noqa: E402


def _per_call_ns(fn, n: int, reps: int = 5) -> float:
    out = []
    for _ in range(reps):
        t = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t) / n)
    return statistics.median(out)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    return acts + [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else acts


def cost() -> dict:
    def flat(n):
        for _ in range(n):
            with span("probe.flat"):
                pass

    def nested(n):
        for _ in range(n // 2):
            with span("probe.outer"):
                with span("probe.inner"):
                    pass

    def clock(n):
        c = time.perf_counter_ns
        for _ in range(n):
            c()

    def record(n):
        for _ in range(n):
            with torch.profiler.record_function("probe.record"):
                pass

    out = {"perf_counter_ns_ns": _per_call_ns(clock, 200_000), "span_off_ns": _per_call_ns(flat, 200_000),
           "span_off_nested_ns": _per_call_ns(nested, 200_000),
           "record_function_off_ns": _per_call_ns(record, 20_000)}
    with torch.profiler.profile(activities=_activities()):
        out["span_on_ns"] = _per_call_ns(flat, 20_000, reps=3)
    return out


class _Bare:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def annotation() -> dict:
    from port_bench.trace import profiled

    device = torch.device("cuda")
    x = torch.randn(1 << 20, device=device)

    def stretch(rng):
        for _ in range(20):
            with rng("probe.range"):
                for _ in range(2):
                    for _ in range(5):
                        x.mul_(1.0001)
                    torch.cuda.synchronize()
                    time.sleep(0.002)  # the card idles 2 ms between the range's kernels

    out = {}
    for kind, rng in (("bare", _Bare), ("record_function", torch.profiler.record_function), ("span", span)):
        stretch(rng)
        with profiled(device) as traced:
            stretch(rng)
        out[kind] = {"busy_s": traced.summary["busy_s"], "window_s": traced.summary["window_s"],
                     "device_records_named_probe": sorted(n for n in traced.summary["kernels"] if "probe" in n)}
    return out


def replays(argv) -> dict:
    from port_bench import harness
    from structured_latent_odes_tpu_torch.utils import graphs

    pairs = []  # (host time, start event, end event)
    graph_call = graphs.Graph.__call__

    def timed_call(self):
        if self.plain or self.graph is None:
            return graph_call(self)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = graph_call(self)
        b.record()
        pairs.append((time.perf_counter(), a, b))
        return out

    finish, out = harness.finish, {}

    def probed_finish(run, bench):
        rc = finish(run, bench)
        torch.cuda.synchronize()
        a, b, e = run.ticks[0], run.ticks[-1], run.work["epochs"]
        ms = [x.elapsed_time(y) for t, x, y in pairs if a <= t <= b]
        by = {}
        for name, _, end, _, own in SPANS:
            if a * 1e9 <= end <= b * 1e9:
                by[name] = by.get(name, 0.0) + own / 1e6 / e
        out.update(cell=run.cell, seed=run.seed, epochs=e, window_ms_per_epoch=1e3 * (b - a) / e,
                   replays_per_epoch=len(ms) / e, replay_device_ms_per_epoch=sum(ms) / e,
                   replay_device_ms_median=float(np.median(ms)) if ms else None,
                   span_self_ms_per_epoch=dict(sorted(by.items())))
        return rc

    graphs.Graph.__call__ = timed_call
    harness.finish = probed_finish
    os.chdir(ROOT)
    rc = harness.main(argv, T0)
    if rc:
        raise SystemExit(rc)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("probe", choices=("cost", "annotation", "replays"))
    args, rest = p.parse_known_args()
    out = {"cost": lambda: cost(), "annotation": lambda: annotation(), "replays": lambda: replays(rest)}[args.probe]()
    out["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""The readers of the program's spans (``port_bench/spans.py`` and the four
metrics that use it): on a run with ticks and spans made up to the
nanosecond, a span that straddles the window's open counted by its end; no
number where the program recorded no span, where its ring dropped the
interval's first spans, or where the program has no spans at all (a commit
before them); and each committed cell's tiny traced run prints all four."""

import collections

import pytest
import torch

from port_bench import harness
from port_bench.tests._tiny import result_line, tiny_run
from structured_latent_odes_tpu_torch.utils import profiling

READERS = ["entry_ms_per_epoch.train", "dispatch_ms_per_epoch.train", "wait_ms_per_epoch.train",
           "graph_build_s.train"]
MS = 1_000_000  # ns


def _run(ticks, epochs=2):
    run = harness.Run(cell="x", cfg={}, traffic={}, seed=1, seconds=1, trace=True, t0=100.0,
                      device=torch.device("cpu"))
    run.ticks, run.work = list(ticks), {"epochs": epochs}
    return run


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=profiling.SPANS.maxlen)
    monkeypatch.setattr(profiling, "SPANS", ring)
    return ring


def _at(s: float) -> int:
    return int(s * 1e9)


def _read(name, run):
    return harness.reader(name).read(run)


def test_readers_sum_self_time_by_layer_over_the_window(ring):
    # set-up: two graph builds and a replay; the window opens at 101 s and
    # closes at 103 s after two epochs
    ring.extend([
        ("graph.warm", _at(100.1), _at(100.1) + 40 * MS, None, 40 * MS),
        ("graph.capture", _at(100.2), _at(100.2) + 7 * MS, None, 7 * MS),
        ("graph.replay", _at(100.3), _at(100.3) + 1 * MS, None, 1 * MS),
        ("entry.batches", _at(100.95), _at(100.96), "entry.epoch", 10 * MS),
        # the warm-up's last epoch: it straddles the window's open and counts whole, by its end
        ("entry.log", _at(100.999), _at(101.001), "entry.epoch", 2 * MS),
        ("entry.epoch", _at(100.9), _at(101.002), None, 3 * MS),
        ("entry.batches", _at(101.1), _at(101.1) + 5 * MS, "entry.epoch", 5 * MS),
        ("graph.replay", _at(101.2), _at(101.2) + 4 * MS, "dispatch.train", 4 * MS),
        ("dispatch.train", _at(101.2), _at(101.2) + 6 * MS, "entry.epoch", 2 * MS),
        ("wait.losses", _at(101.3), _at(101.3) + 30 * MS, "entry.epoch", 30 * MS),
        ("dispatch.eval", _at(102.2), _at(102.2) + 3 * MS, "entry.epoch", 3 * MS),
        ("wait.eval", _at(102.3), _at(102.3) + 8 * MS, "entry.epoch", 8 * MS),
        # the window's last epoch ends after its tick, so it is left out
        ("entry.log", _at(102.999), _at(103.01), "entry.epoch", 9 * MS),
        ("graph.capture", _at(103.5), _at(103.5) + 50 * MS, None, 50 * MS),
    ])
    run = _run([101.0, 102.0, 103.0])
    assert _read("entry_ms_per_epoch.train", run) == pytest.approx((2 + 3 + 5) / 2)
    assert _read("dispatch_ms_per_epoch.train", run) == pytest.approx((4 + 2 + 3) / 2)
    assert _read("wait_ms_per_epoch.train", run) == pytest.approx((30 + 8) / 2)
    assert _read("graph_build_s.train", run) == pytest.approx((40 + 7) / 1e3)


def test_no_graph_build_reads_zero(ring):
    ring.append(("entry.epoch", _at(100.5), _at(100.6), None, 100 * MS))
    assert _read("graph_build_s.train", _run([101.0, 102.0])) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_no_spans_no_number(ring, name):
    assert _read(name, _run([101.0, 102.0, 103.0])) is None
    assert _read(name, _run([])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_ring_that_dropped_the_interval_gives_no_number(monkeypatch, name):
    ring = collections.deque([("entry.epoch", _at(100.5 + i * 1e-6), _at(100.5 + i * 1e-6) + 10, None, 10)
                              for i in range(4)], maxlen=4)
    monkeypatch.setattr(profiling, "SPANS", ring)
    assert _read(name, _run([100.4, 101.0])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_gives_no_number(monkeypatch, name):
    """As on a commit before the spans: the program's profiling module has
    neither the ring nor the query."""
    monkeypatch.delattr(profiling, "self_ns_by_name")
    monkeypatch.delattr(profiling, "SPANS")
    assert _read(name, _run([101.0, 102.0, 103.0])) is None


CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_run_prints_the_span_metrics(cell, capsys):
    run = tiny_run(cell, trace=True)
    assert harness.execute(run, harness.benchmark()) == 0
    metrics = result_line(capsys)["metrics"]
    assert set(READERS) <= set(metrics)
    per_epoch = sum(metrics[n]["value"] for n in READERS[:3])
    window_ms = 1e3 * (run.ticks[-1] - run.ticks[0]) / run.work["epochs"]
    # on the CPU the program runs eagerly: no graph is built
    assert metrics["graph_build_s.train"]["value"] == 0.0
    assert all(metrics[n]["value"] > 0 for n in READERS[:3])
    # the spans cover the window's epochs: the driver's or the sweep's loop
    # is all inside them, what the benchmark does between chunks is not
    assert 0.8 * window_ms < per_epoch <= 1.05 * window_ms

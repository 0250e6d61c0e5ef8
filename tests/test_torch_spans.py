"""The port's spans (``utils/profiling.py::span``) on the CPU: nesting,
parents and self time; the ring's bound; the interval query; no
``record_function`` while no profiler runs, and the spans nested in the
profiler's events while one does; the span tree of one epoch of the CVS
driver and of one epoch of a two-member sweep runner; a graph's plain
version records no ``graph.*`` span."""

import collections
import contextlib
import io
import json
import os
import time

import pytest
import torch

from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.utils import profiling
from structured_latent_odes_tpu_torch.utils.graphs import Graph
from structured_latent_odes_tpu_torch.utils.profiling import SPANS, self_ns_by_name, span
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_ensemble import _config, _ensemble, _splits


def _recorded(fn):
    """The spans that ``fn()`` closed, oldest first."""
    t0 = time.perf_counter_ns()
    fn()
    return [s for s in SPANS if s[2] >= t0]


def _names(spans):
    return collections.Counter(s[0] for s in spans)


def _within(spans, outer):
    """The spans that ended inside ``outer``'s interval (itself included)."""
    return [s for s in spans if outer[1] <= s[2] <= outer[2]]


def test_nesting_parents_and_self_time():
    def nest():
        with span("a.outer"):
            time.sleep(0.002)
            with span("b.first"):
                time.sleep(0.003)
                with span("c.inner"):
                    time.sleep(0.002)
            with span("b.second"):
                time.sleep(0.001)

    got = {s[0]: s for s in _recorded(nest)}
    assert [got[n][3] for n in ("a.outer", "b.first", "c.inner", "b.second")] == [None, "a.outer", "b.first",
                                                                                      "a.outer"]
    for name, (_, start, end, _, own) in got.items():
        assert start <= end and 0 <= own <= end - start, name
    took = {n: s[2] - s[1] for n, s in got.items()}
    assert got["c.inner"][4] == took["c.inner"]
    assert got["b.first"][4] == took["b.first"] - took["c.inner"]
    assert got["a.outer"][4] == took["a.outer"] - took["b.first"] - took["b.second"]
    assert got["a.outer"][4] >= 2_000_000 and got["b.first"][4] >= 3_000_000
    # the self times of a tree add up to its root's duration
    assert sum(s[4] for s in got.values()) == took["a.outer"]


def test_a_span_closes_on_an_exception_and_the_stack_unwinds():
    def raising():
        with pytest.raises(KeyError):
            with span("a.outer"):
                with span("a.inner"):
                    raise KeyError("x")
        with span("a.after"):
            pass

    got = {s[0]: s for s in _recorded(raising)}
    assert got["a.inner"][3] == "a.outer" and got["a.after"][3] is None
    assert profiling._open.stack == []


def test_the_ring_is_bounded():
    assert SPANS.maxlen == 2 ** 16
    t0 = time.perf_counter_ns()
    for _ in range(SPANS.maxlen + 10):
        with span("a.many"):
            pass
    assert len(SPANS) == SPANS.maxlen and all(s[0] == "a.many" and s[2] >= t0 for s in SPANS)


def test_the_interval_query_counts_spans_by_their_end():
    with span("q.before"):
        pass
    t0 = time.perf_counter_ns()
    with span("q.straddles"):  # starts before the interval, ends inside it
        with span("q.child"):
            pass
        t1 = time.perf_counter_ns()
        for _ in range(3):
            with span("q.child"):
                time.sleep(0.001)
    t2 = time.perf_counter_ns()
    with span("q.after"):
        pass
    got = self_ns_by_name(t1, t2)
    assert sorted(got) == ["q.child", "q.straddles"] and got["q.child"][1] == 3 and got["q.straddles"][1] == 1
    assert got["q.child"][0] >= 3_000_000
    everything = self_ns_by_name(t0, time.perf_counter_ns())
    assert {n: c for n, (_, c) in everything.items()} == {"q.child": 4, "q.straddles": 1, "q.after": 1}
    assert self_ns_by_name(t2, t1) == {}


def test_no_record_function_while_no_profiler_runs(monkeypatch):
    """No profiler range of either kind is opened while no profiler runs;
    while one runs, a span is one function-scope range (a ``cpu_op``, which
    a CUDA trace does not mirror on the device's timeline)."""
    calls = []

    def counted(kind, real):
        def make(name, *args):
            calls.append((kind, name))
            return real(name, *args)
        return make

    for module in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(module, "record_function", counted("user", module.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted("function", torch._C._profiler._RecordFunctionFast))
    with span("a.off"):
        with span("a.off_inner"):
            pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("a.on"):
            pass
    assert calls == [("function", "a.on")]


def test_spans_nest_in_the_profilers_events(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("p.outer"):
            with span("p.inner"):
                torch.ones(8).sum()
            with span("p.second"):
                pass
    events = {e.name: e for e in prof.events() if e.name.startswith("p.")}
    assert sorted(events) == ["p.inner", "p.outer", "p.second"]
    assert events["p.inner"].cpu_parent.name == "p.outer" and events["p.second"].cpu_parent.name == "p.outer"
    outer = events["p.outer"].time_range
    assert all(outer.start <= e.time_range.start <= e.time_range.end <= outer.end for e in events.values())
    # host operations, not user annotations (which a CUDA trace mirrors on the device's timeline)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"] if e.get("name", "").startswith("p.")}
    assert cats == {"cpu_op"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=20, seed=0, device="cpu")
    return d


def test_one_cvs_driver_epoch_is_one_span_tree(data_dir, tmp_path):
    """One epoch of ``training_cvs.main`` with the train split's statistics:
    one ``entry.epoch``, each of its phases once under it, four eval epochs
    and one wait, the epoch's one read; nothing of the epoch outside the
    tree."""
    argv = ["--data-path", data_dir, "--results-root", str(tmp_path), "--mini-batch-size", "8", "--no-plot",
            "--device", "cpu", "--num-epochs", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        spans = _recorded(lambda: training_cvs.main(argv))
    (epoch,) = [s for s in spans if s[0] == "entry.epoch"]
    assert epoch[3] is None
    tree = _within(spans, epoch)
    assert _names(tree) == {"entry.epoch": 1, "entry.batches": 1, "entry.put": 1, "dispatch.train": 1,
                            "dispatch.eval": 4, "wait.epoch": 1, "entry.select": 1, "entry.log": 1}
    assert all(s[3] == "entry.epoch" for s in tree if s is not epoch)
    assert sum(s[4] for s in tree) == epoch[2] - epoch[1]


def test_one_sweep_epoch_is_one_span_tree():
    """One epoch of a two-member runner, on the graph path's plain version
    and eagerly: the chunk, its epoch and the epoch's phases, the val ELBO
    included; the plain graphs record no ``graph.*`` span."""
    for dispatch in ("plain", "eager"):
        spans = _recorded(lambda: _ensemble(_config(0), _splits(), [3, 4], "cvs", dispatch=dispatch))
        (chunk,) = [s for s in spans if s[0] == "entry.chunk"]
        tree = _within(spans, chunk)
        assert _names(tree) == {"entry.chunk": 1, "entry.epoch": 1, "entry.batches": 1, "dispatch.train": 1,
                                "entry.seeds": 1, "wait.seeds": 1, "dispatch.eval": 1, "wait.epoch": 1,
                                "entry.select": 1}, dispatch
        parents = {s[0]: s[3] for s in tree}
        assert parents["entry.chunk"] is None and parents["entry.epoch"] == "entry.chunk"
        assert {parents[n] for n in parents if n not in ("entry.chunk", "entry.epoch")} == {"entry.epoch"}


def test_a_plain_graph_records_no_graph_span():
    """``Graph(plain=True)`` captures nothing and records no ``graph.*``
    span; the ``plain`` stepped epoch around it records ``dispatch.train``."""
    buf = torch.zeros(3)

    def body():
        buf.add_(1.0)
        return {"sum": buf.sum()}

    plain = Graph(body, "cpu", plain=True)
    assert _names(_recorded(lambda: [plain() for _ in range(3)])) == {}
    config = _config(0)
    spec = cvs_spec(config, n_time=16)
    ts = torch.arange(16.0)
    params = init_params(spec, 0, device="cpu")
    init_state, _, train_epoch = svi.make_train_step(spec, ts, config.learning_rate, params, dispatch="plain")
    batches = {k: torch.as_tensor(v[:8]).reshape((2, 4) + v.shape[1:]) for k, v in _splits()["train"].items()}
    batches["mask"] = torch.ones(2, 4)
    batches["sample_id"] = torch.arange(8).reshape(2, 4)
    spans = _recorded(lambda: train_epoch(init_state(params, 1), batches))
    assert _names(spans) == {"dispatch.train": 1}

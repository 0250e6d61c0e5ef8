"""The harness finds every cell, mix, configuration, metric and limit by
name: one of each added as new files runs with no edit to a file that is
there. Each committed cell runs at a tiny size on the CPU, and its result
line has the contract's keys. A run without the card it asks for, or in a
directory that holds only the benchmark, prints no result."""

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench.tests._tiny import result_line, tiny_run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_at_a_tiny_size(cell, capsys):
    run = tiny_run(cell)
    assert harness.execute(run, harness.benchmark()) == 0
    line = result_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(harness.benchmark(), cell, "end_to_end")}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics(cell, capsys):
    run = tiny_run(cell, trace=True)
    assert harness.execute(run, harness.benchmark()) == 0
    line = result_line(capsys)
    names = {m["name"] for m in harness.metrics_for(harness.benchmark(), cell, "per_layer")}
    # on the CPU the profiler sees no device: only the host's numbers are there
    assert line["metrics"] and set(line["metrics"]) <= names
    assert "setup_s" not in line["metrics"] and "breakdown" in line


def test_the_checks_are_the_last_lines_of_stderr(capsys):
    run = tiny_run("cvs_train")
    harness.execute(run, harness.benchmark())
    captured = capsys.readouterr()
    tail = captured.err.strip().splitlines()[-len(run.checks):]
    assert [t.split()[1] for t in tail] == list(run.checks) and all(" limit " in t for t in tail)


@pytest.mark.parametrize("name", sorted(f[:-3] for f in os.listdir(os.path.join(harness.BENCH_DIR, "metrics"))
                                        if f.endswith(".py")))
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    run = harness.Run(cell="x", cfg={}, traffic={}, seed=1, seconds=1, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    assert harness.reader(name).read(run) is None


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7, 2 ** 32 + 1, 2 ** 40])
def test_seeds_past_32_bits(seed):
    run = harness.Run(cell="x", cfg={}, traffic={}, seed=seed, seconds=1, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    a, b = run.seed_for("weights"), run.seed_for("data")
    assert 0 <= a < 2 ** 63 and a != b and a == run.seed_for("weights")


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert harness.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"], time.perf_counter()) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs 1 CUDA card" in captured.err


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the benchmark's data files with one configuration, one
    traffic mix, one per-layer metric, one limits file and one cell added as
    new files (and as new entries of BENCHMARK.json); nothing that is there
    is edited."""
    bench = copy.deepcopy(harness.benchmark())
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub), tmp_path / "port_bench" / sub)
    cfg = json.load(open(os.path.join(harness.BENCH_DIR, "configs", "cvs.json")))
    cfg.update(name="cvs_seq")
    cfg["config"]["ode_backend"] = "semilinear_seq"
    (tmp_path / "port_bench" / "configs" / "cvs_seq.json").write_text(json.dumps(cfg))
    (tmp_path / "port_bench" / "traffic" / "train_val_only.json").write_text(json.dumps(
        {"loop": "train", "selection": "cvs", "eval_every": 1, "eval_train_stats": False, "followed_steps": 3,
         "trace_epochs": 1, "warm_block_s": 1.0, "warm_agree": 0.03, "warm_max_s": 6.0}))
    (tmp_path / "port_bench" / "metrics" / "epochs_traced.train.py").write_text(
        "def read(run):\n    return run.traced_work.get('epochs')\n")
    shutil.copy(os.path.join(harness.BENCH_DIR, "limits", "cvs_train.json"),
                tmp_path / "port_bench" / "limits" / "cvs_seq_train.json")
    bench["configs"].append({"name": "cvs_seq", "source": "https://github.com/paidamoyo/structured_latent_ODEs",
                             "file": "port_bench/configs/cvs_seq.json", "reduced": ["num_epochs"], "why": "test"})
    bench["workloads"].append({"name": "cvs_seq_train", "config": "cvs_seq", "traffic": "train_val_only",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "epochs_traced.train", "unit": "epochs", "better": "higher",
                               "source": "program_counter", "layer": "epoch dispatch",
                               "moves": "train_samples_per_s", "workloads": ["cvs_seq_train"]})
    bench["end_to_end"][0]["workloads"].append("cvs_seq_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "BENCH_DIR", str(tmp_path / "port_bench"))
    return harness.benchmark()


def test_a_cell_added_as_new_files_runs(added, capsys):
    assert harness.execute(tiny_run("cvs_seq_train", bench=added), added) == 0
    line = result_line(capsys)
    assert line["correct"] is True and set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert harness.execute(tiny_run("cvs_seq_train", bench=added, trace=True), added) == 0
    assert result_line(capsys)["metrics"]["epochs_traced.train"]["value"] == 1

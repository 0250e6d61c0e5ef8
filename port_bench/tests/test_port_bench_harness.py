"""The harness finds every cell, mix, configuration, data source, metric
and limit by name: one of each added as new files runs with no edit to a
file that is there, the challenge model's cells among them. Each committed
cell runs at a tiny size on the CPU, and its result line has the contract's
keys, from the same data as before data sources were found by file. A run
without the card it asks for, or in a directory that holds only the
benchmark, prints no result; nor does a run whose dataset has no data
source or whose mix names an unknown selection policy."""

import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.loops import common
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


# a data source of challenge-shaped data made from the seed: 35 subjects of
# 142 points in 4 channels (HR, TEMP, EDA, ACC) with Bernoulli shedding and
# symptoms, fold ``split`` of ``folds`` (val) and the rest (train), min-max
# normalized by the train fold, channels before time
CHALLENGE_DATA = """
import numpy as np


def splits(run, device):
    c, d = run.cfg["config"], run.cfg["data"]
    n, T, K = int(d["subjects"]), int(d["n_time"]), int(c["obs_dim"])
    rng = np.random.RandomState(run.seed_for("data") & 0xFFFFFFFF)
    t = np.arange(T, dtype=np.float32)
    obs = (np.sin(t[None, :, None] / rng.uniform(5.0, 30.0, (n, 1, K))) + 0.1 * rng.randn(n, T, K)).astype(np.float32)
    labels = {name: (rng.rand(n, 1) < 0.5).astype(np.float32) for name in ("shedding", "symptoms")}
    val = np.sort(np.array_split(rng.permutation(n), int(c["folds"]))[int(c["split"]) - 1])
    train = np.setdiff1d(np.arange(n), val)
    lo, hi = obs[train].min(axis=(0, 1)), obs[train].max(axis=(0, 1))

    def pack(ids):
        x = ((obs[ids] - lo) / (hi - lo)).transpose(0, 2, 1)
        return {"observations": np.ascontiguousarray(x), **{k: v[ids] for k, v in labels.items()}}

    return {"train": pack(train), "val": pack(val)}, t
"""

# the human viral challenge model (training_challenge.py, challenge_spec) at
# its published widths, with the README recipe's schedules: B = 8, aux
# multiplier 460 annealed to 46 over 1,500 epochs, lr 1e-3 decaying to 1e-4
# from epoch 2,000
CHALLENGE = {
    "name": "challenge", "dataset": "challenge",
    "config": {
        "obs_dim": 4, "shedding_dim": 1, "symptoms_dim": 1, "z_shedding_dim": 5, "z_symptoms_dim": 5,
        "z_epsilon_dim": 5, "u_hidden_dim": 25, "aux_loss_multiplier": 460.0, "aux_mult_final": 46.0,
        "aux_anneal_epochs": 1500, "learning_rate": 0.001, "lr_final": 0.0001, "lr_decay_start": 2000,
        "num_epochs": 100000, "mini_batch_size": 8, "folds": 5, "split": 5, "n_filters": 10, "filter_size": 10,
        "pool_size": 5, "cnn_hidden_dim": 50, "ode_state_dim": 5, "ode_hidden_dim": 25, "system_input_dim": 2,
        "num_particles": 1, "optimizer": "shared", "prior_lr_mult": 1.0, "data_parallel": 0, "time_parallel": 0,
        "adjoint_solver": False, "ode_backend": "semilinear", "ode_rtol": 1e-06, "ode_atol": 1e-08,
        "solver": "midpoint", "constant_std": 0.01, "quantile_diff": 0.475, "model": "Mechanistic"},
    "model": {
        "blocks": [["shedding", 5], ["symptoms", 5], ["epsilon", 5]],
        "labels": [["shedding", 1, "bernoulli", "shedding"], ["symptoms", 1, "bernoulli", "symptoms"]],
        "prior": "joint", "prior_input_order": ["symptoms", "shedding"], "aux_in_model": False,
        "likelihood": "quantile"},
    "data": {"subjects": 35, "n_time": 142},
}
CHALLENGE_CELLS = {"challenge_sweep": "proc_sweep", "challenge_train": "cvs_train"}  # cell -> limits copied


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the benchmark's data files with, added as new files (and as
    new entries of BENCHMARK.json): one configuration, one traffic mix, one
    per-layer metric, one limits file and one cell on CVS data; and the
    challenge model's data source, configuration, a sweep and a train mix,
    their limits and their two cells. Nothing that is there is edited."""
    bench = copy.deepcopy(harness.benchmark())
    subs = ("configs", "data", "traffic", "metrics", "limits")
    for sub in subs:
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub), tmp_path / "port_bench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    there = {p: p.read_bytes() for sub in subs for p in (tmp_path / "port_bench" / sub).iterdir()}
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

    (tmp_path / "port_bench" / "data" / "challenge.py").write_text(CHALLENGE_DATA)
    (tmp_path / "port_bench" / "configs" / "challenge.json").write_text(json.dumps(CHALLENGE))
    (tmp_path / "port_bench" / "traffic" / "sweep_challenge.json").write_text(json.dumps(
        {"loop": "sweep", "members": 8, "policy": "challenge", "chunk_epochs": 5, "perm_epochs": 1000,
         "followed_steps": 3, "trace_epochs": 3, "warm_block_s": 1.0, "warm_agree": 0.03, "warm_max_s": 6.0}))
    (tmp_path / "port_bench" / "traffic" / "train_challenge.json").write_text(json.dumps(
        {"loop": "train", "selection": "challenge", "eval_every": 1, "eval_train_stats": True, "followed_steps": 3,
         "trace_epochs": 3, "warm_block_s": 1.0, "warm_agree": 0.03, "warm_max_s": 6.0}))
    bench["configs"].append({"name": "challenge", "source": "https://github.com/paidamoyo/structured_latent_ODEs",
                             "file": "port_bench/configs/challenge.json", "reduced": ["num_epochs"], "why": "test"})
    for cell, limits in CHALLENGE_CELLS.items():
        shutil.copy(os.path.join(harness.BENCH_DIR, "limits", f"{limits}.json"),
                    tmp_path / "port_bench" / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": "challenge", "chips": 1, "why": "test",
                                   "traffic": "sweep_challenge" if cell.endswith("sweep") else "train_challenge"})
        bench["end_to_end"][0]["workloads"].append(cell)
        for m in bench["per_layer"]:
            if "cvs_train" in m["workloads"]:
                m["workloads"].append(cell)

    assert all(p.read_bytes() == b for p, b in there.items())
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


@pytest.mark.parametrize("cell", sorted(CHALLENGE_CELLS))
def test_the_challenge_model_is_added_as_files_alone(added, cell, capsys):
    from structured_latent_odes_tpu_torch.models import challenge_spec

    cfg = harness.configuration(added, "challenge")
    spec = challenge_spec(common.port_config(cfg), 142)
    assert cfg["model"]["blocks"] == [[b.name, b.dim] for b in spec.blocks]
    assert cfg["model"]["labels"] == [[lb.name, lb.dim, lb.kind, lb.block] for lb in spec.labels]
    assert (cfg["model"]["prior"], tuple(cfg["model"]["prior_input_order"]), cfg["model"]["aux_in_model"]) == (
        spec.prior, spec.prior_input_order, spec.aux_in_model)
    assert harness.execute(tiny_run(cell, bench=added), added) == 0
    line = result_line(capsys)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert harness.execute(tiny_run(cell, bench=added, trace=True), added) == 0
    line = result_line(capsys)
    names = {m["name"] for m in harness.metrics_for(added, cell, "per_layer")}
    assert line["correct"] is True and line["metrics"] and set(line["metrics"]) <= names


def test_a_dataset_without_a_data_source_fails_with_its_path():
    cfg = copy.deepcopy(harness.configuration(harness.benchmark(), "cvs"))
    cfg["dataset"] = "nowhere"
    run = harness.Run(cell="x", cfg=cfg, traffic={}, seed=1, seconds=1, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    path = os.path.join(harness.BENCH_DIR, "data", "nowhere.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        common.splits(run, torch.device("cpu"))


@pytest.mark.parametrize("cell, key", [("cvs_train", "selection"), ("proc_sweep", "policy")])
def test_an_unknown_selection_policy_fails_at_set_up(cell, key):
    run = tiny_run(cell)
    run.traffic[key] = "best_guess"
    with pytest.raises(ValueError, match="unknown .*'best_guess'"):
        harness.execute(run, harness.benchmark())
    assert run.phases == []  # before any phase of set-up


@pytest.mark.parametrize("policy, crits, picked", [
    ("cvs", [3.0, 3.0, 4.0], 1),  # ties improve
    ("proc", [3.0, 3.0, 2.0], 2),
    ("challenge", [5.0, 5.0, 4.5], 2),
])
def test_each_selection_is_the_drivers(policy, crits, picked):
    """cvs: the val posterior ELBO times the number of losses, ties improve;
    proc: the val posterior ELBO, strict; challenge: the mean of the epoch's
    train losses, strict."""
    from port_bench.loops.train import _selector

    class Stats:
        def __init__(self, c):
            self.elbo = [c / 2, c / 2]

    select, best = _selector(policy, []), {"criterion": np.inf}
    for epoch, c in enumerate(crits):
        val = {"post": Stats(c if policy != "challenge" else 100.0 - c)}
        best = select(epoch, val, None, best, None, [[c - 1.0, c + 1.0]] if policy == "challenge" else [[0.0]])
    assert best["epoch"] == picked


def _digest(splits, times) -> str:
    h = hashlib.sha256()
    for part in sorted(splits):
        for name in sorted(splits[part]):
            a = np.ascontiguousarray(splits[part][name])
            h.update(f"{part}/{name}/{a.dtype.str}/{a.shape}".encode())
            h.update(a.tobytes())
    t = np.ascontiguousarray(times)
    h.update(f"times/{t.dtype.str}/{t.shape}".encode())
    h.update(t.tobytes())
    return h.hexdigest()


# each split array's and the time grid's bytes, as the harness made them
# before the data sources were found by file (CVS simulated on the CPU)
PINNED = [
    ("cvs", 2 ** 31 + 11, "cd13b8e4905bd98ccc12180b48f21e16052cdc15326d4bfaaee77d57b09952cb"),
    ("cvs", 2 ** 40 + 3, "64c86d53bc6add5d8a9894efcabded74e9040f19d796cf33145bb7b5259adc63"),
    ("proc", 2 ** 31 + 11, "c89167b1cea6053dbda3b4c735847e15b33e6bc85c9a6546ebbb4505fcb6dc7a"),
    ("proc", 2 ** 40 + 3, "9a4c74ef6811a017a38504286a15d0f86409eab79934c09174c675b4c61f7ae2"),
]


@pytest.mark.parametrize("config, seed, digest", PINNED)
def test_the_committed_configurations_get_the_same_data(config, seed, digest):
    run = harness.Run(cell="x", cfg=harness.configuration(harness.benchmark(), config), traffic={}, seed=seed,
                      seconds=1, trace=False, t0=0.0, device=torch.device("cpu"))
    assert _digest(*common.splits(run, torch.device("cpu"))) == digest


@pytest.mark.parametrize("config, constant", [("cvs", True), ("proc", True), ("challenge", False)])
def test_the_sweep_takes_its_schedules_from_the_configuration(config, constant):
    """Where a configuration sets no schedule keys, every epoch's aux
    multiplier is ``aux_loss_multiplier`` and there is no lr schedule, as
    before the schedules were taken from the configuration; the challenge
    recipe's anneal and lr decay reach the members."""
    from port_bench.loops.sweep import members_of

    cfg = CHALLENGE if config == "challenge" else harness.configuration(harness.benchmark(), config)
    run = harness.Run(cell="x", cfg=cfg, traffic={"members": 2, "perm_epochs": 4, "followed_steps": 1,
                                                  "policy": "challenge"},
                      seed=3, seconds=1, trace=False, t0=0.0, device=torch.device("cpu"))
    config_ = common.port_config(cfg)
    n_time = 142 if config == "challenge" else 100
    splits = {"train": {"observations": np.zeros((300, 1, n_time), np.float32)}}
    _, members, _ = members_of(run, config_, None, splits, np.arange(n_time, dtype=np.float32),
                               torch.device("cpu"))
    for m in members:
        assert m["aux_mult"].dtype == np.float32 and m["aux_mult"].shape == (4,)
        if constant:
            assert np.array_equal(m["aux_mult"], np.full(4, float(config_.aux_loss_multiplier), np.float32))
            assert m["lr_sched"] is None
        else:
            assert m["aux_mult"][0] == 460.0 and np.all(np.diff(m["aux_mult"]) < 0)
            assert np.array_equal(m["lr_sched"], np.ones(4, np.float32))

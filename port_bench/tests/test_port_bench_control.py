"""On the card: each one-card cell's control, the reference put in the
program's place in TF32, fails one of the cell's numbers at the cell's own
size, while the program's own run passes them. (Marked ``gpu``: it skips
without a card.) The readings the limits were set from are
``port_bench/tools/readings.py``'s, on twelve seeds."""

import time

import pytest
import torch

from port_bench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"] if w["chips"] == 1])
def test_the_control_fails_and_the_program_passes(cell, card):
    import importlib

    bench = harness.benchmark()
    w = harness.workload(bench, cell)
    run = harness.Run(cell=cell, cfg=harness.configuration(bench, w["config"]), traffic=harness.traffic(w["traffic"]),
                      seed=2 ** 31 + 1234, seconds=0.2, trace=False, t0=time.perf_counter(), device=card,
                      limits=harness.limits(cell), readings={})
    importlib.import_module(f"port_bench.loops.{run.traffic['loop']}").run(run)
    assert harness.judged(run)[0], run.checks
    control = run.readings["control"]
    assert any(control[k] > run.limits[k] for k in run.limits), (control, run.limits)

"""A cell of the benchmark at a size that a CPU test holds: the committed
configuration, mix and limits with fewer trajectories, smaller batches and
fewer members; the widths stay."""

from __future__ import annotations

import copy
import time

import torch

from port_bench import harness


def tiny_run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3, trace: bool = False, bench=None,
             readings=None) -> harness.Run:
    bench = bench or harness.benchmark()
    w = harness.workload(bench, cell)
    cfg = copy.deepcopy(harness.configuration(bench, w["config"]))
    mix = copy.deepcopy(harness.traffic(w["traffic"]))
    if cfg["data"].get("generator") == "cvs":
        cfg["data"].update(n_train=56, n_val=8, n_test=8)
        cfg["config"]["mini_batch_size"] = 16
    if mix["loop"] == "sweep":
        mix.update(members=2, perm_epochs=4, chunk_epochs=1, trace_epochs=1)
    if mix["loop"] == "train":
        mix.update(trace_epochs=1)
    mix.update(warm_block_s=0.05, warm_max_s=0.2)
    torch.set_num_threads(1)
    return harness.Run(cell=cell, cfg=cfg, traffic=mix, seed=seed, seconds=seconds, trace=trace,
                       t0=time.perf_counter(), device=torch.device("cpu"), chips=int(w["chips"]),
                       limits=harness.limits(cell), readings=readings)


def result_line(capsys) -> dict:
    import json

    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
